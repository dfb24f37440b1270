"""Batched read alignment: per-read results must be bit-identical to
the single-pair aligner, and CIGARs must round-trip the path."""

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.aligner import PairwiseAligner
from genomics_rs_tpu.models.reads import align_reads, cigar
from genomics_rs_tpu.sequence import Sequence

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


@pytest.mark.parametrize("is_local", [False, True])
def test_align_reads_matches_single_pair(is_local):
    rng = np.random.default_rng(71)
    queries, refs = [], []
    for k in range(7):
        n = int(rng.integers(20, 120))
        q = "".join(rng.choice(list("ACGT"), n))
        # Mutated/shifted copy so alignments are non-trivial.
        r = list(q)
        for _ in range(max(1, n // 15)):
            r[int(rng.integers(0, n))] = rng.choice(list("ACGT"))
        r = "".join(r)[int(rng.integers(0, 3)) :]
        queries.append(Sequence(f"q{k}", q))
        refs.append(Sequence(f"r{k}", r))

    batch = align_reads(queries, refs, SCORES, is_local=is_local, batch=3)
    single = PairwiseAligner(SCORES, is_local=is_local, engine="scan")
    for k in range(7):
        want = single.align(queries[k], refs[k])
        got = batch[k]
        assert got.score == want.score, k
        assert got.alignment == want.alignment, k
        assert (got.matches, got.mismatches, got.gap_extensions,
                got.opening_gaps) == (
            want.matches,
            want.mismatches,
            want.gap_extensions,
            want.opening_gaps,
        ), k


def test_cigar_roundtrip():
    q = Sequence("q", "ACGTACGT")
    r = Sequence("r", "ACGGACGT")
    a = align_reads([q], [r], SCORES, is_local=False)[0]
    c = cigar(a)
    assert c == "8M"
    # Consumed lengths reconstruct the sequence lengths.
    import re

    runs = [(int(n), op) for n, op in re.findall(r"(\d+)([MID])", c)]
    q_len = sum(n for n, op in runs if op in ("M", "I"))
    r_len = sum(n for n, op in runs if op in ("M", "D"))
    assert q_len == len(q) and r_len == len(r)


def test_cigar_gap():
    q = Sequence("q", "ACGTTTACGT")
    r = Sequence("r", "ACGTACGT")
    a = align_reads([q], [r], SCORES, is_local=False)[0]
    c = cigar(a)
    import re

    runs = [(int(n), op) for n, op in re.findall(r"(\d+)([MID])", c)]
    q_len = sum(n for n, op in runs if op in ("M", "I"))
    r_len = sum(n for n, op in runs if op in ("M", "D"))
    assert q_len == len(q) and r_len == len(r)
    assert any(op == "I" for _, op in runs)  # the 2-base query insertion


@pytest.mark.parametrize("is_local", [False, True])
def test_align_reads_related_pairs_match_aligner(is_local):
    # Related read/ref pairs (substitutions + a clipped ref start):
    # the batched fill + lockstep walk must reproduce the per-pair
    # aligner (host walker) bit-for-bit.
    rng = np.random.default_rng(5)
    queries, refs = [], []
    for k in range(6):
        n = int(rng.integers(30, 120))
        q = "".join(rng.choice(list("ACGT"), n))
        r = list(q)
        for _ in range(max(1, n // 10)):
            r[int(rng.integers(0, n))] = rng.choice(list("ACGT"))
        queries.append(Sequence(f"q{k}", q))
        refs.append(Sequence(f"r{k}", "".join(r)[int(rng.integers(0, 3)):]))
    aligner = PairwiseAligner(SCORES, is_local=is_local)
    ref = [aligner.align(q, r) for q, r in zip(queries, refs)]
    got = align_reads(queries, refs, SCORES, is_local=is_local)
    for a, c in zip(got, ref):
        assert a.score == c.score
        assert a.alignment == c.alignment
        assert (a.matches, a.mismatches, a.gap_extensions,
                a.opening_gaps) == (c.matches, c.mismatches,
                                    c.gap_extensions, c.opening_gaps)
        assert cigar(a) == cigar(c)


def test_align_reads_with_cigars_no_paths():
    """with_cigars returns the batch-vectorized CIGARs; with_paths=False
    keeps them exact while skipping the per-move alignment lists."""
    rng = np.random.default_rng(7)
    qs, rs = [], []
    for k in range(5):
        n = int(rng.integers(20, 80))
        qs.append(Sequence(f"q{k}", "".join(rng.choice(list("ACGT"), n))))
        rs.append(Sequence(f"r{k}", "".join(rng.choice(list("ACGT"), n + 5))))
    full = align_reads(qs, rs, SCORES, is_local=False, engine="scan")
    lean, cigs = align_reads(
        qs, rs, SCORES, is_local=False, engine="scan",
        with_paths=False, with_cigars=True,
    )
    for a, b, cg in zip(full, lean, cigs):
        assert b.alignment == []
        assert cg == cigar(a)
        assert (a.score, a.matches, a.mismatches) == (
            b.score, b.matches, b.mismatches,
        )


def test_align_reads_rejects_mid_table_stop_in_global(monkeypatch):
    """A stop code mid-path in a global retrace is a corrupt fill; the
    batched walker must surface it like the host walker's 'Unexpected
    stop code during global retrace' instead of truncating silently."""
    import genomics_rs_tpu.models.reads as reads_mod
    from genomics_rs_tpu.ops.gotoh_scan import DIR_STOP

    def corrupt_fill(s1b, s2b, ms, ns, scores, is_local):
        B, L1 = s1b.shape
        L2 = s2b.shape[1]
        dirs = np.full((B, L1 + L2 + 1, L1 + 1), DIR_STOP, np.uint8)
        return dirs, np.zeros(B, np.int32), ms, ns

    monkeypatch.setattr(reads_mod, "_fill_batch", corrupt_fill)
    qs = [Sequence("q", "ACGTACGT")]
    rs = [Sequence("r", "ACGTACGT")]
    with pytest.raises(RuntimeError, match="did not terminate"):
        align_reads(qs, rs, SCORES, is_local=False, engine="scan")


def test_reverse_complement():
    s = Sequence("s", "ACGTN", quality="!!IIA")
    rc = s.reverse_complement()
    assert rc.sequence == "NACGT"
    assert rc.quality == "AII!!"
    # Involution on IUPAC bases.
    assert rc.reverse_complement().sequence == s.sequence


@pytest.mark.parametrize("is_local", [True, False])
def test_align_reads_both_strands(is_local):
    rng = np.random.default_rng(99)
    queries, refs = [], []
    flipped = []
    for k in range(6):
        n = int(rng.integers(30, 100))
        r = "".join(rng.choice(list("ACGT"), n))
        q = Sequence(f"q{k}", r[5 : n - 3])
        # Half the reads come from the minus strand.
        flip = k % 2 == 1
        if flip:
            q = q.reverse_complement()
        flipped.append(flip)
        queries.append(q)
        refs.append(Sequence(f"r{k}", r))

    aligned, cigars, strands = align_reads(
        queries,
        refs,
        SCORES,
        is_local=is_local,
        with_cigars=True,
        both_strands=True,
        batch=4,
    )
    single = PairwiseAligner(SCORES, is_local=is_local, engine="scan")
    for k in range(6):
        # The chosen orientation must match how the read was planted
        # (a 25+ bp exact substring always out-scores its revcomp).
        assert strands[k] == ("-" if flipped[k] else "+"), k
        q_eff = (
            queries[k].reverse_complement() if flipped[k] else queries[k]
        )
        want = single.align(q_eff, refs[k])
        assert aligned[k].score == want.score, k
        assert aligned[k].matches == want.matches, k
    # Tie case: palindromic query scores equal both ways; forward wins.
    pal = Sequence("pal", "ACGT" * 5)
    assert pal.reverse_complement().sequence == pal.sequence
    _, st = align_reads(
        [pal], [Sequence("r", "ACGT" * 5)], SCORES,
        is_local=is_local, both_strands=True,
    )
    assert st == ["+"]


def test_align_reads_single_ref_broadcast():
    ref = Sequence("chr", "ACGTACGTTTGGCCAA")
    queries = [
        Sequence("a", "ACGTACGT"),
        Sequence("b", "TTGGCCAA"),
        Sequence("c", "ACGTTTGG"),
    ]
    out = align_reads(queries, [ref], SCORES, is_local=True)
    assert len(out) == 3
    single = PairwiseAligner(SCORES, is_local=True, engine="scan")
    for k, q in enumerate(queries):
        assert out[k].score == single.align(q, ref).score


def test_align_reads_mapinfo_and_sam(tmp_path):
    from genomics_rs_tpu.models.reads import write_sam

    # ref[4:12] = ACCTGAGT is non-palindromic, so only one strand hits.
    ref = Sequence("chr1 extra", "GGGGACCTGAGTTTTT")
    queries = [
        Sequence("hit", "ACCTGAGT", quality="IIIIIIII"),
        # revcomp of ref[4:12] -> maps on the minus strand
        Sequence("rc_hit", Sequence("", "ACCTGAGT").reverse_complement().sequence),
        Sequence("miss", "NNNNNNNN"),  # local empty alignment -> unmapped
    ]
    aligned, cigars, strands, mapinfo = align_reads(
        queries,
        [ref],
        SCORES,
        is_local=True,
        with_cigars=True,
        both_strands=True,
        with_mapinfo=True,
    )
    # Forward hit: aligned block = query rows (0, 8], ref cols (4, 12].
    assert strands[0] == "+"
    assert mapinfo[0] == (0, 4, 8, 12)
    assert cigars[0] == "8M"
    assert strands[1] == "-"
    assert mapinfo[1] == (0, 4, 8, 12)
    # All-N read never matches: the reference-faithful local walk
    # still crosses the zero plateau as a pure-D run (algo.rs:351-405
    # takes a move at max==0 when an arm matches); write_sam folds the
    # edge D run away, leaving no M -> unmapped.
    assert set(cigars[2]) <= set("0123456789D")

    sam = tmp_path / "out.sam"
    write_sam(str(sam), [ref] * 3, aligned, cigars, mapinfo, strands)
    lines = sam.read_text().splitlines()
    assert lines[0].startswith("@HD")
    assert "@SQ\tSN:chr1\tLN:16" in lines[1]
    recs = [l.split("\t") for l in lines if not l.startswith("@")]
    # fwd: FLAG 0, POS 5 (1-based), plain 8M, SEQ + QUAL carried.
    assert recs[0][:6] == ["hit", "0", "chr1", "5", "255", "8M"]
    assert recs[0][9] == "ACCTGAGT" and recs[0][10] == "IIIIIIII"
    assert recs[0][11] == "AS:i:8"
    # rc: FLAG 16, SEQ is the revcomped (ref-forward) read.
    assert recs[1][:6] == ["rc_hit", "16", "chr1", "5", "255", "8M"]
    assert recs[1][9] == "ACCTGAGT"
    # miss: unmapped.
    assert recs[2][1] == "4" and recs[2][2] == "*" and recs[2][5] == "*"


def test_sam_soft_clips(tmp_path):
    from genomics_rs_tpu.models.reads import write_sam

    ref = Sequence("r", "TTTTACGTACGTTTTT")
    # 3 junk bases, an 8-base hit, 2 junk bases -> 3S8M2S.
    q = Sequence("q", "CCC" + "ACGTACGT" + "GG")
    aligned, cigars, mapinfo = align_reads(
        [q], [ref], SCORES, is_local=True,
        with_cigars=True, with_mapinfo=True,
    )
    i0, j0, ei, ej = mapinfo[0]
    # The reference-faithful walk continues over the zero plateau
    # before the match block as a leading D run (algo.rs:351-405), so
    # the raw CIGAR is 4D8M from (3, 0); write_sam folds the edge D
    # into POS: ref col 0 + 4 folded D -> POS 5 (1-based).
    assert (i0, j0, ei) == (3, 0, 11) and cigars[0] == "4D8M"
    sam = tmp_path / "o.sam"
    write_sam(str(sam), [ref], aligned, cigars, mapinfo)
    rec = [l for l in sam.read_text().splitlines() if not l.startswith("@")][0].split("\t")
    assert rec[5] == "3S8M2S"
    assert rec[3] == "5"


def test_write_sam_nameless_and_rname_conflict(tmp_path):
    from genomics_rs_tpu.models.reads import write_sam

    ref = Sequence("", "ACGTACGT")  # bare ">" header -> empty name
    q = Sequence("", "ACGTACGT")
    aligned, cigars, mapinfo = align_reads(
        [q], [ref], SCORES, is_local=False,
        with_cigars=True, with_mapinfo=True,
    )
    sam = tmp_path / "o.sam"
    write_sam(str(sam), [ref], aligned, cigars, mapinfo)
    rec = [l for l in sam.read_text().splitlines()
           if not l.startswith("@")][0].split("\t")
    assert rec[0] == "*" and rec[2] == "*"  # placeholder names, no crash

    # Same RNAME first-token, different lengths -> hard error.
    refs2 = [Sequence("chr1 v1", "ACGT"), Sequence("chr1 v2", "ACGTACGT")]
    with pytest.raises(ValueError, match="RNAME"):
        write_sam(str(sam), refs2, aligned * 2, cigars * 2, mapinfo * 2)


def test_encode_batch_memoizes_broadcast():
    import numpy as np
    from genomics_rs_tpu.models.reads import encode_batch

    calls = []
    ref = Sequence("r", "ACGTACGT")
    orig = Sequence.encoded

    class Probe(Sequence):
        def encoded(self, **kw):
            calls.append(1)
            return orig(self, **kw)

    p = Probe("r", "ACGTACGT")
    b = encode_batch([p] * 1000, 128, 4)
    assert sum(calls) == 1  # one encode for 1000 broadcast rows
    assert b.shape == (1000, 128)
    assert np.array_equal(b[0], ref.encoded(pad_to=128, pad_value=4))
    assert np.array_equal(b[0], b[999])
    # Distinct objects still get distinct rows.
    b2 = encode_batch(
        [Sequence("a", "AAAA"), Sequence("c", "CCCC")], 128, 4
    )
    assert not np.array_equal(b2[0], b2[1])


def _validate_sam(text: str) -> int:
    """Minimal structural SAM 1.6 check: mandatory header, CIGAR
    query-consumption == SEQ length, POS + ref-consumption <= @SQ LN.
    Returns the number of mapped records."""
    import re

    lines = text.splitlines()
    assert lines and lines[0].startswith("@HD\tVN:")
    ln_by_rname = {}
    for l in lines:
        if l.startswith("@SQ"):
            fields = dict(f.split(":", 1) for f in l.split("\t")[1:])
            ln_by_rname[fields["SN"]] = int(fields["LN"])
    mapped = 0
    for l in lines:
        if l.startswith("@"):
            continue
        f = l.split("\t")
        assert len(f) >= 11, l
        flag, rname, pos, cig, seq = (
            int(f[1]), f[2], int(f[3]), f[5], f[9],
        )
        if flag & 4:
            assert (rname, pos, cig) == ("*", 0, "*"), l
            continue
        mapped += 1
        runs = re.findall(r"(\d+)([MIDNSHP=X])", cig)
        assert "".join(n + op for n, op in runs) == cig, l
        ops = [op for _, op in runs]
        # No clip-adjacent deletions, M present.
        core = [op for op in ops if op not in "SH"]
        assert core and core[0] != "D" and core[-1] != "D", l
        q_consumed = sum(int(n) for n, op in runs if op in "MIS=X")
        r_consumed = sum(int(n) for n, op in runs if op in "MDN=X")
        assert q_consumed == len(seq), l
        assert rname in ln_by_rname, l
        assert 1 <= pos and pos - 1 + r_consumed <= ln_by_rname[rname], l
    return mapped


@pytest.mark.parametrize("is_local", [True, False])
def test_write_sam_structurally_valid_random(tmp_path, is_local):
    """Property check: whatever the reference-faithful walks produce
    (zero-plateau edge runs included), the SAM writer must emit
    structurally valid records."""
    from genomics_rs_tpu.models.reads import write_sam

    rng = np.random.default_rng(1234)
    ref_seq = "".join(rng.choice(list("ACGT"), 400))
    ref = Sequence("ref1", ref_seq)
    queries = []
    for k in range(24):
        n = int(rng.integers(20, 90))
        kind = k % 4
        if kind == 0:  # planted forward fragment + junk tails
            p = int(rng.integers(0, 300))
            frag = ref_seq[p : p + n]
            q = "CC" + frag + "GG"
        elif kind == 1:  # planted minus-strand fragment
            p = int(rng.integers(0, 300))
            q = Sequence("", ref_seq[p : p + n]).reverse_complement().sequence
        elif kind == 2:  # random read
            q = "".join(rng.choice(list("ACGT"), n))
        else:  # unalignable in local mode
            q = "N" * n
        queries.append(Sequence(f"q{k}", q, quality="I" * len(q)))
    aligned, cigars, strands, mapinfo = align_reads(
        queries, [ref], SCORES, is_local=is_local, engine="scan",
        with_cigars=True, both_strands=True, with_mapinfo=True,
    )
    sam = tmp_path / "r.sam"
    write_sam(
        str(sam), [ref] * len(queries), aligned, cigars, mapinfo, strands
    )
    mapped = _validate_sam(sam.read_text())
    # Every planted read (half the corpus) must map.
    assert mapped >= 12


def test_align_reads_device_loop_parity():
    """Rounds big enough to split across the virtual device mesh must
    produce exactly the single-device results (slices are merged in
    order; padding rows are discarded)."""
    import jax

    if len(jax.local_devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    rng = np.random.default_rng(61)
    queries, refs = [], []
    for k in range(21):  # odd count -> exercises slice padding
        n = int(rng.integers(20, 100))
        q = "".join(rng.choice(list("ACGT"), n))
        r = list(q)
        for _ in range(3):
            r[int(rng.integers(0, n))] = rng.choice(list("ACGT"))
        queries.append(Sequence(f"q{k}", q))
        refs.append(Sequence(f"r{k}", "".join(r)))
    # One round of 21 rows -> splits 8 ways; singles go one by one.
    batch_res, batch_cigs = align_reads(
        queries, refs, SCORES, is_local=True, engine="scan",
        with_cigars=True,
    )
    single = PairwiseAligner(SCORES, is_local=True, engine="scan")
    for k in range(21):
        want = single.align(queries[k], refs[k])
        assert batch_res[k].score == want.score, k
        assert batch_res[k].alignment == want.alignment, k
