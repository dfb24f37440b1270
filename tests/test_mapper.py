"""Seed-and-extend mapper: index correctness, planted-read recovery,
strand calls, extension-score parity with full DP, SAM round-trip."""

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.mapper import KmerIndex, map_reads
from genomics_rs_tpu.models.reads import align_reads, write_sam
from genomics_rs_tpu.sequence import Sequence

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


def _random_ref(rng, n, name="ref"):
    return Sequence(name, "".join(rng.choice(list("ACGT"), n)))


def test_kmer_index_positions():
    ref = Sequence("r", "ACGTACGTNACGT")
    ix = KmerIndex(ref, k=4)

    def key(s):
        v = 0
        for c in s:
            v = v * 4 + "ACGT".index(c)
        return v

    # ACGT occurs at 0, 4 and 9.
    assert list(ix.lookup(key("ACGT"))) == [0, 4, 9]
    # CGTA at 1 only: the window at 5 is CGTN (crosses the N).
    assert list(ix.lookup(key("CGTA"))) == [1]
    # GTAC at 2 only: the window at 6 is GTNA.
    assert list(ix.lookup(key("GTAC"))) == [2]


def test_kmer_index_rejects_bad_k():
    with pytest.raises(ValueError):
        KmerIndex(Sequence("r", "ACGT"), k=3)
    with pytest.raises(ValueError):
        KmerIndex(Sequence("r", "ACGT"), k=32)


def test_map_reads_planted():
    rng = np.random.default_rng(42)
    ref = _random_ref(rng, 5000)
    reads, truth = [], []
    for t in range(20):
        p = int(rng.integers(0, 4800))
        n = int(rng.integers(60, 120))
        frag = ref.sequence[p : p + n]
        if t % 2:
            q = Sequence(f"q{t}", Sequence("", frag).reverse_complement().sequence)
            truth.append((p, n, "-"))
        else:
            q = Sequence(f"q{t}", frag)
            truth.append((p, n, "+"))
        reads.append(q)
    res = map_reads(reads, ref, SCORES, k=15, engine="scan")
    for r, (p, n, strand) in zip(res, truth):
        assert r.mapped, r.read.name
        assert r.strand == strand, r.read.name
        assert r.score == n, r.read.name  # exact fragment: all matches
        i0, j0, ei, ej = r.mapinfo
        # Absolute ref span of the aligned block == planted location
        # (the walk may extend over a zero plateau; the M block itself
        # must cover [p, p+n) — check via the fold used by write_sam).
        assert j0 <= p and ej >= p + n - 1, (r.mapinfo, p, n)
        assert r.cigar.count("M") >= 1


def test_map_reads_junk_unmapped():
    rng = np.random.default_rng(7)
    ref = _random_ref(rng, 3000)
    junk = [
        Sequence("junk1", "".join(rng.choice(list("ACGT"), 80))),
        Sequence("junkN", "N" * 80),
        Sequence("short", "ACG"),  # shorter than k
    ]
    res = map_reads(junk, ref, SCORES, k=21, engine="scan")
    for r in res:
        assert not r.mapped
        assert r.cigar == "" and r.seeds < 2
        assert r.mapinfo == (0, 0, 0, 0)


def test_map_reads_extension_matches_full_dp():
    """The windowed extension must reproduce the full-reference local
    DP score when the alignment fits in the window (mutated reads)."""
    rng = np.random.default_rng(3)
    ref = _random_ref(rng, 2000)
    reads = []
    for t in range(8):
        p = int(rng.integers(0, 1850))
        frag = list(ref.sequence[p : p + 100])
        for _ in range(6):  # ~6% mismatches
            frag[int(rng.integers(0, 100))] = rng.choice(list("ACGT"))
        reads.append(Sequence(f"q{t}", "".join(frag)))
    res = map_reads(reads, ref, SCORES, k=15, engine="scan")
    full = align_reads(
        reads, [ref], SCORES, is_local=True, engine="scan",
        with_paths=False, with_cigars=True,
    )[0]
    for r, f in zip(res, full):
        assert r.mapped
        assert r.score == f.score, r.read.name


def test_map_reads_sam_roundtrip(tmp_path):
    from tests.test_reads import _validate_sam

    rng = np.random.default_rng(11)
    ref = _random_ref(rng, 4000, name="chrM test")
    reads = []
    for t in range(12):
        p = int(rng.integers(0, 3800))
        frag = ref.sequence[p : p + 90]
        q = frag if t % 2 else Sequence("", frag).reverse_complement().sequence
        reads.append(
            Sequence(f"q{t}", "AC" + q + "TT", quality="I" * (len(q) + 4))
        )
    reads.append(Sequence("junk", "N" * 90))
    res = map_reads(reads, ref, SCORES, k=15, engine="scan")
    sam = tmp_path / "m.sam"
    write_sam(
        str(sam),
        [ref] * len(res),
        [r.aligned for r in res],
        [r.cigar for r in res],
        [r.mapinfo for r in res],
        [r.strand for r in res],
    )
    text = sam.read_text()
    assert "@SQ\tSN:chrM\tLN:4000" in text
    assert _validate_sam(text) == 12  # all planted reads mapped
    # Soft clips from the junk tails survive into the records.
    recs = [l.split("\t") for l in text.splitlines() if not l.startswith("@")]
    assert any("S" in r[5] for r in recs if r[5] != "*")


def test_map_reads_prebuilt_index_and_mismatched_ref():
    rng = np.random.default_rng(5)
    ref = _random_ref(rng, 1000)
    ix = KmerIndex(ref, k=13)
    q = Sequence("q", ref.sequence[100:180])
    res = map_reads([q], ref, SCORES, index=ix, engine="scan")
    assert res[0].mapped and res[0].score == 80
    with pytest.raises(ValueError, match="different reference"):
        map_reads([q], _random_ref(rng, 1000), SCORES, index=ix)


def test_map_reads_repetitive_seeds_capped():
    # A read whose every k-mer exceeds max_hits has no usable seed.
    ref = Sequence("r", "A" * 2000)
    q = Sequence("q", "A" * 100)
    res = map_reads([q], ref, SCORES, k=11, max_hits=16, engine="scan")
    assert not res[0].mapped and res[0].seeds == 0


def test_map_reads_multi_contig(tmp_path):
    from tests.test_reads import _validate_sam
    from genomics_rs_tpu.models.reads import write_sam

    rng = np.random.default_rng(21)
    contigs = [
        _random_ref(rng, 1500, name="ctgA"),
        _random_ref(rng, 2500, name="ctgB"),
        _random_ref(rng, 800, name="ctgC"),  # no reads map here
    ]
    reads = [
        Sequence("a1", contigs[0].sequence[200:290]),
        Sequence(
            "b1",
            Sequence("", contigs[1].sequence[1000:1090])
            .reverse_complement()
            .sequence,
        ),
        Sequence("b2", contigs[1].sequence[2300:2390]),
    ]
    res = map_reads(reads, contigs, SCORES, k=15, engine="scan")
    assert [r.contig.name for r in res] == ["ctgA", "ctgB", "ctgB"]
    assert [r.strand for r in res] == ["+", "-", "+"]
    assert res[0].mapinfo[1] <= 200 and res[0].mapinfo[3] >= 289
    # Contig-relative coordinates: b1's block sits around 1000..1090
    # of ctgB, not of the concatenated space.
    assert res[1].mapinfo[1] <= 1000 and res[1].mapinfo[3] >= 1089
    assert all(r.score == 90 for r in res)

    sam = tmp_path / "mc.sam"
    write_sam(
        str(sam),
        [r.contig for r in res],
        [r.aligned for r in res],
        [r.cigar for r in res],
        [r.mapinfo for r in res],
        [r.strand for r in res],
        header_refs=contigs,
    )
    text = sam.read_text()
    # Every contig declared, even the unreferenced one.
    for c in contigs:
        assert f"@SQ\tSN:{c.name}\tLN:{len(c)}" in text
    assert _validate_sam(text) == 3
    recs = [l.split("\t") for l in text.splitlines() if not l.startswith("@")]
    assert recs[0][2] == "ctgA" and recs[1][2] == "ctgB"
    # POS is contig-relative (1-based, after edge folding).
    assert int(recs[1][3]) <= 1001 + 0  # leading plateau may fold in


def test_vote_windows_parallel_matches_single(monkeypatch):
    """The thread-parallel chunked seeding path must be bit-identical
    to the single-pass path (chunks are per-read independent)."""
    import genomics_rs_tpu.models.mapper as M
    from genomics_rs_tpu.models.mapper import _BASE, _vote_windows

    rng = np.random.default_rng(31)
    ref = _random_ref(rng, 4000)
    ix = KmerIndex(ref, k=13)
    reads = []
    for _ in range(64):
        p = int(rng.integers(0, 3900))
        reads.append(ref.sequence[p : p + 80])
    enc4 = _BASE[
        np.stack([np.frombuffer(r.encode(), np.uint8) for r in reads])
    ]
    single = _vote_windows(ix, enc4, 6, 64, 32)
    monkeypatch.setattr(M, "_PAR_CHUNK", 16)  # 64 rows -> 4 chunks
    par = _vote_windows(ix, enc4, 6, 64, 32)
    for a, b in zip(par, single):
        assert np.array_equal(a, b)


def test_map_pairs_sam(tmp_path):
    from genomics_rs_tpu.models.mapper import map_pairs, write_sam_paired

    rng = np.random.default_rng(77)
    ref = _random_ref(rng, 3000, name="chrP")
    # Template 0: classic FR pair, outer distance 300.
    p = 700
    r1a = Sequence("t0", ref.sequence[p : p + 100], quality="I" * 100)
    r2a = Sequence(
        "t0",
        Sequence("", ref.sequence[p + 200 : p + 300])
        .reverse_complement()
        .sequence,
        quality="I" * 100,
    )
    # Template 1: mate unmapped.
    r1b = Sequence("t1", ref.sequence[1500:1600])
    r2b = Sequence("t1", "N" * 100)
    # Template 2: discordant (both forward, far apart).
    r1c = Sequence("t2", ref.sequence[100:200])
    r2c = Sequence("t2", ref.sequence[2500:2600])
    res1, res2 = map_pairs(
        [r1a, r1b, r1c], [r2a, r2b, r2c], ref, SCORES,
        k=15, engine="scan",
    )
    sam = tmp_path / "p.sam"
    proper = write_sam_paired(
        str(sam), res1, res2, header_refs=[ref], max_insert=1000
    )
    assert proper == 1
    recs = [
        l.split("\t") for l in sam.read_text().splitlines()
        if not l.startswith("@")
    ]
    assert len(recs) == 6  # interleaved R1, R2 per template
    f0a, f0b = int(recs[0][1]), int(recs[1][1])
    # Classic proper-pair flags: 99 (paired+proper+mate-rev+first),
    # 147 (paired+proper+rev+second).
    assert (f0a, f0b) == (99, 147)
    # RNEXT '=', PNEXT = mate POS, TLEN +300/-300.
    assert recs[0][6] == "=" and recs[1][6] == "="
    assert recs[0][7] == recs[1][3] and recs[1][7] == recs[0][3]
    assert int(recs[0][3]) == p + 1
    assert (int(recs[0][8]), int(recs[1][8])) == (300, -300)
    # Template 1: R1 mapped + mate-unmapped bit; R2 unmapped, RNEXT
    # points at the mapped mate.
    f1a, f1b = int(recs[2][1]), int(recs[3][1])
    assert f1a == 0x1 | 0x40 | 0x8
    assert f1b & 0x4 and f1b & 0x80 and not f1b & 0x2
    assert recs[3][6] == "chrP" and recs[3][7] == recs[2][3]
    # Template 2: both mapped, same strand -> paired but not proper,
    # TLEN still signed outer distance.
    f2a, f2b = int(recs[4][1]), int(recs[5][1])
    assert not f2a & 0x2 and not f2b & 0x2
    assert int(recs[4][8]) > 0 and int(recs[5][8]) < 0

    from tests.test_reads import _validate_sam
    assert _validate_sam(sam.read_text()) == 5


def test_device_seeding_matches_host():
    """The jitted fixed-shape device voting must be bit-identical to
    the host engine across planted/junk/N/repetitive reads."""
    from genomics_rs_tpu.models.mapper import _BASE, _vote_windows
    from genomics_rs_tpu.models.mapper import _vote_windows_device

    rng = np.random.default_rng(17)
    contigs = [_random_ref(rng, 2000, "c1"), _random_ref(rng, 1000, "c2")]
    ix = KmerIndex(contigs, k=13)
    reads = []
    for t in range(40):
        n = int(rng.integers(40, 120))
        kind = t % 4
        if kind == 0:
            c = contigs[t % 2]
            p = int(rng.integers(0, len(c) - n))
            reads.append(c.sequence[p : p + n])
        elif kind == 1:
            reads.append("".join(rng.choice(list("ACGT"), n)))
        elif kind == 2:
            s = list(contigs[0].sequence[100 : 100 + n])
            s[n // 2] = "N"
            reads.append("".join(s))
        else:
            reads.append("A" * n)  # repetitive-ish
    L = max(len(r) for r in reads)
    enc4 = _BASE[
        np.stack(
            [
                np.frombuffer((r + "\xfe" * (L - len(r))).encode("latin1"), np.uint8)
                for r in reads
            ]
        )
    ]
    for stride, H, band in [(6, 64, 32), (1, 8, 16)]:
        host = _vote_windows(ix, enc4, stride, H, band)
        dev = _vote_windows_device(ix, enc4, stride, H, band, chunk=16)
        for a, b in zip(dev, host):
            assert np.array_equal(a, b), (stride, H, band)


def test_device_seeding_end_to_end():
    rng = np.random.default_rng(23)
    ref = _random_ref(rng, 3000)
    reads = [
        Sequence("f", ref.sequence[500:590]),
        Sequence(
            "r",
            Sequence("", ref.sequence[1200:1290])
            .reverse_complement()
            .sequence,
        ),
        Sequence("junk", "N" * 90),
    ]
    host = map_reads(reads, ref, SCORES, k=15, engine="scan")
    dev = map_reads(
        reads, ref, SCORES, k=15, engine="scan", seed_engine="device"
    )
    for a, b in zip(dev, host):
        assert (a.mapped, a.strand, a.score, a.mapinfo, a.cigar) == (
            b.mapped, b.strand, b.score, b.mapinfo, b.cigar,
        )


def test_device_seeding_rejects_large_k():
    ref = Sequence("r", "ACGT" * 100)
    ix = KmerIndex(ref, k=21)
    with pytest.raises(ValueError, match="k <= 15"):
        ix.device_arrays()


def test_map_reads_contig_boundary_anchor():
    """A read at the very tail/head of a contig must be assigned to
    THAT contig even though its widened window straddles the boundary
    (the anchor is a real hit position, not a window midpoint)."""
    rng = np.random.default_rng(41)
    a = _random_ref(rng, 1500, "A")
    b = _random_ref(rng, 1500, "B")
    reads = [
        Sequence("tailA", a.sequence[1440:1500]),  # last 60 bp of A
        Sequence("headB", b.sequence[0:60]),       # first 60 bp of B
    ]
    res = map_reads(reads, [a, b], SCORES, k=15, engine="scan")
    assert res[0].mapped and res[0].contig.name == "A"
    assert res[0].mapinfo[1] <= 1440 and res[0].mapinfo[3] >= 1499
    assert res[1].mapped and res[1].contig.name == "B"
    assert res[1].mapinfo[3] >= 59
    assert all(r.score == 60 for r in res)


def test_map_reads_soft_masked_lowercase():
    """Soft-masked (lowercase) reference regions and lowercase reads
    must seed AND extend: case is normalized before the byte-equality
    DP, so a perfect lowercase match scores full length."""
    rng = np.random.default_rng(43)
    up = "".join(rng.choice(list("ACGT"), 2000))
    ref = Sequence("r", up[:800] + up[800:1000].lower() + up[1000:])
    reads = [
        Sequence("masked", ref.sequence[850:940]),      # lowercase read
        Sequence("upper", ref.sequence[850:940].upper()),
        Sequence("plain", ref.sequence[200:290]),
    ]
    res = map_reads(reads, ref, SCORES, k=15, engine="scan")
    for r in res:
        assert r.mapped, r.read.name
        assert r.score == 90, (r.read.name, r.score)
    assert res[0].mapinfo[1] <= 850 and res[0].mapinfo[3] >= 939


def test_map_reads_rejects_bad_knobs():
    ref = Sequence("r", "ACGT" * 100)
    q = Sequence("q", "ACGT" * 10)
    with pytest.raises(ValueError, match="band"):
        map_reads([q], ref, SCORES, k=5, band=0)
    with pytest.raises(ValueError, match="max_hits"):
        map_reads([q], ref, SCORES, k=5, max_hits=0)


def test_write_sam_paired_rejects_mismatch(tmp_path):
    from genomics_rs_tpu.models.mapper import write_sam_paired

    rng = np.random.default_rng(47)
    ref = _random_ref(rng, 1000)
    r = map_reads([Sequence("q", ref.sequence[100:180])], ref, SCORES,
                  k=15, engine="scan")
    with pytest.raises(ValueError, match="mate count"):
        write_sam_paired(str(tmp_path / "x.sam"), r, [])


def test_mapq_margin():
    """MAPQ reflects seed-margin uniqueness: a read matching a unique
    locus gets 60, a read matching two identical loci gets 0."""
    rng = np.random.default_rng(53)
    mid = "".join(rng.choice(list("ACGT"), 120))
    flank = lambda n: "".join(rng.choice(list("ACGT"), n))
    # `mid` appears twice, far apart; `uniq` once.
    ref = Sequence("r", flank(500) + mid + flank(700) + mid + flank(500))
    uniq_start = 500 + 120 + 100
    reads = [
        Sequence("multi", mid[:90]),
        Sequence("uniq", ref.sequence[uniq_start : uniq_start + 90]),
    ]
    res = map_reads(reads, ref, SCORES, k=15, engine="scan")
    assert res[0].mapped and res[0].mapq == 0  # tied duplicate locus
    assert res[1].mapped and res[1].mapq == 60
    # Device engine agrees.
    dev = map_reads(
        reads, ref, SCORES, k=15, engine="scan", seed_engine="device"
    )
    assert [r.mapq for r in dev] == [r.mapq for r in res]


@pytest.mark.parametrize("both_strands", [True, False])
def test_plan_extensions_is_per_read(both_strands):
    """Planning a subset of reads gives those reads' windows exactly
    as planning the whole batch does (what checks that re-derive a
    read's extension window rely on)."""
    from genomics_rs_tpu.models.mapper import plan_extensions

    rng = np.random.default_rng(77)
    ref = Sequence("ref", "".join(rng.choice(list("ACGT"), 6000)))
    reads = []
    for k in range(24):
        p = int(rng.integers(0, 5800))
        s = ref.sequence[p : p + 120]
        if k % 2:
            s = Sequence("x", s).reverse_complement().sequence
        if k % 5 == 0:
            s = "".join(rng.choice(list("ACGT"), 120))  # unmappable
        reads.append(Sequence(f"r{k}", s))
    index = KmerIndex([ref], 15)
    kw = dict(stride=7, band=32, max_hits=64, min_seeds=2,
              both_strands=both_strands)
    full = plan_extensions(reads, index, **kw)
    sub_ix = [1, 4, 5, 9, 10, 17, 23]
    part = plan_extensions([reads[i] for i in sub_ix], index, **kw)

    def windows(plan, ids):
        out = {}
        for t, i in enumerate(plan.mapped_ix):
            out[ids[i]] = (
                plan.chosen[i].sequence, plan.win_seqs[t].sequence,
                plan.win_starts[t],
            )
        return out

    want = {k: v for k, v in windows(full, list(range(24))).items()
            if k in sub_ix}
    assert windows(part, sub_ix) == want
    assert [part.strands[j] for j in range(len(sub_ix))] == [
        full.strands[i] for i in sub_ix
    ]
