"""Variant-caller tests (extension: map -> pileup -> call).

Synthetic truth: a random reference, perfectly tiled reads with
planted SNPs/deletions — the caller must recover exactly the planted
variants and nothing else, the device scatter pileup must equal the
host pileup bit-for-bit, and the VCF must round-trip the calls.
"""

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.caller import (
    VariantCall,
    call_pileup,
    call_reads,
    pileup,
    write_vcf,
)
from genomics_rs_tpu.sequence import Sequence

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


def _random_ref(n, seed=0):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), n))


def _tile_reads(seq, read_len=80, step=7, mutate=()):
    """Perfect reads tiling ``seq``; ``mutate`` maps ref pos -> base
    ('' = delete that base from every covering read)."""
    reads = []
    for k, start in enumerate(range(0, len(seq) - read_len + 1, step)):
        chars = []
        for p in range(start, start + read_len):
            b = mutate.get(p, seq[p]) if mutate else seq[p]
            chars.append(b)
        reads.append(Sequence(f"r{k}", "".join(chars)))
    return reads


def test_pileup_from_synthetic_records():
    # One contig "AACGT", two reads: 5M at pos 1, 2M1D2M at pos 1.
    recs = [
        dict(mapped=True, pos=1, cigar="5M", seq="AACGT", rname="c"),
        dict(mapped=True, pos=1, cigar="2M1D2M", seq="AAGT", rname="c"),
        dict(mapped=False, pos=0, cigar="*", seq="AA", rname="*"),
    ]
    host = pileup(recs, 5, device=False)
    dev = pileup(recs, 5, device=True)
    assert (host == dev).all()
    # pos2 (0-based 2): one 'C' + one deletion.
    assert host[2].tolist() == [0, 1, 0, 0, 1]
    assert host[0].tolist() == [2, 0, 0, 0, 0]
    assert host.sum() == 10  # 5 + (4 bases + 1 deletion mark)


def test_pileup_softclip_and_insert_offsets():
    # 2S3M: the clip consumes read bases, not reference positions;
    # 1M2I2M: the insert shifts the read cursor only.
    recs = [
        dict(mapped=True, pos=2, cigar="2S3M", seq="GGACG", rname="c"),
        dict(mapped=True, pos=1, cigar="1M2I2M", seq="ATTAC", rname="c"),
    ]
    counts = pileup(recs, 5, device=False)
    # read1: ACG at 0-based 1,2,3; read2: A at 0, AC at 1,2.
    assert counts[0].tolist() == [1, 0, 0, 0, 0]
    assert counts[1][0] == 2  # 'A' from both
    assert counts[2][1] == 2  # 'C'
    assert counts[3][2] == 1  # 'G'


def test_call_pileup_snp_and_floor():
    ref = "ACGTA"
    counts = np.zeros((5, 5), np.int32)
    counts[1, 1] = 2  # C (ref) minority
    counts[1, 3] = 8  # T alt
    counts[3, 0] = 3  # depth 3 < min_depth: no call
    calls = call_pileup(counts, ref, "c", min_depth=5, min_frac=0.7)
    assert len(calls) == 1
    c = calls[0]
    assert (c.pos, c.ref, c.alt, c.depth, c.alt_count) == (2, "C", "T", 10, 8)


def test_call_reads_recovers_planted_snps():
    ref_seq = _random_ref(600, seed=3)
    # Plant two SNPs far apart; flip to a guaranteed-different base.
    flip = {"A": "G", "C": "T", "G": "A", "T": "C"}
    muts = {150: flip[ref_seq[150]], 400: flip[ref_seq[400]]}
    reads = _tile_reads(ref_seq, mutate=muts)
    refs = [Sequence("chr", ref_seq)]
    calls, pileups = call_reads(
        reads, refs, SCORES,
        min_depth=5, min_frac=0.7,
        engine="scan", min_seeds=2, k=15,
    )
    got = {(c.pos, c.alt) for c in calls}
    assert got == {(151, muts[150]), (401, muts[400])}
    # Near-homogeneous support (a read whose FIRST base is the SNP
    # can take the reference's zero-plateau local walk and deposit a
    # stray deletion mark instead — at most one such edge read).
    for c in calls:
        assert c.alt_count >= c.depth - 1
        assert c.frac >= 0.8


def test_call_reads_recovers_deletion():
    ref_seq = _random_ref(400, seed=9)
    reads = _tile_reads(ref_seq, mutate={200: "", 201: ""})
    refs = [Sequence("chr", ref_seq)]
    calls, _ = call_reads(
        reads, refs, SCORES,
        min_depth=5, min_frac=0.6,
        engine="scan", min_seeds=2, k=15,
    )
    dels = [c for c in calls if c.is_deletion]
    assert len(dels) == 1
    # Adjacent deleted positions merge into one 2-base record.
    assert dels[0].pos == 201
    assert dels[0].ref == ref_seq[200:202]
    snps = [c for c in calls if not c.is_deletion]
    assert snps == []


def test_write_vcf(tmp_path):
    refs = [Sequence("chr", "AACGTT")]
    calls = [
        VariantCall("chr", 3, "C", "T", 12, 11),
        VariantCall("chr", 5, "T", "", 9, 8),  # deletion of T at 5
    ]
    out = tmp_path / "calls.vcf"
    write_vcf(str(out), calls, refs)
    lines = [
        l for l in out.read_text().splitlines() if not l.startswith("#")
    ]
    assert lines[0].split("\t")[:5] == ["chr", "3", ".", "C", "T"]
    # Deletion: anchored at pos 4 (base G), REF="GT", ALT="G".
    assert lines[1].split("\t")[:5] == ["chr", "4", ".", "GT", "G"]


def test_call_cli(tmp_path):
    from genomics_rs_tpu.cli import main

    ref_seq = _random_ref(500, seed=5)
    flip = {"A": "G", "C": "T", "G": "A", "T": "C"}
    mut_pos = 250
    reads = _tile_reads(ref_seq, mutate={mut_pos: flip[ref_seq[mut_pos]]})
    ref_fa = tmp_path / "ref.fasta"
    ref_fa.write_text(f">chr\n{ref_seq}\n")
    reads_fa = tmp_path / "reads.fasta"
    reads_fa.write_text(
        "".join(f">{r.name}\n{r.sequence}\n" for r in reads)
    )
    cfg = tmp_path / "config.toml"
    cfg.write_text(
        "[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n"
    )
    out = tmp_path / "calls.vcf"
    rc = main(
        [
            "-c", str(cfg), "call",
            "-q", str(reads_fa), "-r", str(ref_fa),
            "-k", "15", "--engine", "scan",
            "--min-depth", "5", "-o", str(out),
        ]
    )
    assert rc == 0
    body = [
        l for l in out.read_text().splitlines() if not l.startswith("#")
    ]
    assert len(body) == 1
    f = body[0].split("\t")
    assert f[0] == "chr" and int(f[1]) == mut_pos + 1
    assert f[3] == ref_seq[mut_pos] and f[4] == flip[ref_seq[mut_pos]]


def test_pileup_n_skip_and_unknown_op():
    # N consumes reference positions without deletion evidence.
    recs = [dict(mapped=True, pos=1, cigar="2M3N2M", seq="AAGG", rname="c")]
    counts = pileup(recs, 7, device=False)
    assert counts[0][0] == 1 and counts[1][0] == 1
    assert counts[2].sum() == 0 and counts[4].sum() == 0  # skipped
    assert counts[5][2] == 1 and counts[6][2] == 1
    # Unknown ops fail loudly instead of desyncing positions.
    bad = [dict(mapped=True, pos=1, cigar="2M1Z2M", seq="AAGG", rname="c")]
    with pytest.raises(ValueError):
        pileup(bad, 7, device=False)


def test_write_vcf_deletion_at_position_one(tmp_path):
    refs = [Sequence("chr", "ACGTT")]
    calls = [VariantCall("chr", 1, "AC", "", 9, 8)]  # del of prefix AC
    out = tmp_path / "p1.vcf"
    write_vcf(str(out), calls, refs)
    body = [
        l for l in out.read_text().splitlines() if not l.startswith("#")
    ]
    # Anchors on the base AFTER the run: POS=1, REF="ACG", ALT="G".
    assert body[0].split("\t")[:5] == ["chr", "1", ".", "ACG", "G"]


def test_pileup_full_collects_insertions():
    from genomics_rs_tpu.models.caller import pileup_full

    recs = [
        dict(mapped=True, pos=1, cigar="2M2I3M", seq="AATTCGT", rname="c"),
        dict(mapped=True, pos=1, cigar="2M2I3M", seq="AATTCGT", rname="c"),
    ]
    counts, ins = pileup_full(recs, 5, device=False)
    # The TT insert anchors after 0-based position 1.
    assert ins == {1: {"TT": 2}}
    assert counts[1][0] == 2 and counts[2][1] == 2


def test_call_insertions_gates_and_shape():
    from genomics_rs_tpu.models.caller import call_insertions

    counts = np.zeros((5, 5), np.int32)
    counts[1, 0] = 10  # anchor depth 10
    counts[3, 0] = 10
    ins = {1: {"GG": 8, "G": 1}, 3: {"AA": 2}}  # 3: below frac
    calls = call_insertions(ins, counts, "AACGT", "c", 5, 0.7)
    assert len(calls) == 1
    c = calls[0]
    assert c.is_insertion and not c.is_deletion
    assert (c.pos, c.ref, c.alt, c.depth, c.alt_count) == (2, "A", "AGG", 10, 8)


def test_call_reads_recovers_insertion(tmp_path):
    ref_seq = _random_ref(400, seed=21)
    # Donor inserts "GG" after ref position 199 in every covering read.
    donor = ref_seq[:200] + "GG" + ref_seq[200:]
    reads = _tile_reads(donor)
    refs = [Sequence("chr", ref_seq)]
    calls, _ = call_reads(
        reads, refs, SCORES,
        min_depth=5, min_frac=0.6,
        engine="scan", min_seeds=2, k=15,
    )
    ins = [c for c in calls if c.is_insertion]
    assert len(ins) == 1
    assert ins[0].pos == 200  # anchor = ref position 200 (1-based)
    assert ins[0].alt == ref_seq[199] + "GG"
    # VCF writes the insertion verbatim.
    out = tmp_path / "ins.vcf"
    write_vcf(str(out), calls, refs)
    body = [
        l for l in out.read_text().splitlines() if not l.startswith("#")
    ]
    assert any(
        r.split("\t")[1] == "200" and r.split("\t")[4] == ref_seq[199] + "GG"
        for r in body
    )


def test_insertions_with_ambiguous_bases_skipped():
    from genomics_rs_tpu.models.caller import pileup_full

    recs = [
        dict(mapped=True, pos=1, cigar="2M2I2M", seq="AANNGT", rname="c"),
        dict(mapped=True, pos=1, cigar="2M2I2M", seq="AATTGT", rname="c"),
    ]
    _, ins = pileup_full(recs, 4, device=False)
    # The NN insert is dropped; only the clean TT event is recorded.
    assert ins == {1: {"TT": 1}}


def test_call_reads_multi_contig():
    """Variants on different contigs are called with the right
    contig names and coordinates."""
    flip = {"A": "G", "C": "T", "G": "A", "T": "C"}
    ref1 = _random_ref(300, seed=31)
    ref2 = _random_ref(300, seed=32)
    m1, m2 = 140, 170
    reads = _tile_reads(ref1, mutate={m1: flip[ref1[m1]]}) + [
        Sequence(f"q{k}", s.sequence)
        for k, s in enumerate(
            _tile_reads(ref2, mutate={m2: flip[ref2[m2]]})
        )
    ]
    refs = [Sequence("chrA", ref1), Sequence("chrB", ref2)]
    calls, pileups = call_reads(
        reads, refs, SCORES,
        min_depth=5, min_frac=0.7,
        engine="scan", min_seeds=2, k=15,
    )
    got = {(c.contig, c.pos, c.alt) for c in calls}
    assert got == {
        ("chrA", m1 + 1, flip[ref1[m1]]),
        ("chrB", m2 + 1, flip[ref2[m2]]),
    }
    assert set(pileups) == {"chrA", "chrB"}


def test_leading_edge_insertion_dropped():
    """An I run before any reference-consuming op anchors on a base
    the read does not cover — its depth gate would be judged against
    other reads' evidence only, so it is not recorded (ADVICE r3)."""
    from genomics_rs_tpu.models.caller import pileup_full

    recs = [
        # Leading-edge insert: anchor (pos-2 = 1) is uncovered.
        dict(mapped=True, pos=3, cigar="2I3M", seq="TTCGT", rname="c"),
        # Same anchor, but mid-read: recorded.
        dict(mapped=True, pos=2, cigar="1M2I3M", seq="ATTCGT", rname="c"),
    ]
    _, ins = pileup_full(recs, 6, device=False)
    assert ins == {1: {"TT": 1}}


def test_merged_deletion_reports_weakest_evidence():
    """DP/AC of an adjacent-merged deletion run are the min across
    the run, not the max (ADVICE r3)."""
    ref = "ACGTT"
    counts = np.zeros((5, 5), np.int32)
    counts[:, :] = 0
    # Position 1: strong deletion (30 deep, 29 del votes).
    counts[1, 4] = 29
    counts[1, 1] = 1
    # Position 2: weak deletion (10 deep, 8 del votes).
    counts[2, 4] = 8
    counts[2, 2] = 2
    calls = call_pileup(counts, ref, "c", min_depth=5, min_frac=0.7)
    assert len(calls) == 1
    c = calls[0]
    assert c.is_deletion and (c.pos, c.ref) == (2, "CG")
    assert (c.depth, c.alt_count) == (10, 8)


# ---- quality-aware calling (round 4) ----


def _q(chrs):
    """Phred string from a list of quality values."""
    return "".join(chr(33 + v) for v in chrs)


def test_pileup_q_weights_and_gates():
    from genomics_rs_tpu.models.caller import pileup_q

    recs = [
        # High-quality read (q40 everywhere), mapq 60.
        dict(mapped=True, pos=1, cigar="4M", seq="ACGT",
             qual=_q([40, 40, 40, 40]), mapq=60, rname="c"),
        # Low-quality base at position 1 (q2 < min_baseq): dropped.
        dict(mapped=True, pos=1, cigar="4M", seq="ATGT",
             qual=_q([40, 2, 40, 40]), mapq=60, rname="c"),
        # Whole read below min_mapq: dropped.
        dict(mapped=True, pos=1, cigar="4M", seq="TTTT",
             qual=_q([40, 40, 40, 40]), mapq=3, rname="c"),
    ]
    counts, wsum, ins, ins_w = pileup_q(
        recs, 4, device=False, min_baseq=13, min_mapq=10
    )
    # Position 1: only read 1's 'C' survives.
    assert counts[1].tolist() == [0, 1, 0, 0, 0]
    # Every surviving vote weighs (1-1e-4) * (1-1e-6) ~ 0.9999.
    assert counts.sum() == 7  # 4 + 3 (low-q base dropped)
    assert wsum.sum() == pytest.approx(7 * 0.9999, rel=1e-3)
    # Device scatter == host scatter.
    counts_d, wsum_d, _, _ = pileup_q(
        recs, 4, device=True, min_baseq=13, min_mapq=10
    )
    assert (counts == counts_d).all()
    # float32 scatter-add: the device sums in an order that varies
    # from run to run (atomics on the GPU), so weights agree to a few
    # ulps of float32, not bit for bit; counts are int32 and exact.
    np.testing.assert_allclose(wsum, wsum_d, rtol=1e-6)


def test_weighted_consensus_outvotes_low_quality():
    """6 low-q reads voting T vs 4 high-q reads voting C at one
    position: head-counting calls T, quality weighting calls C."""
    from genomics_rs_tpu.models.caller import pileup_q

    recs = []
    for _ in range(6):
        recs.append(
            dict(mapped=True, pos=1, cigar="3M", seq="ATG",
                 qual=_q([40, 3, 40]), mapq=60, rname="c")
        )
    for _ in range(4):
        recs.append(
            dict(mapped=True, pos=1, cigar="3M", seq="ACG",
                 qual=_q([40, 40, 40]), mapq=60, rname="c")
        )
    ref = "AGG"  # position 1 ref G: both T and C are alt
    counts, wsum, _, _ = pileup_q(recs, 3, device=False)
    plain = call_pileup(counts, ref, "c", min_depth=5, min_frac=0.5)
    weighted = call_pileup(
        counts, ref, "c", min_depth=5, min_frac=0.5, weights=wsum
    )
    assert [c.alt for c in plain] == ["T"]
    assert [c.alt for c in weighted] == ["C"]


def test_weighted_insertions_use_weighted_support():
    from genomics_rs_tpu.models.caller import call_insertions

    counts = np.zeros((4, 5), np.int32)
    counts[1, 0] = 10
    weights = np.zeros((4, 5), np.float32)
    weights[1, 0] = 4.0  # most coverage is low-quality
    ins = {1: {"GG": 4}}
    ins_w = {1: {"GG": 3.6}}  # high-quality insert support
    # Head-count fraction 4/10 < 0.7 -> no call without weights.
    assert not call_insertions(ins, counts, "AACG", "c", 5, 0.7)
    # Weighted fraction 3.6/4.0 >= 0.7 -> called; AC stays integer.
    calls = call_insertions(
        ins, counts, "AACG", "c", 5, 0.7, ins_w=ins_w, weights=weights
    )
    assert len(calls) == 1 and calls[0].alt_count == 4


def test_call_reads_weighted_end_to_end():
    """FASTQ-style reads with one noisy position: weighted calling
    recovers the planted SNP and rejects the noise position."""
    flip = {"A": "G", "C": "T", "G": "A", "T": "C"}
    ref = _random_ref(300, seed=5)
    m = 150
    reads = _tile_reads(ref, mutate={m: flip[ref[m]]})
    # Attach qualities: q38 everywhere.
    reads = [
        Sequence(r.name, r.sequence, "".join(chr(33 + 38) for _ in r.sequence))
        for r in reads
    ]
    calls, _ = call_reads(
        reads, [Sequence("chrT", ref)], SCORES,
        min_depth=5, min_frac=0.7, weighted=True, min_baseq=10,
        engine="scan", min_seeds=2, k=15,
    )
    got = {(c.pos, c.alt) for c in calls}
    assert got == {(m + 1, flip[ref[m]])}


def test_min_alt_conf_filters_ambiguous_support():
    """A site whose alt support comes only from ambiguously-mapped
    reads (mean weight ~0.5) is filtered by min_alt_conf; confident
    support (mean ~1.0) passes."""
    ref = "ACGTA"
    counts = np.zeros((5, 5), np.int32)
    weights = np.zeros((5, 5), np.float32)
    # Position 1 (ref C): 10 alt 'T' votes, all weight 0.5.
    counts[1, 3] = 10
    weights[1, 3] = 5.0
    # Position 3 (ref T): 10 alt 'A' votes, weight ~1.
    counts[3, 0] = 10
    weights[3, 0] = 9.9
    base = call_pileup(counts, ref, "c", 5, 0.6, weights=weights)
    assert {(c.pos, c.alt) for c in base} == {(2, "T"), (4, "A")}
    conf = call_pileup(
        counts, ref, "c", 5, 0.6, weights=weights, min_alt_conf=0.8
    )
    assert {(c.pos, c.alt) for c in conf} == {(4, "A")}


def test_min_alt_conf_alone_enables_quality_pileup():
    """--min-alt-conf without --weighted must not be a silent no-op:
    it implies the quality pileup (the gate is defined on weighted
    evidence)."""
    import numpy as np

    from genomics_rs_tpu.models import caller as cal

    seen = {}
    orig = cal.pileup_q

    def spy(*a, **k):
        seen["called"] = True
        return orig(*a, **k)

    import numpy as np

    rng = np.random.default_rng(3)
    ref = Sequence("r", "".join(rng.choice(list("ACGT"), 200)))
    reads = [
        Sequence(f"q{i}", ref.sequence[20:100], quality="I" * 80)
        for i in range(10)
    ]
    import unittest.mock as mock

    with mock.patch.object(cal, "pileup_q", side_effect=spy):
        cal.call_reads(
            reads, [ref], SCORES, min_depth=2, min_alt_conf=0.5,
            device_pileup=False, engine="scan", k=11, min_seeds=1,
        )
    assert seen.get("called"), "min_alt_conf alone must run pileup_q"


def test_weighted_insertion_support_scales_with_base_quality():
    """Insertion events weigh like the per-base votes they compete
    against (baseq x MAPQ): low-quality flanking bases must not make
    an insertion EASIER to call (round-4 review)."""
    from genomics_rs_tpu.models.caller import call_insertions, pileup_q

    ref_len = 20
    # 8 reads at q2 cover the anchor; 3 of them (mapq 60) carry an
    # insertion at q2. Weighted support must stay proportional to
    # the (low) base quality, so 3/8 reads cannot clear min_frac=0.7.
    recs = []
    for i in range(8):
        has_ins = i < 3
        cigar = "5M2I5M" if has_ins else "10M"
        seq = "ACGTA" + ("GG" if has_ins else "") + "CGTAC"
        recs.append(
            {
                "mapped": True,
                "pos": 3,
                "seq": seq,
                "qual": "#" * len(seq),  # phred 2
                "cigar": cigar,
                "mapq": 60,
            }
        )
    counts, wsum, insertions, ins_w = pileup_q(recs, ref_len, device=False)
    calls = call_insertions(
        insertions, counts, "A" * ref_len, "c", min_depth=2,
        min_frac=0.7, ins_w=ins_w, weights=wsum,
    )
    assert calls == [], (
        "3/8-read insertion called because low base quality deflated "
        f"the depth: {calls}"
    )
