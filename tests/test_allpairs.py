"""All-pairs DP score matrix driver (scan engine on the CPU mesh)."""

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.aligner import PairwiseAligner
from genomics_rs_tpu.parallel.allpairs import allpairs_scores, write_scores_tsv
from genomics_rs_tpu.sequence import Sequence, SequenceContainer

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


def test_allpairs_matches_single(tmp_path):
    rng = np.random.default_rng(31)
    seqs = [
        Sequence(f"s{k}", "".join(rng.choice(list("ACGT"), int(rng.integers(20, 90)))))
        for k in range(5)
    ]
    container = SequenceContainer(sequences=seqs)
    result = allpairs_scores(container, SCORES, is_local=False, engine="scan")

    aligner = PairwiseAligner(SCORES, is_local=False, engine="scan")
    for j in range(5):
        for i in range(j + 1):
            want = aligner.score_only(seqs[i], seqs[j])
            assert int(result.matrix[j, i]) == want, (i, j)
        for i in range(j + 1, 5):
            assert int(result.matrix[j, i]) == 0

    tsv = write_scores_tsv(result, str(tmp_path / "m.tsv"))
    assert tsv.splitlines()[0].split("\t")[1:6] == [str(k) for k in range(5)]


def test_allpairs_resumable(tmp_path):
    """Crash-resume: first run interrupted mid-way, second completes
    from the checkpoint and matches the non-resumable result."""
    from genomics_rs_tpu.parallel.allpairs import allpairs_scores_resumable

    rng = np.random.default_rng(37)
    seqs = [
        Sequence(f"s{k}", "".join(rng.choice(list("ACGT"), 40)))
        for k in range(6)
    ]
    container = SequenceContainer(sequences=seqs)
    ckpt = str(tmp_path / "pairs.jsonl")

    full = allpairs_scores(container, SCORES, engine="scan")

    # Simulate a partial run: compute only the first chunk, then "crash".
    r1 = allpairs_scores_resumable(
        container, SCORES, ckpt, engine="scan", chunk_pairs=5
    )
    np.testing.assert_array_equal(r1.matrix, full.matrix)

    # Truncate the checkpoint to meta + one chunk (simulated crash,
    # including a torn trailing write) and resume.
    lines = open(ckpt).read().splitlines()
    with open(ckpt, "w") as f:
        f.write(lines[0] + "\n" + lines[1] + "\n" + '{"k0": 10, "sco')
    r2 = allpairs_scores_resumable(
        container, SCORES, ckpt, engine="scan", chunk_pairs=5
    )
    np.testing.assert_array_equal(r2.matrix, full.matrix)
    # Checkpoint now contains meta + every chunk again.
    assert len(open(ckpt).read().splitlines()) == 1 + -(-21 // 5)

    # A checkpoint from different params is discarded, not misused.
    r3 = allpairs_scores_resumable(
        container, SCORES, ckpt, engine="scan", chunk_pairs=7
    )
    np.testing.assert_array_equal(r3.matrix, full.matrix)


def test_allpairs_length_buckets_mixed_corpus():
    """Mixed corpus (clustered short genomes + one long outlier): the
    bucketed driver must keep total padded cells <= 1.3x true cells
    (the reference pays zero padding, main.rs:263-308; global
    max-length padding would be ~7x here) with an identical matrix."""
    from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan

    rng = np.random.default_rng(53)
    seqs = [
        Sequence(
            f"s{k}", "".join(rng.choice(list("ACGT"), int(rng.integers(620, 641))))
        )
        for k in range(4)
    ]
    seqs.append(Sequence("outlier", "".join(rng.choice(list("ACGT"), 3199))))
    container = SequenceContainer(sequences=seqs)

    result = allpairs_scores(container, SCORES, engine="scan")
    assert result.padded_cells <= 1.3 * result.cells, (
        result.padded_cells,
        result.cells,
    )

    # Matrix parity against the unbucketed oracle on every pair.
    from genomics_rs_tpu.sequence import PAD_S1, PAD_S2

    for j in range(5):
        for i in range(j + 1):
            ref = gotoh_fill_scan(
                seqs[i].encoded(pad_value=PAD_S1),
                seqs[j].encoded(pad_value=PAD_S2),
                np.int32(len(seqs[i])),
                np.int32(len(seqs[j])),
                SCORES,
                False,
            )
            assert int(result.matrix[j, i]) == int(ref.score), (i, j)


def test_balanced_deal_properties():
    """LPT dealing: complete partition; no share exceeds the mean by
    more than the largest single item; a single giant item reaches
    the indivisible-item efficiency bound."""
    from genomics_rs_tpu.parallel.distributed import balanced_deal

    rng = np.random.default_rng(7)
    costs = [float(c) for c in rng.integers(1, 1000, 37)] + [1e6]
    shares = balanced_deal(costs, 4)
    assert sorted(k for s in shares for k in s) == list(range(38))
    totals = [sum(costs[k] for k in s) for s in shares]
    assert max(totals) - min(totals) <= max(costs)
    # One indivisible giant: the bottleneck is exactly that share.
    assert max(totals) == pytest.approx(
        max(1e6, (sum(costs) - 1e6) / 3), rel=0.34
    )


def test_resumable_invalidates_on_content_change(tmp_path):
    """A length-preserving corpus edit must invalidate the checkpoint
    (the meta digest covers names + content, not just lengths)."""
    from genomics_rs_tpu.parallel.allpairs import allpairs_scores_resumable

    rng = np.random.default_rng(41)
    seqs = [
        Sequence(f"s{k}", "".join(rng.choice(list("ACGT"), 40)))
        for k in range(4)
    ]
    container = SequenceContainer(sequences=seqs)
    ckpt = str(tmp_path / "pairs.jsonl")
    allpairs_scores_resumable(container, SCORES, ckpt, engine="scan")

    # Same lengths, different content.
    mutated = "".join(
        {"A": "C", "C": "G", "G": "T", "T": "A"}[c]
        for c in seqs[0].sequence
    )
    seqs2 = [Sequence(seqs[0].name, mutated)] + seqs[1:]
    container2 = SequenceContainer(sequences=seqs2)
    r = allpairs_scores_resumable(container2, SCORES, ckpt, engine="scan")
    full = allpairs_scores(container2, SCORES, engine="scan")
    np.testing.assert_array_equal(r.matrix, full.matrix)


def test_allpairs_sharded_matches_single_device():
    """Single-process multi-device all-pairs: buckets sharded over the
    8-device CPU mesh must reproduce the one-device matrix. Mixed
    lengths force two buckets, each padded to a device multiple."""
    from genomics_rs_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(41)
    seqs = [
        Sequence(
            f"s{k}",
            "".join(
                rng.choice(list("ACGT"), int(rng.integers(40, 120)))
            ),
        )
        for k in range(5)
    ] + [
        Sequence(
            f"m{k}",
            "".join(
                rng.choice(list("ACGT"), int(rng.integers(140, 250)))
            ),
        )
        for k in range(2)
    ]
    container = SequenceContainer(sequences=seqs)
    for is_local in (False, True):
        one = allpairs_scores(
            container, SCORES, is_local=is_local, mesh=make_mesh(1)
        )
        got = allpairs_scores(container, SCORES, is_local=is_local)
        np.testing.assert_array_equal(got.matrix, one.matrix)
        assert got.padded_cells >= got.cells


@pytest.mark.parametrize(
    "lens,want",
    [
        ([10, 20], {(128, 128): [0, 1, 2]}),
        ([128, 129], {(128, 128): [0], (128, 256): [1], (256, 256): [2]}),
        ([300, 5000], {(512, 512): [0], (512, 8192): [1], (8192, 8192): [2]}),
        ([1, 1000], {(128, 128): [0], (128, 1024): [1], (1024, 1024): [2]}),
    ],
    ids=["one-class", "128-edge", "wide", "tiny-vs-1k"],
)
def test_bucketize_pairs(lens, want):
    from genomics_rs_tpu.parallel.allpairs import bucketize_pairs

    pairs = [(0, 0), (0, 1), (1, 1)]
    assert bucketize_pairs(pairs, lens) == want


@pytest.mark.parametrize("is_local", [False, True])
def test_score_pairs_matches_sharded(is_local):
    """One-device vmapped batch == the same batch sharded over the 8
    CPU devices (10 pairs padded to 16 with zero-length fills), and
    the merged stats equal host reductions."""
    from genomics_rs_tpu.parallel.batch import (
        batch_scores_sharded,
        pad_batch,
        score_pairs,
    )
    from genomics_rs_tpu.parallel.mesh import make_mesh
    from genomics_rs_tpu.sequence import PAD_S1, PAD_S2

    rng = np.random.default_rng(47)
    B, L = 10, 128
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ms = rng.integers(L // 2, L + 1, B).astype(np.int32)
    ns = rng.integers(L // 2, L + 1, B).astype(np.int32)
    s1b = np.full((B, L), PAD_S1, np.uint8)
    s2b = np.full((B, L), PAD_S2, np.uint8)
    for i in range(B):
        s1b[i, : ms[i]] = bases[rng.integers(0, 4, ms[i])]
        s2b[i, : ns[i]] = bases[rng.integers(0, 4, ns[i])]
    sc, si, sj = score_pairs(s1b, s2b, ms, ns, SCORES, is_local)
    (s1p, s2p, mp, np_), Bp = pad_batch(
        (s1b, s2b, ms, ns), B, 8, pad_values=[None, None, 0, 0]
    )
    assert Bp == 16
    out = batch_scores_sharded(make_mesh(), s1p, s2p, mp, np_, SCORES, is_local)
    assert np.array_equal(np.asarray(out.score)[:B], np.asarray(sc))
    assert np.array_equal(np.asarray(out.start_i)[:B], np.asarray(si))
    assert np.array_equal(np.asarray(out.start_j)[:B], np.asarray(sj))
    assert int(out.max_score) == int(np.asarray(out.score).max())
    assert float(out.total_cells) == float(
        np.sum((mp + 1.0) * (np_ + 1.0))
    )
