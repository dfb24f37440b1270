"""Sequence-parallel sharded fill vs the full-table oracle.

Runs on the virtual 8-device CPU mesh: rows sharded over ``seq``,
boundary rows exchanged with ppermute. Scores, and local argmax
(value, i, j) must match the scan oracle exactly, including the
reference's last-row-major tie-break.

All trials share one padded shape so the pipeline compiles once.
"""

import functools

import numpy as np
import pytest

import jax

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.parallel.longseq import sharded_gotoh_score
from genomics_rs_tpu.parallel.mesh import SEQ_AXIS, make_mesh
from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)
LPAD = 320  # shared padded length (multiple of 8)


def _pad(s: str, L: int, pad_value: int) -> np.ndarray:
    return Sequence("x", s).encoded(pad_to=L, pad_value=pad_value)


@pytest.mark.parametrize("is_local", [False, True])
def test_sharded_matches_oracle(is_local):
    mesh = make_mesh(8, axis_name=SEQ_AXIS)
    fill = jax.jit(
        functools.partial(
            sharded_gotoh_score, mesh, scores=SCORES, is_local=is_local
        )
    )
    oracle = jax.jit(
        functools.partial(
            gotoh_fill_scan, scores=SCORES, is_local=is_local
        ),
        static_argnames=(),
    )

    rng = np.random.default_rng(17)
    cases = [(1, 8), (317, 211)] + [
        (int(rng.integers(3, 300)), int(rng.integers(3, 300)))
        for _ in range(3)
    ]
    for trial, (m, n) in enumerate(cases):
        a = "".join(rng.choice(list("ACGT"), m))
        b = "".join(rng.choice(list("ACGT"), n))
        s1e = _pad(a, LPAD, PAD_S1)
        s2e = _pad(b, LPAD, PAD_S2)

        got = fill(s1e, s2e, np.int32(m), np.int32(n))
        ref = oracle(s1e, s2e, np.int32(m), np.int32(n))

        if is_local:
            assert int(got.best[0]) == int(ref.score), (trial, a, b)
            assert int(got.best[1]) == int(ref.start_i), (trial, a, b)
            assert int(got.best[2]) == int(ref.start_j), (trial, a, b)
        else:
            assert int(got.score) == int(ref.score), (trial, a, b)


@pytest.mark.parametrize("is_local", [False, True])
def test_sharded_n_blocks_matches_oracle(is_local):
    """More column blocks than devices (C = 16 on an 8-device ring):
    the pipeline runs P + C - 1 steps and must still equal the
    one-shot scan."""
    mesh = make_mesh(8, axis_name=SEQ_AXIS)
    rng = np.random.default_rng(19)
    m, n = 317, 211
    a = "".join(rng.choice(list("ACGT"), m))
    b = "".join(rng.choice(list("ACGT"), n))
    s1e = _pad(a, LPAD, PAD_S1)
    s2e = _pad(b, LPAD, PAD_S2)

    got = sharded_gotoh_score(
        mesh,
        s1e,
        s2e,
        np.int32(m),
        np.int32(n),
        SCORES,
        is_local,
        n_blocks=16,
    )
    ref = gotoh_fill_scan(s1e, s2e, np.int32(m), np.int32(n), SCORES, is_local)
    if is_local:
        assert int(got.best[0]) == int(ref.score)
        assert int(got.best[1]) == int(ref.start_i)
        assert int(got.best[2]) == int(ref.start_j)
    else:
        assert int(got.score) == int(ref.score)


@pytest.mark.parametrize("is_local", [False, True])
def test_batched_2d_mesh(is_local):
    """(data=2, seq=4) mesh: batch of pairs, rows sharded per pair."""
    from genomics_rs_tpu.parallel.longseq import batched_sharded_scores
    from genomics_rs_tpu.parallel.mesh import make_mesh_2d

    mesh2 = make_mesh_2d(2, 4)
    rng = np.random.default_rng(23)
    B, L = 4, 64
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ms = rng.integers(L // 2, L + 1, B).astype(np.int32)
    ns = rng.integers(L // 2, L + 1, B).astype(np.int32)
    s1b = np.full((B, L), PAD_S1, dtype=np.uint8)
    s2b = np.full((B, L), PAD_S2, dtype=np.uint8)
    for i in range(B):
        s1b[i, : ms[i]] = bases[rng.integers(0, 4, ms[i])]
        s2b[i, : ns[i]] = bases[rng.integers(0, 4, ns[i])]

    out = batched_sharded_scores(
        mesh2,
        s1b,
        s2b,
        ms,
        ns,
        SCORES,
        is_local,
    )
    for i in range(B):
        ref = gotoh_fill_scan(
            s1b[i], s2b[i], ms[i], ns[i], SCORES, is_local
        )
        got = int(out.best[i][0]) if is_local else int(out.score[i])
        assert got == int(ref.score), i


class TestAlignSharded:
    """Multi-device FULL traceback: path/stats bit-identical to the
    single-device aligner on the CPU mesh."""

    @pytest.mark.parametrize("is_local", [False, True])
    def test_matches_single_chip_aligner(self, is_local):
        from genomics_rs_tpu.models.aligner import PairwiseAligner
        from genomics_rs_tpu.parallel.longseq import align_sharded

        mesh = make_mesh(8, axis_name=SEQ_AXIS)
        rng = np.random.default_rng(23)
        oracle = PairwiseAligner(SCORES, is_local=is_local, engine="scan")
        for m, n in [(317, 211), (64, 290), (150, 150)]:
            a = Sequence("a", "".join(rng.choice(list("ACGT"), m)))
            b = Sequence("b", "".join(rng.choice(list("ACGT"), n)))
            got = align_sharded(mesh, a, b, SCORES, is_local=is_local)
            ref = oracle.align(a, b)
            assert got.alignment == ref.alignment, (m, n, is_local)
            assert got.score == ref.score
            assert (
                got.matches, got.mismatches,
                got.gap_extensions, got.opening_gaps,
            ) == (
                ref.matches, ref.mismatches,
                ref.gap_extensions, ref.opening_gaps,
            )

    def test_tall_shard_backward(self):
        # 150-row shards, several windows per shard walk.
        from genomics_rs_tpu.models.aligner import PairwiseAligner
        from genomics_rs_tpu.parallel.longseq import align_sharded

        mesh = make_mesh(4, axis_name=SEQ_AXIS)
        rng = np.random.default_rng(29)
        m, n = 600, 500
        a = Sequence("a", "".join(rng.choice(list("ACGT"), m)))
        b = Sequence("b", "".join(rng.choice(list("ACGT"), n)))
        got = align_sharded(mesh, a, b, SCORES)
        ref = PairwiseAligner(SCORES, engine="scan").align(a, b)
        assert got.alignment == ref.alignment
        assert got.score == ref.score

    def test_forced_left_exit(self):
        # A long horizontal gap run out-runs the first window guess;
        # the walk must left-exit and resume one stride wider.
        from genomics_rs_tpu.models.aligner import PairwiseAligner
        from genomics_rs_tpu.parallel.longseq import align_sharded

        mesh = make_mesh(2, axis_name=SEQ_AXIS)
        rng = np.random.default_rng(31)
        core = "".join(rng.choice(list("ACGT"), 100))
        ins = "".join(rng.choice(list("ACGT"), 400))
        a = Sequence("a", core)
        b = Sequence("b", core[:50] + ins + core[50:])
        got = align_sharded(mesh, a, b, SCORES)
        ref = PairwiseAligner(SCORES, engine="scan").align(a, b)
        assert got.alignment == ref.alignment
        assert got.score == ref.score
