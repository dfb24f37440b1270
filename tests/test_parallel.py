"""Batched + sharded scoring on the virtual 8-device CPU mesh.

Validates that (a) vmap'd score-only fills agree with the single-pair
oracle, (b) shard_map over the data axis returns identical per-pair
scores and correctly psum/pmax-merged stats, (c) the driver's
``dryrun_multichip`` entry point runs.
"""

import numpy as np
import pytest

import jax

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.aligner import PairwiseAligner
from genomics_rs_tpu.parallel.batch import (
    batch_scores,
    batch_scores_sharded,
    pad_batch,
)
from genomics_rs_tpu.parallel.mesh import make_mesh
from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


def _random_batch(rng, B, L):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ms = rng.integers(L // 3, L + 1, B).astype(np.int32)
    ns = rng.integers(L // 3, L + 1, B).astype(np.int32)
    s1eb = np.full((B, L), PAD_S1, dtype=np.uint8)
    s2eb = np.full((B, L), PAD_S2, dtype=np.uint8)
    for b in range(B):
        s1eb[b, : ms[b]] = bases[rng.integers(0, 4, ms[b])]
        s2eb[b, : ns[b]] = bases[rng.integers(0, 4, ns[b])]
    return s1eb, s2eb, ms, ns


@pytest.mark.parametrize("is_local", [False, True])
def test_batch_matches_single_pair(is_local):
    rng = np.random.default_rng(42)
    B, L = 6, 96
    s1eb, s2eb, ms, ns = _random_batch(rng, B, L)
    out = batch_scores(s1eb, s2eb, ms, ns, SCORES, is_local)

    aligner = PairwiseAligner(SCORES, is_local=is_local, engine="scan")
    for b in range(B):
        s1 = Sequence("a", bytes(s1eb[b, : ms[b]]).decode())
        s2 = Sequence("b", bytes(s2eb[b, : ns[b]]).decode())
        expected = aligner.align(s1, s2)
        assert int(out.score[b]) == expected.score, f"pair {b}"


@pytest.mark.parametrize("is_local", [False, True])
def test_sharded_matches_batch(is_local):
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    mesh = make_mesh(8)
    rng = np.random.default_rng(7)
    B, L = 11, 64
    arrs = _random_batch(rng, B, L)
    (s1eb, s2eb, ms, ns), pb = pad_batch(
        arrs, B, 8, pad_values=[None, None, 0, 0]
    )
    assert pb % 8 == 0

    ref = batch_scores(s1eb, s2eb, ms, ns, SCORES, is_local)
    out = batch_scores_sharded(mesh, s1eb, s2eb, ms, ns, SCORES, is_local)

    np.testing.assert_array_equal(np.asarray(out.score), np.asarray(ref.score))
    np.testing.assert_array_equal(
        np.asarray(out.start_i), np.asarray(ref.start_i)
    )
    assert int(out.max_score) == int(np.max(np.asarray(ref.score)))
    assert float(out.total_cells) == float(ref.total_cells)


@pytest.mark.parametrize("L", [128, 512, 1024])
@pytest.mark.parametrize("is_local", [False, True])
def test_sharded_compiled_trace_vma(L, is_local):
    """The per-shard fill must trace under ``check_vma=True`` (the
    scan carries are pcast to varying over the mesh axis);
    ``eval_shape`` runs the abstract eval where the vma checker
    fires, at the padded lengths the all-pairs buckets use."""
    mesh = make_mesh(8)
    B = 8
    s1eb = np.zeros((B, L), np.uint8)
    s2eb = np.zeros((B, L), np.uint8)
    ms = np.full(B, L - 12, np.int32)
    ns = np.full(B, L - 12, np.int32)
    out = jax.eval_shape(
        lambda a, b, c, d: batch_scores_sharded(
            mesh, a, b, c, d, SCORES, is_local
        ),
        s1eb,
        s2eb,
        ms,
        ns,
    )
    assert out.score.shape == (B,)


def test_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    assert int(out[1]) == int(args[2])  # global start_i == m
