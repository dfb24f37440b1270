"""Batched + sharded alignment scoring.

Device replacement for the reference's rayon fan-out
(``/root/reference/src/main.rs:245-261``): instead of threads mutating
a shared matrix, fixed-shape *batches* of encoded pairs are scored with
a ``vmap``-ed wavefront fill, and batches are sharded over the mesh's
``data`` axis with ``shard_map``; global statistics are merged with
``psum``/``pmax`` collectives rather than shared memory.

Score-only mode (``emit_dirs=False``) keeps per-pair state O(m+n), so
thousands of ~30 kb pairs batch comfortably in device memory; pairs
that need a full traceback re-run the single-pair path with the
direction table.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.engine import resolve_engine
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.parallel.mesh import DATA_AXIS


class BatchScores(NamedTuple):
    """Per-pair results plus collectively-merged batch statistics.

    score:    int32[B]  alignment score per pair.
    start_i:  int32[B]  retrace start row (m for global, argmax local).
    start_j:  int32[B]  retrace start col.
    max_score: int32    max score across the whole (global) batch.
    total_cells: float32  total true DP cells across the batch (float:
        int32 would overflow past ~2 CoV pairs and x64 is off by default).
    """

    score: jax.Array
    start_i: jax.Array
    start_j: jax.Array
    max_score: jax.Array
    total_cells: jax.Array


def _score_one(s1e, s2e, m, n, scores: Scores, is_local: bool, vma_axes=()):
    res = gotoh_fill_scan(
        s1e, s2e, m, n, scores, is_local, emit_dirs=False, vma_axes=vma_axes
    )
    return res.score, res.start_i, res.start_j


def batch_scores(
    s1eb: jax.Array,
    s2eb: jax.Array,
    ms: jax.Array,
    ns: jax.Array,
    scores: Scores,
    is_local: bool,
    vma_axes: tuple[str, ...] = (),
) -> BatchScores:
    """Score a batch of pairs on one device (vmap over the fill)."""
    fn = functools.partial(_score_one, vma_axes=vma_axes)
    sc, si, sj = jax.vmap(fn, in_axes=(0, 0, 0, 0, None, None))(
        s1eb, s2eb, ms, ns, scores, is_local
    )
    cells = jnp.sum(
        (ms.astype(jnp.float32) + 1) * (ns.astype(jnp.float32) + 1)
    )
    return BatchScores(sc, si, sj, jnp.max(sc), cells)


@functools.lru_cache(maxsize=None)
def _sharded_scores_fn(
    mesh: jax.sharding.Mesh,
    axis_name: str,
    is_local: bool,
    scores_tuple: tuple,
):
    """Build (once per static config) the jitted sharded scorer.

    Rebuilding ``shard_map`` per call would re-trace and re-lower on
    every invocation, so the jitted callable is cached on the full
    static key (the ``longseq._sharded_fn`` pattern). ``scores_tuple``
    is static so the per-shard fills see plain ints.
    """
    scores = Scores(*scores_tuple)

    def shard_fn(s1eb, s2eb, ms, ns):
        local = batch_scores(
            s1eb, s2eb, ms, ns, scores, is_local, vma_axes=(axis_name,)
        )
        return BatchScores(
            score=local.score,
            start_i=local.start_i,
            start_j=local.start_j,
            max_score=jax.lax.pmax(local.max_score, axis_name),
            total_cells=jax.lax.psum(local.total_cells, axis_name),
        )

    return jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                P(axis_name),
                P(axis_name),
                P(axis_name),
                P(axis_name),
            ),
            out_specs=BatchScores(
                score=P(axis_name),
                start_i=P(axis_name),
                start_j=P(axis_name),
                max_score=P(),
                total_cells=P(),
            ),
        )
    )


def batch_scores_sharded(
    mesh: jax.sharding.Mesh,
    s1eb: jax.Array,
    s2eb: jax.Array,
    ms: jax.Array,
    ns: jax.Array,
    scores: Scores,
    is_local: bool,
    axis_name: str = DATA_AXIS,
    engine: str = "auto",
) -> BatchScores:
    """Shard the batch over ``axis_name`` and merge stats with collectives.

    The batch dimension must be divisible by the mesh axis size (use
    :func:`pad_batch`). Per-pair outputs come back sharded over the
    same axis; ``max_score``/``total_cells`` are replicated via
    ``pmax``/``psum`` — the device-side version of the reference's
    shared-memory matrix writes. ``engine`` is resolved by
    :func:`~genomics_rs_tpu.ops.engine.resolve_engine`.
    """
    resolve_engine(engine)
    fn = _sharded_scores_fn(mesh, axis_name, is_local, scores.as_tuple())
    return fn(s1eb, s2eb, ms, ns)


_batch_scores_jit = jax.jit(batch_scores, static_argnames=("is_local",))


def score_pairs(
    s1b,
    s2b,
    ms,
    ns,
    scores: Scores,
    is_local: bool = False,
    engine: str = "auto",
):
    """Score a batch of encoded pairs on one device with the engine
    :func:`~genomics_rs_tpu.ops.engine.resolve_engine` picks.

    Returns (score, start_i, start_j) arrays of shape (B,).
    """
    resolve_engine(engine)
    out = _batch_scores_jit(s1b, s2b, ms, ns, scores, is_local)
    return out.score, out.start_i, out.start_j


def pad_batch(arrs, batch: int, multiple: int, pad_values=None):
    """Pad leading batch dim of every array in ``arrs`` up to a multiple.

    ``pad_values[i]`` fills array i's padding rows; ``None`` replicates
    row 0. Pass 0 for the length arrays so padding rows are trivial
    (1x1) fills that don't inflate cell-count statistics; padded
    scores are discarded either way. Returns (padded arrays, padded
    batch size).
    """
    import numpy as np

    pb = -(-batch // multiple) * multiple
    if pb == batch:
        return arrs, batch
    if pad_values is None:
        pad_values = [None] * len(arrs)
    out = []
    for a, pv in zip(arrs, pad_values):
        if pv is None:
            pad = np.broadcast_to(a[:1], (pb - batch,) + a.shape[1:])
        else:
            pad = np.full((pb - batch,) + a.shape[1:], pv, dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out, pb
