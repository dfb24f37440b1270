"""Sequence-parallel (wavefront-sharded) Gotoh fill over a mesh axis.

The DP analog of context parallelism (SURVEY §5): rows of the table
are sharded over the ``seq`` mesh axis, each device fills (rows x
column-block) tiles, and tile bottom rows flow to the next device with
ring ``ppermute`` — a software pipeline over the anti-diagonal of the
*tile* grid. After P + C - 1 steps every tile is filled; the global
score at (m, n) and the local argmax (reference last-row-major
tie-break) are merged with ``pmax`` collectives.

Memory per device is O((m/P) + n) — the path to pairs that no single
device (nor the reference's 48 B/cell table, SURVEY §2.4-9) can hold.

**Full traceback across the mesh** (``align_sharded``), not just
scores: the same tile pipeline runs a checkpointing forward
(``sharded_fill_checkpoints``) in which every device retains the top
row and left column of each tile it fills — exactly the boundary
values that already flow through the pipeline (tops arrive by
``ppermute`` from the row-shard above; lefts are the previous tile's
right column), so the capture costs no extra collective. The backward
pass then walks the path shard by shard: each crossed row-shard
refills a narrow column WINDOW (left boundary = the captured
tile-entry column at stride B, top boundary = the shard's captured top
row sliced to the window) with packed dirs (``tile_fill(emit_dirs=
True)``) and chases it on device (``traceback_device.device_walk``).
A walk that out-runs its window exits LEFT and resumes one stride
wider; an upward exit hands off to the shard above. Path and stats are
bit-identical to the single-device aligner (pinned by
``tests/test_longseq.py`` on the CPU mesh). Reference anchor:
``algo.rs:287-441`` — the alignment, not just the score, is the
product.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.engine import resolve_engine
from genomics_rs_tpu.ops.gotoh_tile import (
    INT_MIN,
    global_boundary_left,
    global_boundary_top,
    tile_fill,
)
from genomics_rs_tpu.parallel.mesh import SEQ_AXIS


class LongSeqResult(NamedTuple):
    score: jax.Array  # global-mode score: cell max at (m, n)
    best: jax.Array  # int32[3]: local argmax (value, i, j)


class ShardedFill(NamedTuple):
    """Checkpointing sharded forward result (see ``align_sharded``).

    tops: (P*C, 3, B+1) — tile (p, c) entry TOP row (row p*R, cols
      c*B..(c+1)*B) at index p*C + c.
    lefts: (P*C, 3, R) — tile (p, c) entry LEFT column (col c*B, rows
      p*R+1..(p+1)*R).
    """

    score: jax.Array
    best: jax.Array
    tops: jax.Array
    lefts: jax.Array


def _merge_best(a, b):
    """Associative merge with the reference tie-break (larger value,
    then larger i, then larger j)."""
    av, ai, aj = a
    bv, bi, bj = b
    b_wins = (bv > av) | (
        (bv == av) & ((bi > ai) | ((bi == ai) & (bj > aj)))
    )
    return (
        jnp.where(b_wins, bv, av),
        jnp.where(b_wins, bi, ai),
        jnp.where(b_wins, bj, aj),
    )


def _seq_core(
    s1_shard: jax.Array,
    s2_full: jax.Array,
    m: jax.Array,
    n: jax.Array,
    scores: Scores,
    is_local: bool,
    axis_name: str,
    n_blocks: int,
    vma_axes: tuple[str, ...] = (),
    emit_ckpt: bool = False,
):
    """Per-device pipeline body (call inside shard_map over axis_name).

    Each tile is filled by ``gotoh_tile.tile_fill``.

    ``emit_ckpt``: additionally return each tile's entry (top, left)
    boundaries — the values already flowing through the pipeline —
    keyed by column-block index (``ShardedFill``); the backward pass
    of ``align_sharded`` refills traceback windows from them.
    """
    from genomics_rs_tpu.ops.gotoh_scan import vary

    R = s1_shard.shape[0]
    N = s2_full.shape[0]
    C = n_blocks
    B = N // C
    assert B * C == N, "s2 length must divide into n_blocks"

    # dynamic_slice requires operand/index varying-axes to match; the
    # replicated inputs must be cast up to the full vma set before
    # being sliced with axis_index-derived (varying) offsets.
    s2_full, m, n = vary((s2_full, m, n), vma_axes)

    P_ = jax.lax.axis_size(axis_name)
    p = jax.lax.axis_index(axis_name)
    i0 = vary(p * R, vma_axes)
    int_min = jnp.int32(INT_MIN)

    left = global_boundary_left(i0, R, scores)
    top_recv = jnp.zeros((3, B + 1), dtype=jnp.int32)
    best = (int_min, jnp.int32(0), jnp.int32(0))
    at_mn = int_min

    perm = [(i, (i + 1) % P_) for i in range(P_)]
    top_steps: list[jax.Array] = []
    left_steps: list[jax.Array] = []

    for t in range(P_ + C - 1):
        c = t - p
        j0 = vary(c * B, vma_axes)
        j0c = jnp.clip(j0, 0, N - B)
        top0 = global_boundary_top(j0, B, scores)
        top = jnp.where(p == 0, top0, top_recv)
        if emit_ckpt:
            # Tile c of this device runs at step t = p + c: record the
            # boundaries in use; a post-loop gather at p + arange(C)
            # picks exactly the active steps.
            top_steps.append(top)
            left_steps.append(left)
        s2_block = jax.lax.dynamic_slice(s2_full, (j0c,), (B,))
        res = tile_fill(
            s1_shard,
            s2_block,
            top,
            left,
            scores,
            is_local,
            i0,
            j0,
            m,
            n,
            vma_axes=vma_axes,
        )
        active = (c >= 0) & (c < C)
        left = jnp.where(active, res.right, left)
        cand = (
            jnp.where(active, res.best[0], int_min),
            jnp.where(active, res.best[1], 0),
            jnp.where(active, res.best[2], 0),
        )
        best = _merge_best(best, cand)
        at_mn = jnp.maximum(at_mn, jnp.where(active, res.at_mn, int_min))
        top_recv = jax.lax.ppermute(res.bottom, axis_name, perm)

    # Collective merges over the seq axis.
    score = jax.lax.pmax(at_mn, axis_name)
    bv = jax.lax.pmax(best[0], axis_name)
    bi = jax.lax.pmax(
        jnp.where(best[0] == bv, best[1], -1), axis_name
    )
    bj = jax.lax.pmax(
        jnp.where((best[0] == bv) & (best[1] == bi), best[2], -1),
        axis_name,
    )
    if emit_ckpt:
        idx = p + jnp.arange(C, dtype=jnp.int32)
        tops_dev = jnp.take(jnp.stack(top_steps), idx, axis=0)
        lefts_dev = jnp.take(jnp.stack(left_steps), idx, axis=0)
        return ShardedFill(
            score=score,
            best=jnp.stack([bv, bi, bj]),
            tops=tops_dev,
            lefts=lefts_dev,
        )
    return LongSeqResult(
        score=score, best=jnp.stack([bv, bi, bj])
    )


def batched_sharded_scores(
    mesh: jax.sharding.Mesh,
    s1b,
    s2b,
    ms,
    ns,
    scores: Scores,
    is_local: bool = False,
    data_axis: str = "data",
    seq_axis: str = SEQ_AXIS,
    n_blocks: int | None = None,
    engine: str = "auto",
) -> LongSeqResult:
    """2-D (data x seq) sharding: pairs over ``data``, each pair's DP
    rows over ``seq`` — composed data- and sequence-parallelism.

    s1b: (Batch, Lm) with Batch divisible by the data-axis size and Lm
    by the seq-axis size; s2b: (Batch, Ln); ms/ns: (Batch,).
    """
    resolve_engine(engine)
    C = n_blocks or mesh.shape[seq_axis]
    fn = _batched_sharded_fn(
        mesh, data_axis, seq_axis, C, is_local, scores.as_tuple()
    )
    return fn(
        s1b,
        s2b,
        jnp.asarray(ms, jnp.int32),
        jnp.asarray(ns, jnp.int32),
    )


@functools.lru_cache(maxsize=64)
def _batched_sharded_fn(
    mesh, data_axis, seq_axis, C, is_local, scores_tuple
):
    """Cached jitted builder (see ``_sharded_fn`` for why)."""
    scores = Scores(*scores_tuple)

    def shard_fn(s1_blk, s2_blk, ms_blk, ns_blk):
        core = partial(
            _seq_core,
            scores=scores,
            is_local=is_local,
            axis_name=seq_axis,
            n_blocks=C,
            vma_axes=(data_axis, seq_axis),
        )
        return jax.vmap(core)(s1_blk, s2_blk, ms_blk, ns_blk)

    return jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                P(data_axis, seq_axis),
                P(data_axis),
                P(data_axis),
                P(data_axis),
            ),
            out_specs=LongSeqResult(score=P(data_axis), best=P(data_axis)),
        )
    )


def sharded_gotoh_score(
    mesh: jax.sharding.Mesh,
    s1e,
    s2e,
    m,
    n,
    scores: Scores,
    is_local: bool = False,
    axis_name: str = SEQ_AXIS,
    n_blocks: int | None = None,
    engine: str = "auto",
) -> LongSeqResult:
    """Score one (long) pair with rows sharded over ``axis_name``.

    ``s1e`` length must be divisible by the axis size; ``s2e`` length
    by ``n_blocks`` (defaults to the axis size). Pad with
    ``PAD_S1``/``PAD_S2`` and pass true lengths in ``m``/``n``.
    """
    resolve_engine(engine)
    P_ = mesh.shape[axis_name]
    C = n_blocks or P_
    m = jnp.asarray(m, jnp.int32)
    n = jnp.asarray(n, jnp.int32)

    fn = _sharded_fn(mesh, axis_name, C, is_local, scores.as_tuple())
    return fn(s1e, s2e, m, n)


@functools.lru_cache(maxsize=64)
def _sharded_fn(mesh, axis_name, C, is_local, scores_tuple):
    """Build-and-cache the jitted sharded pipeline.

    Rebuilding ``shard_map`` per call would re-trace and re-lower the
    whole pipeline on every invocation. The cache key is the static
    configuration; arrays flow through the jitted callee.
    """
    scores = Scores(*scores_tuple)
    return jax.jit(
        jax.shard_map(
            partial(
                _seq_core,
                scores=scores,
                is_local=is_local,
                axis_name=axis_name,
                n_blocks=C,
                vma_axes=(axis_name,),
            ),
            mesh=mesh,
            in_specs=(P(axis_name), P(), P(), P()),
            out_specs=LongSeqResult(score=P(), best=P()),
        )
    )


@functools.lru_cache(maxsize=64)
def _sharded_ckpt_fn(mesh, axis_name, C, is_local, scores_tuple):
    """Cached jitted checkpointing forward (see ``_sharded_fn``)."""
    scores = Scores(*scores_tuple)
    return jax.jit(
        jax.shard_map(
            partial(
                _seq_core,
                scores=scores,
                is_local=is_local,
                axis_name=axis_name,
                n_blocks=C,
                vma_axes=(axis_name,),
                emit_ckpt=True,
            ),
            mesh=mesh,
            in_specs=(P(axis_name), P(), P(), P()),
            out_specs=ShardedFill(
                score=P(),
                best=P(),
                tops=P(axis_name),
                lefts=P(axis_name),
            ),
        )
    )


def sharded_fill_checkpoints(
    mesh: jax.sharding.Mesh,
    s1e,
    s2e,
    m,
    n,
    scores: Scores,
    is_local: bool = False,
    axis_name: str = SEQ_AXIS,
    n_blocks: int | None = None,
    engine: str = "auto",
) -> ShardedFill:
    """The checkpointing sharded forward under ``align_sharded``.

    Same contract as :func:`sharded_gotoh_score` plus per-tile entry
    boundary captures (``ShardedFill.tops``/``lefts``).
    """
    resolve_engine(engine)
    P_ = mesh.shape[axis_name]
    C = n_blocks or P_
    fn = _sharded_ckpt_fn(mesh, axis_name, C, is_local, scores.as_tuple())
    return fn(
        s1e, s2e, jnp.asarray(m, jnp.int32), jnp.asarray(n, jnp.int32)
    )


@functools.partial(jax.jit, static_argnames=("is_local",))
def _window_dirs(s1_rows, s2_win, top, left, scores, is_local, i0, j0):
    """Packed dirs of one traceback window (rows i0..i0+R, columns
    j0..j0+Bt of the table) refilled from its captured boundaries."""
    big = jnp.int32(1 << 30)  # no (m, n) probe inside a window
    return tile_fill(
        s1_rows, s2_win, top, left, scores, is_local, i0, j0, big, big,
        emit_dirs=True,
    ).dirs


def _refill_and_walk_shard(
    s1_rows,
    s2_win,
    top_w,
    left_col,
    i0: int,
    jc: int,
    i: int,
    j: int,
    scores: Scores,
    is_local: bool,
):
    """Refill one row-shard's traceback window and walk it from the
    global cell (i, j). Returns ``(codes, i, j, done)`` with (i, j)
    global: done, an upward exit (i < i0) or a left exit (j == jc)."""
    import numpy as np

    from genomics_rs_tpu.ops.traceback_device import device_walk

    R = int(np.shape(s1_rows)[0])
    Bt = int(np.shape(s2_win)[0])
    left = (
        jnp.asarray(left_col, jnp.int32)
        if jc > 0
        else global_boundary_left(i0, R, scores)
    )
    dirs = _window_dirs(
        s1_rows,
        s2_win,
        jnp.asarray(top_w, jnp.int32),
        left,
        scores,
        is_local,
        np.int32(i0),
        np.int32(jc),
    )
    codes, i_f, j_f, done = device_walk(
        dirs,
        np.int32(i - i0),
        np.int32(j - jc),
        np.int32(i0),
        max_steps=R + Bt + 1,
        j0=jc,
    )
    i_f, j_f = int(i_f), int(j_f) + jc
    if not bool(done) and i_f >= i0 and not (j_f == jc and jc > 0):
        raise RuntimeError(f"sharded traceback stalled at ({i_f}, {j_f})")
    return np.asarray(codes), i_f, j_f, bool(done)


def align_sharded(
    mesh: jax.sharding.Mesh,
    seq1,
    seq2,
    scores: Scores,
    is_local: bool = False,
    axis_name: str = SEQ_AXIS,
    n_blocks: int | None = None,
    engine: str = "auto",
):
    """FULL alignment (path + stats) of one long pair with its DP rows
    sharded over ``axis_name`` (module docstring). Bit-identical to
    the single-device :class:`~genomics_rs_tpu.models.aligner.
    PairwiseAligner`.

    The forward is the collective tile pipeline
    (:func:`sharded_fill_checkpoints`); the backward walks shard by
    shard through narrow windowed dirs refills seeded by the captured
    tile boundaries.
    """
    import numpy as np

    from genomics_rs_tpu.ops.traceback import classify_moves
    from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, round_up

    P_ = mesh.shape[axis_name]
    C = n_blocks or P_
    m, n = len(seq1), len(seq2)
    R = max(round_up(m, 128 * P_), 128 * P_) // P_
    Lm = R * P_
    Ln = max(round_up(n, 128 * C), 128 * C)
    B = Ln // C
    s1e = seq1.encoded(pad_to=Lm, pad_value=PAD_S1)
    s2e = seq2.encoded(pad_to=Ln, pad_value=PAD_S2)

    fill = sharded_fill_checkpoints(
        mesh, s1e, s2e, m, n, scores,
        is_local=is_local, axis_name=axis_name, n_blocks=C,
        engine=engine,
    )
    tops = np.asarray(fill.tops)  # (P*C, 3, B+1) host copies: cheap
    lefts = np.asarray(fill.lefts)  # (P*C, 3, R)
    if is_local:
        score, start_i, start_j = (int(x) for x in np.asarray(fill.best))
    else:
        score, start_i, start_j = int(fill.score), m, n

    # Full top row per shard: tile tops overlap by one column (tile
    # c's col B == tile c+1's col 0) — concatenate the first B of
    # each plus the final column.
    def shard_top_full(p: int) -> np.ndarray:
        parts = [tops[p * C + c][:, :B] for c in range(C)]
        parts.append(tops[p * C + C - 1][:, B:])
        return np.concatenate(parts, axis=1)  # (3, Ln+1)

    codes_all: list[np.ndarray] = []
    i, j = start_i, start_j
    done = i == 0 and j == 0
    shard = max(0, (i - 1) // R) if not done else 0
    top_cache: dict[int, np.ndarray] = {}
    while not done:
        i0 = shard * R
        jc = max(0, (j // B - 1) * B)
        Bt = min(Ln - jc, round_up(max(j - jc, 1), B))
        if shard not in top_cache:
            top_cache[shard] = shard_top_full(shard)
        top_w = top_cache[shard][:, jc : jc + Bt + 1]
        left_col = lefts[shard * C + jc // B]
        codes, i, j, term = _refill_and_walk_shard(
            s1e[i0 : i0 + R],
            s2e[jc : jc + Bt],
            top_w,
            left_col,
            i0,
            jc,
            i,
            j,
            scores,
            is_local,
        )
        codes_all.append(codes)
        if term:
            break
        if i < i0:
            if shard == 0:
                raise RuntimeError(
                    f"sharded traceback left shard 0 at ({i}, {j})"
                )
            shard -= 1
        elif j == jc and jc > 0:
            pass  # left exit: loop recomputes a wider window
        elif j <= jc and jc == 0:
            raise RuntimeError(
                f"sharded traceback hit the left edge at ({i}, {j})"
            )

    all_codes = (
        np.concatenate(codes_all) if codes_all else np.zeros(0, np.uint8)
    )
    return classify_moves(
        all_codes, start_i, start_j, score, seq1, seq2
    )
