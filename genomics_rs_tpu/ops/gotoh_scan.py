"""Anti-diagonal (wavefront) Gotoh fill as a plain-JAX ``lax.scan``.

This is the reference/oracle implementation of the three-matrix affine
gap DP (I/S/D = insert/substitute/delete) — semantics match the Rust
reference (``/root/reference/src/alignment/algo.rs:151-282``) exactly,
including its quirks (SURVEY §2.4):

* local mode injects a raw ``0`` lane inside *every* predecessor max
  (``algo.rs:103``), so I and D are >= 0 at every interior cell;
* I<->D cross-transitions are allowed at gap-open cost
  (``algo.rs:231-243``);
* the local traceback start is the *last* argmax in row-major
  iteration order (``algo.rs:311-322``), while scanning the full
  (m+1)x(n+1) table including boundary cells;
* boundary rows use offset "-inf" (we use ``-2**30`` in int32; the
  reference uses ``i64::MIN + |g+h|``, ``algo.rs:166`` — scores on any
  real path are tiny so int32 is exact for everything observable).

Instead of materialising 48 B/cell like the reference (43 GB for one
30 kb pair), we emit one 2-bit direction code per cell, diag-major:
``dirs[k, i]`` is the retrace move at cell ``(i, j=k-i)``:

    0 = substitute (diagonal), 1 = insert (left), 2 = delete (up),
    3 = stop (local zero-cell / padding)

The code ordering encodes the reference's retrace tie-break priority
S > I > D (``algo.rs:351-399``) so the traceback is a pure pointer
chase.

The table is computed over *padded* shapes (static for jit); true
lengths ``(m, n)`` are traced scalars. Cells outside the true region
are garbage but unreachable: DP dependencies only flow down-right, and
argmax/score extraction are masked to the true region.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.subst import (
    encode_chars,
    kimura_active,
    sentinel,
    sub_score,
)

#: "-infinity" for int32 score lanes; adding g/h/s_mismatch keeps it
#: far above INT32_MIN (no overflow) and far below any real score.
NEG_INF = -(1 << 30)

#: Sentinel for "no value yet" in argmax trackers (below NEG_INF so a
#: boundary cell always beats it). Single definition shared by every
#: kernel and driver so cross-module comparisons stay coherent.
INT_MIN = -(1 << 31)

# Direction codes (retrace priority order S > I > D, then stop).
DIR_SUB = 0
DIR_INS = 1
DIR_DEL = 2
DIR_STOP = 3


#: Direction codes per packed int32 word (2 bits each).
PACK = 16


def pack_dirs(dirs: jax.Array) -> jax.Array:
    """Pack diag-major uint8 codes ``(K, Mp)`` into int32 words
    ``(ceil(K/16), Mp)``: the code of diagonal k, lane i sits in bits
    ``2*(k % 16)`` of word ``[k // 16, i]`` — the layout the device
    walkers read (``traceback_device.walk_block``,
    ``traceback_batch.walk_batch(layout="diag16")``). Padding
    diagonals hold code 0 and are never reached by a walk."""
    K, Mp = dirs.shape
    Kp = -(-K // PACK) * PACK
    d = jnp.pad(dirs.astype(jnp.uint32), ((0, Kp - K), (0, 0)))
    shifts = (2 * jnp.arange(PACK, dtype=jnp.uint32))[None, :, None]
    # The 2-bit fields are disjoint, so the sum is a bitwise OR.
    words = jnp.sum(
        d.reshape(Kp // PACK, PACK, Mp) << shifts,
        axis=1,
        dtype=jnp.uint32,
    )
    return jax.lax.bitcast_convert_type(words, jnp.int32)


class FillResult(NamedTuple):
    """Output of a wavefront fill.

    dirs:    uint8[(Lm+Ln+1, Lm+1)] — 2-bit move code per cell, diag-major
             (``dirs[i+j, i]`` = code at table cell (i, j)).
    score:   int32 — score at the retrace start cell
             (= ``score_max(0,0,0,is_local)`` there).
    start_i: int32 — retrace start row (m for global, argmax for local).
    start_j: int32 — retrace start col.
    """

    dirs: jax.Array
    score: jax.Array
    start_i: jax.Array
    start_j: jax.Array


def _shift_down(x: jax.Array, fill: int = NEG_INF) -> jax.Array:
    """y[i] = x[i-1]; y[0] = fill.  (Maps diag index i -> i-1.)"""
    return jnp.concatenate([jnp.full((1,), fill, dtype=x.dtype), x[:-1]])


def vary(tree, axes: tuple[str, ...]):
    """pcast every leaf to varying over ``axes`` (no-op when empty).

    Scan carries whose inits are plain constants are *unvarying* under
    ``shard_map``'s varying-manual-axes (vma) typing while the body's
    outputs vary over the mesh axes; casting the inits keeps
    ``check_vma=True`` on (the static safety net) instead of disabling
    the check. Axes a leaf already varies over are skipped (pcast
    rejects re-varying)."""
    if not axes:
        return tree

    def cast(x):
        cur = getattr(jax.typeof(x), "vma", frozenset())
        missing = tuple(a for a in axes if a not in cur)
        return jax.lax.pcast(x, missing, to="varying") if missing else x

    return jax.tree.map(cast, tree)


def gotoh_fill_scan(
    s1e: jax.Array,
    s2e: jax.Array,
    m: jax.Array,
    n: jax.Array,
    scores: Scores,
    is_local: bool,
    emit_dirs: bool = True,
    vma_axes: tuple[str, ...] = (),
    subst_lut: jax.Array | None = None,
) -> FillResult:
    """Fill the (m+1)x(n+1) Gotoh table by anti-diagonals.

    Args:
      s1e: uint8[Lm] encoded (possibly padded) first sequence.
      s2e: uint8[Ln] encoded second sequence. Pad values of the two
        sequences must differ so padding never matches.
      m, n: true lengths (traced int32 scalars), m <= Lm, n <= Ln.
      scores: scoring pytree.
      is_local: static — Smith-Waterman (True) / Needleman-Wunsch.
      emit_dirs: static — when False, skip the per-cell direction
        bitmap entirely (score-only mode for batched/sharded scoring
        where O(m*n) traceback state would dominate memory);
        ``FillResult.dirs`` is then a (0, 0) placeholder.
      vma_axes: mesh axes this fill varies over when called inside a
        ``shard_map`` (see :func:`vary`); empty outside one.
      subst_lut: optional (256, 256) int32 byte-pair score table
        (``SubstMatrix.byte_lut()``) — full-matrix scoring (protein);
        overrides the match/mismatch/transition form entirely.
    """
    if subst_lut is not None and kimura_active(scores):
        raise ValueError(
            "subst_lut and scores.s_transition are mutually exclusive "
            "(a full matrix already fixes every pair's score)"
        )
    Lm = s1e.shape[0]
    Ln = s2e.shape[0]
    Mp = Lm + 1  # table rows
    Np = Ln + 1  # table cols
    K = Lm + Ln + 1  # number of anti-diagonals

    sm = jnp.int32(scores.s_match)
    sx = jnp.int32(scores.s_mismatch)
    g = jnp.int32(scores.g)
    h = jnp.int32(scores.h)
    st = (
        jnp.int32(scores.s_transition) if kimura_active(scores) else None
    )
    neg = jnp.int32(NEG_INF)
    int_min = jnp.iinfo(jnp.int32).min

    iv = jnp.arange(Mp, dtype=jnp.int32)
    # s1m[i] = s1[i-1] (the base consumed entering row i); index 0 unused.
    s1m = jnp.concatenate(
        [
            jnp.full((1,), sentinel(0xFD, scores), dtype=jnp.int32),
            encode_chars(s1e, scores),
        ]
    )
    s2i = encode_chars(s2e, scores)

    m = jnp.asarray(m, jnp.int32)
    n = jnp.asarray(n, jnp.int32)

    zero_lane = jnp.int32(0) if is_local else neg

    def step(carry, k):
        I1, S1, D1, I2, S2, D2, best, final_score = carry
        j = k - iv  # column of each lane's cell on this diagonal

        # Predecessors: (i, j-1) = diag k-1 same lane; (i-1, j) = diag
        # k-1 shifted; (i-1, j-1) = diag k-2 shifted.
        Iu, Su, Du = _shift_down(I1), _shift_down(S1), _shift_down(D1)
        Id, Sd, Dd = _shift_down(I2), _shift_down(S2), _shift_down(D2)

        # I(i,j): gap in s1, consumes s2[j-1]; from (i, j-1).
        Inew = jnp.maximum(
            jnp.maximum(I1 + g, S1 + h + g),
            jnp.maximum(D1 + h + g, zero_lane),
        )
        # D(i,j): gap in s2, consumes s1[i-1]; from (i-1, j).
        Dnew = jnp.maximum(
            jnp.maximum(Iu + h + g, Su + h + g),
            jnp.maximum(Du + g, zero_lane),
        )
        # S(i,j): substitution; zero-lane applies *before* adding the
        # match score (reference quirk — algo.rs:245-248).
        s2j = jnp.take(s2i, jnp.clip(k - 1 - iv, 0, Ln - 1))
        if subst_lut is not None:
            # Full-matrix scoring: one flat gather per lane (oracle
            # path only; chars stay raw bytes here).
            sub = jnp.take(
                subst_lut.reshape(-1), s1m * 256 + s2j
            )
        else:
            sub = sub_score(s1m, s2j, sm, sx, st)
        Snew = sub + jnp.maximum(
            jnp.maximum(Id, Sd), jnp.maximum(Dd, zero_lane)
        )

        # Boundary conditions (algo.rs:193-220).
        is_origin = (iv == 0) & (j == 0)
        is_row0 = (iv == 0) & (j > 0)
        is_col0 = (j == 0) & (iv > 0)
        invalid = (j < 0) | (j >= Np)

        Inew = jnp.where(is_row0, h + j * g, Inew)
        Inew = jnp.where(is_col0 | invalid, neg, Inew)
        Dnew = jnp.where(is_col0, h + iv * g, Dnew)
        Dnew = jnp.where(is_row0 | invalid, neg, Dnew)
        Snew = jnp.where(is_row0 | is_col0 | invalid, neg, Snew)
        Inew = jnp.where(is_origin, 0, Inew)
        Dnew = jnp.where(is_origin, 0, Dnew)
        Snew = jnp.where(is_origin, 0, Snew)

        # Cell max = score_max(0,0,0,is_local) and retrace move code
        # with the reference's S > I > D arm order (algo.rs:351-399).
        cm = jnp.maximum(jnp.maximum(Inew, Snew), Dnew)
        if is_local:
            cm = jnp.maximum(cm, 0)
        code = jnp.where(
            cm == Snew,
            DIR_SUB,
            jnp.where(cm == Inew, DIR_INS, jnp.where(cm == Dnew, DIR_DEL, DIR_STOP)),
        ).astype(jnp.uint8)

        # Track the last row-major argmax over the true region (local
        # start cell; indexed_iter().max_by keeps the *last* max —
        # algo.rs:311-322). Within a diagonal, larger i == later in
        # row-major order.
        bv, bi, bj = best
        in_true = (iv <= m) & (j >= 0) & (j <= n)
        val = jnp.where(in_true, cm, int_min)
        vmax = jnp.max(val)
        i_cand = jnp.max(jnp.where(val == vmax, iv, -1))
        j_cand = k - i_cand
        better = (vmax > int_min) & (
            (vmax > bv)
            | (
                (vmax == bv)
                & ((i_cand > bi) | ((i_cand == bi) & (j_cand > bj)))
            )
        )
        best = (
            jnp.where(better, vmax, bv),
            jnp.where(better, i_cand, bi),
            jnp.where(better, j_cand, bj),
        )

        # Global-mode final score: cell max at (m, n), on diagonal m+n.
        final_score = jnp.where(k == m + n, jnp.take(cm, m), final_score)

        carry = (Inew, Snew, Dnew, I1, S1, D1, best, final_score)
        return carry, (code if emit_dirs else None)

    init_vec = jnp.full((Mp,), neg, dtype=jnp.int32)
    init = (
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        (jnp.int32(int_min), jnp.int32(0), jnp.int32(0)),
        jnp.int32(int_min),
    )
    init = vary(init, vma_axes)
    carry, dirs = jax.lax.scan(step, init, jnp.arange(K, dtype=jnp.int32))
    (bv, bi, bj) = carry[6]
    final_score = carry[7]
    if not emit_dirs:
        dirs = jnp.zeros((0, 0), dtype=jnp.uint8)

    if is_local:
        return FillResult(dirs=dirs, score=bv, start_i=bi, start_j=bj)
    return FillResult(dirs=dirs, score=final_score, start_i=m, start_j=n)
