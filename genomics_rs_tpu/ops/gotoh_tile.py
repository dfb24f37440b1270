"""Boundary-injected Gotoh tile fill (anti-diagonal ``lax.scan``).

Fills the interior of one (R+1)x(B+1) DP tile given its top row and
left column boundary values, returning its bottom row, right column,
running argmax (in *global* table coordinates, with the reference's
last-row-major tie-break) and the value at a probed global cell
(m, n).

This is the composable unit behind:
* sequence-parallel long-sequence fills — tiles sharded over a mesh
  ``seq`` axis with ``ppermute`` halo exchange of boundary rows
  (``parallel/longseq.py``), the DP analog of context parallelism
  (SURVEY §5);
* the windowed traceback refills of the sharded aligner
  (``longseq.align_sharded``), with ``emit_dirs=True``.

Semantics (recurrence, zero-floor placement, tie-breaks) match the
full-table oracle ``gotoh_scan.py`` — which mirrors the reference
(``/root/reference/src/alignment/algo.rs:151-282``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.gotoh_scan import (
    DIR_DEL,
    DIR_INS,
    DIR_STOP,
    DIR_SUB,
    INT_MIN,
    NEG_INF,
    pack_dirs,
    vary,
)
from genomics_rs_tpu.ops.subst import (
    encode_chars,
    kimura_active,
    sentinel,
    sub_score,
)



class TileResult(NamedTuple):
    """bottom/right carry I/S/D stacked on axis 0 (order I, S, D).

    bottom: int32 (3, B+1) — row R of the tile, cols 0..B.
    right:  int32 (3, R)   — col B of the tile, rows 1..R.
    best:   (value, i_global, j_global) int32 — running argmax over
            every cell of the tile (boundaries included), reference
            tie-break (larger value, then larger i, then larger j).
    at_mn:  int32 — cell max at global (m, n) if it lies in this tile,
            else INT_MIN.
    dirs:   int32 (ceil((R+B+1)/16), R+1) packed direction codes of
            every tile cell, boundaries included (``gotoh_scan.
            pack_dirs`` layout; lane li = row i0+li, diagonal li+j for
            tile column j) when ``emit_dirs``, else None.
    """

    bottom: jax.Array
    right: jax.Array
    best: tuple[jax.Array, jax.Array, jax.Array]
    at_mn: jax.Array
    dirs: jax.Array | None = None


def _shift_down(x: jax.Array, fill) -> jax.Array:
    return jnp.concatenate([jnp.full((1,), fill, dtype=x.dtype), x[:-1]])


def tile_fill(
    s1t: jax.Array,
    s2t: jax.Array,
    top: jax.Array,
    left: jax.Array,
    scores: Scores,
    is_local: bool,
    i0: jax.Array,
    j0: jax.Array,
    m: jax.Array,
    n: jax.Array,
    vma_axes: tuple[str, ...] = (),
    emit_dirs: bool = False,
) -> TileResult:
    """Fill tile rows [i0+1, i0+R] x cols [j0+1, j0+B] of the table.

    Args:
      s1t: uint8[R] bases of rows i0+1..i0+R.
      s2t: uint8[B] bases of cols j0+1..j0+B.
      top: int32 (3, B+1) — I/S/D at row i0, cols j0..j0+B (element 0
        is the corner (i0, j0)).
      left: int32 (3, R) — I/S/D at col j0, rows i0+1..i0+R.
      scores: scoring pytree.
      is_local: static.
      i0, j0: global offsets (traced int32).
      m, n: true global lengths for masking / (m, n) probing.
      vma_axes: mesh axes this fill varies over inside a ``shard_map``
        (pcasts the scan inits so ``check_vma`` can stay enabled).
      emit_dirs: static — also return the tile's packed direction
        codes (``TileResult.dirs``) for a traceback walk; the codes of
        the boundary cells follow from the injected boundary values,
        so a walk can cross the tile's top row exactly as in the full
        table.
    """
    R = s1t.shape[0]
    B = s2t.shape[0]
    K = R + B + 1

    sm = jnp.int32(scores.s_match)
    sx = jnp.int32(scores.s_mismatch)
    g = jnp.int32(scores.g)
    h = jnp.int32(scores.h)
    st = (
        jnp.int32(scores.s_transition) if kimura_active(scores) else None
    )
    neg = jnp.int32(NEG_INF)
    int_min = jnp.int32(INT_MIN)
    zero_lane = jnp.int32(0) if is_local else neg

    iv = jnp.arange(R + 1, dtype=jnp.int32)
    s1m = jnp.concatenate(
        [
            jnp.full((1,), sentinel(0xFD, scores), dtype=jnp.int32),
            encode_chars(s1t, scores),
        ]
    )
    s2i = encode_chars(s2t, scores)
    topI, topS, topD = top[0], top[1], top[2]
    leftI, leftS, leftD = left[0], left[1], left[2]

    i0 = jnp.asarray(i0, jnp.int32)
    j0 = jnp.asarray(j0, jnp.int32)
    m = jnp.asarray(m, jnp.int32)
    n = jnp.asarray(n, jnp.int32)

    def step(carry, k):
        I1, S1, D1, I2, S2, D2, bv, bi, bk, at_mn = carry
        j = k - iv  # tile-local column per lane

        Iu, Su, Du = _shift_down(I1, neg), _shift_down(S1, neg), _shift_down(D1, neg)
        Id, Sd, Dd = _shift_down(I2, neg), _shift_down(S2, neg), _shift_down(D2, neg)

        Inew = jnp.maximum(
            jnp.maximum(I1 + g, S1 + h + g),
            jnp.maximum(D1 + h + g, zero_lane),
        )
        Dnew = jnp.maximum(
            jnp.maximum(Iu + h + g, Su + h + g),
            jnp.maximum(Du + g, zero_lane),
        )
        s2j = jnp.take(s2i, jnp.clip(k - 1 - iv, 0, B - 1))
        sub = sub_score(s1m, s2j, sm, sx, st)
        Snew = sub + jnp.maximum(
            jnp.maximum(Id, Sd), jnp.maximum(Dd, zero_lane)
        )

        # Boundary injection: lane 0 is the tile's top row (col j = k);
        # lane i == k is the tile's left column (row i, col 0).
        kc = jnp.clip(k, 0, B)
        Inew = jnp.where(iv == 0, jnp.take(topI, kc), Inew)
        Snew = jnp.where(iv == 0, jnp.take(topS, kc), Snew)
        Dnew = jnp.where(iv == 0, jnp.take(topD, kc), Dnew)
        kl = jnp.clip(k - 1, 0, R - 1)
        is_left = (j == 0) & (iv > 0)
        Inew = jnp.where(is_left, jnp.take(leftI, kl), Inew)
        Snew = jnp.where(is_left, jnp.take(leftS, kl), Snew)
        Dnew = jnp.where(is_left, jnp.take(leftD, kl), Dnew)
        invalid = (j < 0) | (j > B)
        Inew = jnp.where(invalid, neg, Inew)
        Snew = jnp.where(invalid, neg, Snew)
        Dnew = jnp.where(invalid, neg, Dnew)

        cm = jnp.maximum(jnp.maximum(Inew, Snew), Dnew)
        if is_local:
            cm = jnp.maximum(cm, 0)

        # Per-lane keep-last argmax over the true region (global coords).
        ig = i0 + iv
        jg = j0 + j
        in_true = (~invalid) & (ig <= m) & (jg >= 0) & (jg <= n)
        val = jnp.where(in_true, cm, int_min)
        upd = val >= bv
        bv = jnp.where(upd, val, bv)
        bi = jnp.where(upd, ig, bi)
        bk = jnp.where(upd, jg, bk)

        at_mn = jnp.maximum(
            at_mn,
            jnp.max(jnp.where((ig == m) & (jg == n) & (~invalid), cm, int_min)),
        )

        # Bottom-row (lane R) and right-col (lane k - B) samples.
        ys = (
            Inew[R],
            Snew[R],
            Dnew[R],
            jnp.take(Inew, jnp.clip(k - B, 0, R)),
            jnp.take(Snew, jnp.clip(k - B, 0, R)),
            jnp.take(Dnew, jnp.clip(k - B, 0, R)),
        )
        if emit_dirs:
            # Retrace code with the reference's S > I > D arm order,
            # as in gotoh_fill_scan.
            code = jnp.where(
                cm == Snew,
                DIR_SUB,
                jnp.where(
                    cm == Inew,
                    DIR_INS,
                    jnp.where(cm == Dnew, DIR_DEL, DIR_STOP),
                ),
            ).astype(jnp.uint8)
            ys = ys + (code,)
        carry = (Inew, Snew, Dnew, I1, S1, D1, bv, bi, bk, at_mn)
        return carry, ys

    init_vec = jnp.full((R + 1,), neg, dtype=jnp.int32)
    init = (
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        jnp.full((R + 1,), int_min, dtype=jnp.int32),
        jnp.zeros((R + 1,), dtype=jnp.int32),
        jnp.zeros((R + 1,), dtype=jnp.int32),
        int_min,
    )
    init = vary(init, vma_axes)
    carry, ys = jax.lax.scan(step, init, jnp.arange(K, dtype=jnp.int32))
    bv, bi, bk, at_mn = carry[6], carry[7], carry[8], carry[9]

    bI, bS, bD, rI, rS, rD = ys[:6]
    bottom = jnp.stack(
        [bI[R : R + B + 1], bS[R : R + B + 1], bD[R : R + B + 1]]
    )
    right = jnp.stack(
        [rI[B + 1 : B + R + 1], rS[B + 1 : B + R + 1], rD[B + 1 : B + R + 1]]
    )

    # Tile-level reduce with reference tie-break: larger value, then
    # larger global i, then larger global j.
    vmax = jnp.max(bv)
    i_best = jnp.max(jnp.where(bv == vmax, bi, -1))
    j_best = jnp.max(
        jnp.where((bv == vmax) & (bi == i_best), bk, -1)
    )
    return TileResult(
        bottom=bottom,
        right=right,
        best=(vmax, i_best, j_best),
        at_mn=at_mn,
        dirs=pack_dirs(ys[6]) if emit_dirs else None,
    )


def global_boundary_top(
    j0: jax.Array, B: int, scores: Scores
) -> jax.Array:
    """Row-0 boundary I/S/D for cols j0..j0+B ((3, B+1) int32).

    Matches the oracle's boundary: origin (0,0) = 0; row 0 has
    I = h + j*g, S = D = -inf (algo.rs:193-220).
    """
    g = jnp.int32(scores.g)
    h = jnp.int32(scores.h)
    neg = jnp.int32(NEG_INF)
    js = jnp.asarray(j0, jnp.int32) + jnp.arange(B + 1, dtype=jnp.int32)
    I = jnp.where(js == 0, 0, h + js * g)
    S = jnp.where(js == 0, 0, neg)
    D = jnp.where(js == 0, 0, neg)
    return jnp.stack([I, S, D])


def global_boundary_left(
    i0: jax.Array, R: int, scores: Scores
) -> jax.Array:
    """Col-0 boundary I/S/D for rows i0+1..i0+R ((3, R) int32)."""
    g = jnp.int32(scores.g)
    h = jnp.int32(scores.h)
    neg = jnp.int32(NEG_INF)
    i_ = jnp.asarray(i0, jnp.int32) + 1 + jnp.arange(R, dtype=jnp.int32)
    I = jnp.full((R,), neg, dtype=jnp.int32)
    S = jnp.full((R,), neg, dtype=jnp.int32)
    D = h + i_ * g
    return jnp.stack([I, S, D])
