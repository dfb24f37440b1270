"""Batched full-matrix (protein) Gotoh scoring: matmul + wavefront scan.

Full substitution matrices (BLOSUM etc.) break the two-value
``where(match, sm, sx)`` trick the DNA fills use: the score of a cell
is an arbitrary ``M[a, b]`` lookup. The batched formulation splits the
work in three:

1. **Substitution planes**: the whole substitution plane of a pair is
   two matmuls — ``subs = onehot(s1) @ (M @ onehot(s2)^T)`` — with
   bf16 operands and float32 accumulation. Every output element has
   exactly one nonzero product (a one-hot selection of a small-integer
   matrix entry), so the result is exact for ``|M| <= 256`` whatever
   precision the backend's matmul uses (guarded in
   :func:`gotoh_scores_matrix`).
2. **Relayout**: the (m, n) plane shears once into diagonal-major
   ``sheared[k, l] = subs[l-1, k-l-1]`` (bulk reshape copies).
3. **Wavefront**: the anti-diagonal Gotoh recurrence (identical
   semantics to ``gotoh_scan.gotoh_fill_scan`` — reference quirks
   included) runs as one ``lax.scan`` over ALL pairs at once, with
   each step's substitution scores arriving as a scan ``xs`` slice.

The reference has no analog (two-score model only,
``/root/reference/src/alignment/algo.rs:245-248``). Cross-checked
against the scan oracle's ``subst_lut`` gather path and the C++ LUT
oracle (``native/gotoh_cpu.cpp::gotoh_score_cpu_subst``).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from genomics_rs_tpu.ops.gotoh_scan import INT_MIN, NEG_INF


def _alpha_code(matrix) -> np.ndarray:
    """(256,) int32: byte -> alphabet index; unknown bytes -> the
    wildcard index (``X``) when present, else an extra row scored as
    the matrix minimum (matches ``SubstMatrix.byte_lut`` semantics)."""
    A = len(matrix.alphabet)
    fallback = (
        matrix.alphabet.index("X") if "X" in matrix.alphabet else A
    )
    idx = np.full(256, fallback, dtype=np.int32)
    for i, ch in enumerate(matrix.alphabet):
        idx[ord(ch)] = i
    return idx


def _ext_matrix(matrix) -> np.ndarray:
    """Matrix extended with the unknown-byte row/col when needed."""
    A = len(matrix.alphabet)
    if "X" in matrix.alphabet:
        return np.asarray(matrix.matrix, dtype=np.int32)
    lo = int(matrix.matrix.min())
    ext = np.full((A + 1, A + 1), lo, dtype=np.int32)
    ext[:A, :A] = matrix.matrix
    return ext


def _sheared_subs(s1b, s2b, code, mat, A: int):
    """(K, B, Mp) int32 diagonal-major substitution scores.

    Matmul substitution planes + skew-by-reshape; see module docstring.
    One tiny gather per CHARACTER (not per cell) maps bytes to
    alphabet codes; the plane itself is two exact bf16 matmuls.
    Out-of-range positions read zero padding or a neighbouring row's
    tail — bounded values at cells the DP masks as boundary/invalid/
    beyond-true-length. (A vmapped dynamic-slice shear prototyped
    first was pure gather and dominated the runtime; this is bulk
    copies only.)
    """
    B, Lm = s1b.shape
    _, Ln = s2b.shape
    Mp = Lm + 1
    K = Lm + Ln + 1
    c1 = jnp.take(code, s1b.astype(jnp.int32))  # (B, Lm)
    c2 = jnp.take(code, s2b.astype(jnp.int32))  # (B, Ln)
    oh1 = (
        c1[:, :, None] == jnp.arange(A, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.bfloat16)  # (B, Lm, A)
    oh2 = (
        c2[:, :, None] == jnp.arange(A, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.bfloat16)  # (B, Ln, A)
    # One nonzero product per output element: exact in float32
    # accumulation (and in the bf16 re-cast, |M| <= 256).
    rows = jnp.einsum(
        "bma,ac->bmc",
        oh1,
        mat.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ).astype(jnp.bfloat16)  # (B, Lm, A): row of M for each s1 char
    subs = jnp.einsum(
        "bmc,bnc->bmn", rows, oh2, preferred_element_type=jnp.float32
    ).astype(jnp.int32)

    # Shear: sheared[k, b, l] = subs[b, l-1, k-l-1] via pad rows to
    # width Ln+Mp, flatten, truncate one element per row, reshape —
    # Q[b, r, c] = P[b, r, c-r] — then one bulk transpose.
    Wp = Ln + Mp
    P = jnp.concatenate(
        [subs, jnp.zeros((B, Lm, Wp - Ln), dtype=jnp.int32)], axis=2
    )
    Q = (
        P.reshape(B, Lm * Wp)[:, : Lm * (Wp - 1)]
        .reshape(B, Lm, Wp - 1)
    )  # Q[b, r, c] = P[b, r, c - r]
    T = jnp.transpose(Q, (2, 0, 1))  # (Wp-1, B, Lm): T[c, b, r]
    # sheared[k, b, l] = T[k-2, b, l-1]: two leading diagonals and one
    # leading lane of padding, then trim/pad to (K, B, Mp).
    return jnp.pad(
        T,
        ((2, max(0, K - (Wp - 1) - 2)), (0, 0), (1, 0)),
    )[:K]


@functools.partial(
    jax.jit, static_argnames=("is_local", "A")
)
def _matrix_scores_call(
    s1b: jax.Array,  # (B, Lm) uint8 ASCII
    s2b: jax.Array,  # (B, Ln) uint8
    ms: jax.Array,  # (B,) true lengths
    ns: jax.Array,
    g: jax.Array,  # gap extension (traced int32 scalar)
    h: jax.Array,  # gap open
    code: jax.Array,  # (256,) byte -> alphabet index
    mat: jax.Array,  # (A, A) int32 scores
    is_local: bool,
    A: int,
):
    B, Lm = s1b.shape
    _, Ln = s2b.shape
    Mp = Lm + 1
    K = Lm + Ln + 1

    g = jnp.int32(g)
    h = jnp.int32(h)
    neg = jnp.int32(NEG_INF)
    int_min = jnp.int32(INT_MIN)

    sheared = _sheared_subs(s1b, s2b, code, mat, A)

    # Batched wavefront.
    iv = jnp.arange(Mp, dtype=jnp.int32)[None, :]  # (1, Mp)
    msr = jnp.asarray(ms, jnp.int32)[:, None]
    nsr = jnp.asarray(ns, jnp.int32)[:, None]
    zero_lane = jnp.int32(0) if is_local else neg

    def shift_down(x):
        return jnp.concatenate(
            [jnp.full((B, 1), neg, dtype=x.dtype), x[:, :-1]], axis=1
        )

    def step(carry, xs):
        I1, S1, D1, I2, S2, D2, best, final = carry
        k, sub_k = xs  # sub_k: (B, Mp)
        j = k - iv  # (1, Mp) broadcast to (B, Mp)

        Iu, Su, Du = shift_down(I1), shift_down(S1), shift_down(D1)
        Id, Sd, Dd = shift_down(I2), shift_down(S2), shift_down(D2)

        Inew = jnp.maximum(
            jnp.maximum(I1 + g, S1 + h + g),
            jnp.maximum(D1 + h + g, zero_lane),
        )
        Dnew = jnp.maximum(
            jnp.maximum(Iu + h + g, Su + h + g),
            jnp.maximum(Du + g, zero_lane),
        )
        Snew = sub_k + jnp.maximum(
            jnp.maximum(Id, Sd), jnp.maximum(Dd, zero_lane)
        )

        is_origin = (iv == 0) & (j == 0)
        is_row0 = (iv == 0) & (j > 0)
        is_col0 = (j == 0) & (iv > 0)
        invalid = (j < 0) | (j > Ln)

        Inew = jnp.where(is_row0, h + j * g, Inew)
        Inew = jnp.where(is_col0 | invalid, neg, Inew)
        Dnew = jnp.where(is_col0, h + iv * g, Dnew)
        Dnew = jnp.where(is_row0 | invalid, neg, Dnew)
        Snew = jnp.where(is_row0 | is_col0 | invalid, neg, Snew)
        Inew = jnp.where(is_origin, 0, Inew)
        Dnew = jnp.where(is_origin, 0, Dnew)
        Snew = jnp.where(is_origin, 0, Snew)

        cm = jnp.maximum(jnp.maximum(Inew, Snew), Dnew)
        if is_local:
            cm = jnp.maximum(cm, 0)

            # Reference keep-last row-major argmax (algo.rs:311-322);
            # global mode starts at (m, n) and skips the tracker's
            # ~6 reduction passes per step entirely.
            bv, bi, bj = best
            in_true = (iv <= msr) & (j >= 0) & (j <= nsr)
            val = jnp.where(in_true, cm, int_min)
            vmax = jnp.max(val, axis=1)
            i_cand = jnp.max(
                jnp.where(val == vmax[:, None], iv, -1), axis=1
            )
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
        else:
            # Masked max instead of take_along_axis: select+reduce
            # fuses into the step's elementwise body.
            at_mn = jnp.max(
                jnp.where(iv == msr, cm, int_min), axis=1
            )
            final = jnp.where(k == (msr + nsr)[:, 0], at_mn, final)
        return (Inew, Snew, Dnew, I1, S1, D1, best, final), None

    init_vec = jnp.full((B, Mp), neg, dtype=jnp.int32)
    init = (
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        init_vec,
        (
            jnp.full((B,), int_min, jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32),
        ),
        jnp.full((B,), int_min, jnp.int32),
    )
    carry, _ = jax.lax.scan(
        step, init, (jnp.arange(K, dtype=jnp.int32), sheared)
    )
    bv, bi, bj = carry[6]
    final = carry[7]
    if is_local:
        return bv, bi, bj
    return final, jnp.asarray(ms, jnp.int32), jnp.asarray(ns, jnp.int32)


def gotoh_scores_matrix(
    s1b,
    s2b,
    ms,
    ns,
    matrix,
    g: int,
    h: int,
    is_local: bool = False,
):
    """Score a batch of pairs under a full substitution matrix.

    Args:
      s1b, s2b: (B, Lm)/(B, Ln) uint8 ASCII byte arrays (padded; pad
        bytes are irrelevant — masked by the true lengths).
      ms, ns: (B,) true lengths.
      matrix: a ``SubstMatrix`` (e.g. ``subst.blosum62()``).
      g, h: affine gap extension / open costs.
      is_local: Smith-Waterman (True) / Needleman-Wunsch.

    Returns ``(score, start_i, start_j)`` of shape (B,) with the
    reference's exact local keep-last argmax semantics.
    """
    code = jnp.asarray(_alpha_code(matrix))
    ext = _ext_matrix(matrix)
    A = int(ext.shape[0])
    if isinstance(s1b, np.ndarray) and isinstance(s2b, np.ndarray):
        # Host-side inputs: cheap to check that the batch is mostly
        # in-alphabet (lowercase protein letters silently score as X
        # otherwise). Pad bytes are excluded via the true lengths.
        from genomics_rs_tpu.ops.subst import warn_unknown_bytes

        ms_np = np.asarray(ms)
        ns_np = np.asarray(ns)
        live = np.concatenate(
            [s1b[i, : ms_np[i]] for i in range(s1b.shape[0])]
            + [s2b[i, : ns_np[i]] for i in range(s2b.shape[0])]
        )
        warn_unknown_bytes(matrix, live, where="matrix batch")
    if int(np.abs(ext).max()) > 256:
        # The substitution planes are one-hot matmuls over bf16
        # operands; bf16 integers are exact only to 256 — larger
        # entries would be silently rounded. Real matrices (BLOSUM/PAM
        # families) are far below this.
        raise ValueError(
            "substitution-matrix entries must satisfy |v| <= 256 "
            f"(bf16-exact one-hot selection); got max |v| = "
            f"{int(np.abs(ext).max())}"
        )
    return _matrix_scores_call(
        jnp.asarray(s1b),
        jnp.asarray(s2b),
        jnp.asarray(ms, jnp.int32),
        jnp.asarray(ns, jnp.int32),
        int(g),
        int(h),
        code,
        jnp.asarray(ext),
        is_local,
        A=A,
    )
