"""Batched device traceback + vectorized classification for reads.

The read-mapping driver (``models/reads.py``) needs thousands of full
tracebacks per batch. Walking each read's direction bitmap with the
per-pair host walker (``ops/traceback.traceback_host``) costs a Python
iteration per *move* — at 16k reads x ~300 moves that is millions of
interpreter steps, dwarfing the device fill. This module keeps the
whole batch on device and in numpy:

* :func:`walk_batch` — ONE ``lax.scan`` walks every read in lockstep
  (state = (i, j, done) per read; one batched gather per step), with
  the reference movement semantics of ``traceback_device.walk_block``
  (per-axis saturation, stop codes, done at (0, 0) —
  ``/root/reference/src/alignment/algo.rs:339-421``). Because a read's
  path has at most m+n moves, ``L1 + L2`` steps always terminate: no
  resume loop.
* :func:`classify_batch` — the per-move classification quirks
  (``is_match`` off-by-one with None==None, open-vs-extend via
  ``last_choice`` — ``algo.rs:351-399``, SURVEY §2.4-5) as whole-batch
  numpy: positions by cumulative sums (exact because a saturating axis
  only receives codes that no longer move it), match tests against
  sentinel-extended byte arrays, gap opens by comparing each gap move
  with its predecessor.

Two direction-code layouts are supported (static ``layout``):

* ``"diag"`` — per-read diag-major uint8 cells ``dirs[b, i+j, i]``
  (what ``gotoh_fill_scan`` emits under ``vmap``); boundary rows/cols
  are present in the table.
* ``"diag16"`` — per-pair diag-major PACKED words ``codes[b, (i+j)//16,
  i]`` (16 codes per int32, ``gotoh_scan.pack_dirs``); boundary cells
  are present. A quarter of the bytes of ``"diag"``.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from genomics_rs_tpu.ops.gotoh_scan import (
    DIR_DEL,
    DIR_INS,
    DIR_STOP,
    DIR_SUB,
)
from genomics_rs_tpu.ops.traceback import AlignedSequences, AlignmentChoice
from genomics_rs_tpu.sequence import Sequence

#: per-step output for "no move recorded" (walk finished or stop).
NO_MOVE = 255


@functools.partial(
    jax.jit,
    static_argnames=("layout", "max_steps", "packed_moves"),
)
def walk_batch(
    codes: jax.Array,
    start_i: jax.Array,
    start_j: jax.Array,
    layout: str,
    max_steps: int,
    packed_moves: bool = False,
):
    """Walk B tracebacks in lockstep on device.

    Args:
      codes: ``(B, K, Mp)`` uint8 for ``layout="diag"`` or
        ``(B, ceil(K/16), Mp)`` int32 packed words for
        ``layout="diag16"``.
      start_i/start_j: ``(B,)`` int32 retrace start cells.
      layout: static — see module docstring.
      max_steps: static scan length; must be >= the longest possible
        path (L1 + L2 suffices).

    Returns ``(moves, counts, i_f, j_f, done)``: moves ``(B,
    max_steps)`` uint8 move codes padded with :data:`NO_MOVE`, counts
    ``(B,)`` int32 true path lengths, final cells, and the done flag
    (False only if a walk neither reached (0, 0) nor a stop code; a
    global walk that ends anywhere but (0, 0) is a bug the caller
    checks for).
    """
    if layout not in ("diag", "diag16"):
        raise ValueError(f"unknown layout {layout!r}")
    B = codes.shape[0]
    _, K, Mp = codes.shape
    flat = codes.reshape(B, K * Mp)

    def read_code(i, j):
        if layout == "diag":
            idx = (i + j) * Mp + i
            return jax.vmap(lambda f, x: f[x])(flat, idx).astype(jnp.int32)
        k = i + j
        idx = (k // 16) * Mp + i
        word = jax.vmap(lambda f, x: f[x])(flat, idx)
        return ((word >> (2 * (k % 16))) & 3).astype(jnp.int32)

    def step(st, _):
        i, j, pos, done = st
        code = read_code(i, j)
        is_stop = code == DIR_STOP
        live = ~done
        rec = live & ~is_stop
        di = jnp.where(code == DIR_INS, 0, 1)
        dj = jnp.where(code == DIR_DEL, 0, 1)
        i_new = jnp.where(rec, jnp.maximum(i - di, 0), i)
        j_new = jnp.where(rec, jnp.maximum(j - dj, 0), j)
        done_new = done | (live & is_stop) | (
            rec & (i_new == 0) & (j_new == 0)
        )
        emit = jnp.where(rec, code, NO_MOVE).astype(jnp.uint8)
        return (
            i_new,
            j_new,
            pos + rec.astype(jnp.int32),
            done_new,
        ), emit

    init = (
        jnp.asarray(start_i, jnp.int32).reshape(B),
        jnp.asarray(start_j, jnp.int32).reshape(B),
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, bool),
    )
    (i_f, j_f, counts, done), moves = jax.lax.scan(
        step, init, None, length=max_steps
    )
    if packed_moves:
        # 4 codes per byte for the D2H transfer (the move matrix
        # dominates the read pipeline's harvest). True codes are
        # 0..2; NO_MOVE packs to 3, which the host unpack/classify treats identically (it
        # matches no move kind and sits beyond ``counts`` anyway).
        T4 = -(-max_steps // 4) * 4
        mp = jnp.pad(
            moves, ((0, T4 - max_steps), (0, 0)),
            constant_values=NO_MOVE,
        )
        mp = (mp & 3).reshape(T4 // 4, 4, B)
        packed = (
            mp[:, 0] | (mp[:, 1] << 2) | (mp[:, 2] << 4)
            | (mp[:, 3] << 6)
        )
        return packed.T, counts, i_f, j_f, done
    return moves.T, counts, i_f, j_f, done


def unpack_moves4(
    packed: np.ndarray, T: int, counts: np.ndarray | None = None
) -> np.ndarray:
    """Host unpack of ``walk_batch(packed_moves=True)`` output:
    (B, ceil(T/4)) bytes -> (B, T) uint8 codes (0..3).

    Caution: packing maps :data:`NO_MOVE` (255) to ``255 & 3 == 3``,
    which collides with ``DIR_STOP`` — positions at or beyond a walk's
    true move count unpack as phantom stop codes. Pass ``counts``
    (``walk_batch``'s per-walk counts) to rewrite that padding back to
    ``NO_MOVE``; callers that mask by counts themselves may omit it.
    """
    packed = np.asarray(packed)
    B, P = packed.shape
    out = np.empty((B, P, 4), np.uint8)
    for s in range(4):
        out[:, :, s] = (packed >> (2 * s)) & 3
    codes = out.reshape(B, P * 4)[:, :T]
    if counts is not None:
        pad = (
            np.arange(T, dtype=np.int64)[None, :]
            >= np.asarray(counts).reshape(B, 1)
        )
        codes = np.where(pad, np.uint8(NO_MOVE), codes)
    return codes


#: CIGAR op characters by numeric run code (0 = padding, dropped).
_CIG_CHARS = np.array(["", "M", "I", "D"])


def _batch_cigars(cigc: np.ndarray, counts: np.ndarray) -> list[str]:
    """Run-length encode every read's CIGAR in one pass.

    ``cigc`` (B, T) uint8 numeric op codes in *traceback* order
    (1 = M, 2 = I, 3 = D, 0 past the path end); emitted strings are
    start-of-alignment first. One global change-point scan over the
    zero-separated reversed batch replaces per-read-per-run Python
    formatting (the dominant classify cost at read scale).
    """
    B, T = cigc.shape
    if T == 0 or B == 0:
        return [""] * B
    ridx = counts[:, None] - 1 - np.arange(T)[None, :]
    revc = np.where(
        ridx >= 0,
        np.take_along_axis(cigc, np.clip(ridx, 0, T - 1), 1),
        0,
    )
    # A zero column separates consecutive reads in the flat view.
    revz = np.concatenate([revc, np.zeros((B, 1), cigc.dtype)], 1).ravel()
    chg = np.flatnonzero(revz[1:] != revz[:-1]) + 1
    bounds = np.concatenate([[0], chg, [revz.size]])
    vals = revz[bounds[:-1]]
    keep = vals != 0
    starts_f = bounds[:-1][keep]
    runlens = np.diff(bounds)[keep]
    rid = starts_f // (T + 1)
    chunks = np.char.add(
        runlens.astype("U10"), _CIG_CHARS[vals[keep]]
    ).tolist()
    lo = np.searchsorted(rid, np.arange(B))
    hi = np.searchsorted(rid, np.arange(B), side="right")
    return ["".join(chunks[a:b]) for a, b in zip(lo, hi)]


_CHOICE_BY_CODE = {
    0: AlignmentChoice.MATCH,
    1: AlignmentChoice.MISMATCH,
    2: AlignmentChoice.INSERT,
    3: AlignmentChoice.OPEN_INSERT,
    4: AlignmentChoice.DELETE,
    5: AlignmentChoice.OPEN_DELETE,
}


def classify_batch(
    moves: np.ndarray,
    counts: np.ndarray,
    start_i: np.ndarray,
    start_j: np.ndarray,
    scores_at_start: np.ndarray,
    queries: list[Sequence],
    refs: list[Sequence],
    with_paths: bool = True,
    encoded: tuple | None = None,
) -> tuple[list[AlignedSequences], list[str]]:
    """Classify every read's move list at once; returns
    ``(aligned_list, cigar_list)``.

    Replicates :func:`genomics_rs_tpu.ops.traceback.classify_moves`
    per read (same reference quirks) but with whole-batch numpy:
    moves ``(B, T)`` uint8 from :func:`walk_batch` (NO_MOVE padded).
    ``with_paths=False`` leaves each ``AlignedSequences.alignment``
    empty (stats and CIGARs only) — the per-read Python list is the
    one O(path) interpreter cost left.

    ``encoded=(s1b, s2b, ms, ns)`` — the padded encoded device batches
    the caller already built — lets the match test run on them
    directly (encoding is per-char bijective, so byte equality is
    preserved) instead of re-encoding every sequence in a Python loop;
    pad positions are masked to the shared past-the-end sentinel
    (None == None, algo.rs:354).
    """
    moves = np.asarray(moves)
    counts = np.asarray(counts)
    B, T = moves.shape
    # Work on the live prefix only: the move buffer is padded to the
    # worst-case path length (L1+L2+1) but real paths are ~read
    # length — the whole-batch (B, T) ops were ~4x too wide in the
    # mapper profile. Padding beyond counts.max() is NO_MOVE/masked,
    # so truncation is exact.
    if B and T:
        T_eff = int(counts.max())
        if T_eff < T:
            moves = moves[:, : max(T_eff, 1)]
            T = moves.shape[1]
    live = np.arange(T)[None, :] < counts[:, None]

    is_sub = (moves == DIR_SUB) & live
    is_ins = (moves == DIR_INS) & live
    is_del = (moves == DIR_DEL) & live

    # Positions: the cell each move is taken AT. Saturation never
    # disagrees with the cumsum (a clamped axis only ever sees codes
    # that do not move it — boundary rows emit INS, columns DEL).
    di = np.where(is_sub | is_del, 1, 0)
    dj = np.where(is_sub | is_ins, 1, 0)
    i_at = start_i[:, None] - np.cumsum(di, axis=1) + di
    j_at = start_j[:, None] - np.cumsum(dj, axis=1) + dj

    # Reference is_match at (i, j): byte equality with indexes PAST
    # the consumed base (off-by-one quirk, algo.rs:354) and None ==
    # None beyond both ends. Sentinels: 0x100 + side keeps "past end"
    # equal only to "past end" of the other side.
    if encoded is not None:
        s1b, s2b, ms, ns = (np.asarray(a) for a in encoded)

        def _sentineled(sb, lens):
            # One extra column keeps index == padded-length in range;
            # pad positions (>= true length) become the shared
            # past-the-end sentinel (encoded symbols are < 0x100).
            sx = np.concatenate(
                [
                    sb.astype(np.int32),
                    np.full((B, 1), 0x100, np.int32),
                ],
                axis=1,
            )
            live_cols = np.arange(sx.shape[1])[None, :] < lens[:, None]
            return np.where(live_cols, sx, 0x100)

        s1x = _sentineled(s1b, ms)
        s2x = _sentineled(s2b, ns)
    else:
        L1 = max((len(s) for s in queries), default=0)
        L2 = max((len(s) for s in refs), default=0)
        s1x = np.full((B, L1 + T + 2), 0x100, np.int32)
        s2x = np.full((B, L2 + T + 2), 0x100, np.int32)
        for b, (q, r) in enumerate(zip(queries, refs)):
            qb = np.frombuffer(q.sequence.encode("ascii"), np.uint8)
            rb = np.frombuffer(r.sequence.encode("ascii"), np.uint8)
            s1x[b, : len(qb)] = qb
            s2x[b, : len(rb)] = rb
    c1 = np.take_along_axis(s1x, np.clip(i_at, 0, s1x.shape[1] - 1), 1)
    c2 = np.take_along_axis(s2x, np.clip(j_at, 0, s2x.shape[1] - 1), 1)
    match = is_sub & (c1 == c2)
    mismatch = is_sub & ~(c1 == c2)

    # Open vs extend: a gap move opens unless the PREVIOUS move (in
    # traceback order) was the same gap kind — last_choice semantics
    # (algo.rs:372-399; after a SUB it is Match/Mismatch, so any gap
    # following a SUB opens).
    prev = np.concatenate(
        [np.full((B, 1), NO_MOVE, moves.dtype), moves[:, :-1]], axis=1
    )
    ins_open = is_ins & (prev != DIR_INS)
    del_open = is_del & (prev != DIR_DEL)

    matches = match.sum(1)
    mismatches = mismatch.sum(1)
    opening = (ins_open | del_open).sum(1)
    extensions = ((is_ins & ~ins_open) | (is_del & ~del_open)).sum(1)

    # Per-move choice codes for paths + CIGARs.
    choice = np.zeros((B, T), np.uint8)
    choice[mismatch] = 1
    choice[is_ins & ~ins_open] = 2
    choice[ins_open] = 3
    choice[is_del & ~del_open] = 4
    choice[del_open] = 5

    # CIGAR (query = s1): M consumes both; the DP DELETE move is a
    # gap in s2 (consumes only the query) = CIGAR I; INSERT = D.
    cigc = np.zeros((B, T), np.uint8)
    cigc[is_sub] = 1
    cigc[is_del] = 2
    cigc[is_ins] = 3
    cigars = _batch_cigars(cigc, counts)

    out: list[AlignedSequences] = []
    for b in range(B):
        cnt = int(counts[b])
        alignment: list[tuple[AlignmentChoice, int, int]] = []
        if with_paths and cnt:
            ch = choice[b, :cnt]
            ii = i_at[b, :cnt]
            jj = j_at[b, :cnt]
            alignment = [
                (_CHOICE_BY_CODE[int(c)], int(x), int(y))
                for c, x, y in zip(ch, ii, jj)
            ]
        out.append(
            AlignedSequences(
                s1=queries[b],
                s2=refs[b],
                alignment=alignment,
                score=int(scores_at_start[b]),
                matches=int(matches[b]),
                mismatches=int(mismatches[b]),
                gap_extensions=int(extensions[b]),
                opening_gaps=int(opening[b]),
            )
        )
    return out, cigars
