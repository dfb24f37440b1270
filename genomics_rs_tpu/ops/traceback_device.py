"""On-device traceback walk over a block's packed direction bitmap.

At 100 kb+ scale a block's direction bitmap is hundreds of MB — far
cheaper to chase the 2-bit codes on device (a ``lax.while_loop`` of
single-element gathers) and ship home only the O(m+n) move list than
to transfer the bitmap. Movement semantics replicate the reference
retrace (``/root/reference/src/alignment/algo.rs:339-421``): per-axis
saturation at 0, break when (0, 0) is reached after a move, local
termination on a stop code.

The bitmap is the packed layout of ``gotoh_scan.pack_dirs`` (what
``gotoh_tile.tile_fill(emit_dirs=True)`` emits); :func:`device_walk`
drives :func:`walk_block` to completion.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from genomics_rs_tpu.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_STOP


#: dependent walk steps per ``while_loop`` iteration. The walk is a
#: chain of single-word gathers whose per-move cost is dominated by
#: the loop-iteration overhead, not the gather itself — unrolling
#: amortizes that overhead.
UNROLL = 8


@functools.partial(jax.jit, static_argnames=("max_steps",))
def walk_block(
    dirs: jax.Array,
    start_li: jax.Array,
    start_j: jax.Array,
    i0: jax.Array,
    max_steps: int,
    j0: jax.Array = 0,
):
    """Chase codes from tile-local (start_li, start_j) until the path
    terminates or leaves the block upward.

    dirs: PACKED int32 (Kp/16, V) words (``gotoh_scan.pack_dirs``):
    the code at tile cell (li, j) is
    ``(dirs[(li+j) // 16, li] >> (2 * ((li+j) % 16))) & 3`` — walking
    the packed form directly keeps the refill bitmap 4x smaller.
    i0: global row of the tile's lane 0.

    ``j0``: global column of the bitmap's column 0 (a WINDOWED refill,
    round 4). ``start_j``/``j_final`` are then window-local; when a
    move lands on local column 0 with ``j0 > 0`` the walk exits LEFT
    (done=False, j_final=0, i_final >= i0) — the cell's code was not
    read; the caller resumes it inside a window extending further
    left. Global-origin termination only applies when ``j0 == 0``.

    Returns (moves uint8[max_steps], count, i_final, j_final, done):
    ``done`` means the walk terminated (reached global (0,0) or a
    local stop code); otherwise it exited the block (upward, or left
    for windowed bitmaps) and continues at (i_final, j_final).
    """
    i0 = jnp.asarray(i0, jnp.int32)
    j0 = jnp.asarray(j0, jnp.int32)

    def cond(st):
        li, j, pos, done, exited, moves = st
        return (~done) & (exited == 0) & (pos < max_steps)

    def substep(st):
        li, j, pos, done, exited, moves = st
        # Once halted, later unrolled substeps are identity (the
        # gather still executes with the frozen — valid — indices).
        halt = done | (exited != 0) | (pos >= max_steps)
        k = li + j
        if os.environ.get("GENOMICS_TPU_DEBUG"):
            # Invariant: the walk must never read outside the bitmap
            # (a padded lane / out-of-range diagonal would be silently
            # clamped by the gather and corrupt the path).
            oob = (~halt) & (
                (li < 0)
                | (li >= dirs.shape[1])
                | (k < 0)
                | (k // 16 >= dirs.shape[0])
            )
            jax.lax.cond(
                oob,
                lambda li=li, j=j, k=k: jax.debug.print(
                    "INVARIANT VIOLATION: traceback walked a padded "
                    "lane (li={li}, j={j}, k={k})",
                    li=li,
                    j=j,
                    k=k,
                ),
                lambda: None,
            )
        word = dirs[k // 16, li]
        code = (word >> (2 * (k % 16))) & 3
        ig = i0 + li

        is_stop = code == DIR_STOP
        di = jnp.where(code == DIR_INS, 0, 1)
        dj = jnp.where(code == DIR_DEL, 0, 1)
        # Reference saturation: each axis floors at 0 independently.
        ig_new = jnp.maximum(ig - di, 0)
        j_new = jnp.maximum(j - dj, 0)

        write = (~halt) & (~is_stop)
        moves = jnp.where(
            write,
            moves.at[jnp.minimum(pos, max_steps - 1)].set(
                code.astype(jnp.uint8)
            ),
            moves,
        )
        pos = jnp.where(write, pos + 1, pos)

        done_now = (~halt) & (
            is_stop | ((ig_new == 0) & (j_new == 0) & (j0 == 0))
        )
        # exited: 0 = no, 1 = upward (past row i0), 2 = left (hit the
        # window floor column while j0 > 0).
        ex_up = (~halt) & (~done_now) & (ig_new < i0)
        ex_left = (
            (~halt) & (~done_now) & (~ex_up) & (j_new == 0) & (j0 > 0)
        )
        return (
            jnp.where(halt, li, jnp.maximum(ig_new - i0, 0)),
            jnp.where(halt, j, j_new),
            pos,
            done | done_now,
            exited
            | jnp.where(ex_up, 1, jnp.where(ex_left, 2, 0)).astype(
                exited.dtype
            ),
            moves,
        )

    def body(st):
        for _ in range(UNROLL):
            st = substep(st)
        return st

    init = (
        jnp.asarray(start_li, jnp.int32),
        jnp.asarray(start_j, jnp.int32),
        jnp.int32(0),
        jnp.asarray(False),
        jnp.int32(0),
        jnp.zeros((max_steps,), dtype=jnp.uint8),
    )
    li, j, pos, done, exited, moves = jax.lax.while_loop(cond, body, init)
    # On an upward exit li was clamped to 0; the true row is i0 - 1.
    # A left exit stays in the block at its current (clamped) row.
    i_final = jnp.where(exited == 1, i0 - 1, i0 + li)
    return moves, pos, i_final, j, done


def resume_walk(step_fn, start_li, start_j, i0: int, windowed=False):
    """Drive a single-buffer block walker to completion.

    ``step_fn(li, j) -> (codes uint8[count], i_final, j_final, done)``
    performs one bounded walk from the block-local row ``li``; this
    loop resumes it until the path terminates (``done``) or exits the
    block upward (``i_final < i0``) — or, for a WINDOWED bitmap
    (``windowed=True``, local columns), left onto the window's floor
    column (``j_final == 0``) — concatenating the decoded codes.
    A resume that did not move the position is a corrupt direction
    table (in a valid table every recorded move steps toward the
    origin) and raises — regardless of how many moves were written,
    otherwise a saturated corrupt cell that keeps emitting moves would
    refill the buffer forever.
    """
    import numpy as np

    li, j = int(start_li), int(start_j)
    i0 = int(i0)
    chunks = []
    while True:
        codes, i_f, j_f, done = step_fn(li, j)
        chunks.append(codes)
        prev = (i0 + li, j)
        i_g, j_g, done = int(i_f), int(j_f), bool(done)
        if done or i_g < i0 or (windowed and j_g == 0):
            return (
                np.concatenate(chunks)
                if chunks
                else np.zeros(0, np.uint8),
                i_g,
                j_g,
                done,
            )
        if (i_g, j_g) == prev:
            raise RuntimeError(
                f"traceback made no progress at ({i_g}, {j_g})"
            )
        li, j = i_g - i0, j_g


def device_walk(
    dirs: jax.Array,
    start_li,
    start_j,
    i0,
    max_steps: int,
    j0=0,
):
    """Chase a packed-dirs block from (start_li, start_j); returns
    ``(codes uint8[count], i_final, j_final, done)``.

    Same movement semantics as :func:`walk_block`, which it calls.
    ``max_steps`` only sizes the move buffer; the walk keeps going
    past it by resuming through :func:`resume_walk`.

    ``j0 > 0``: the bitmap is a column WINDOW starting at global
    column j0 (``start_j``/``j_final`` window-local); a left exit
    returns done=False with ``j_final == 0`` and ``i_final >= i0``.
    """
    import numpy as np

    def step(li, j):
        out = walk_block(
            dirs,
            np.int32(li),
            np.int32(j),
            np.int32(i0),
            max_steps=max_steps,
            j0=np.int32(j0),
        )
        # Single D2H transfer for the whole tuple.
        moves, count, i_f, j_f, done = jax.device_get(out)
        return moves[: int(count)], i_f, j_f, done

    return resume_walk(
        step, start_li, start_j, i0, windowed=int(j0) > 0
    )
