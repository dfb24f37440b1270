"""Device-side suffix array + Burrows-Wheeler Transform.

The reference derives the BWT from a lexicographic DFS over its suffix
tree (``/root/reference/src/suffixtree/tree.rs:740-803``) — pointer
chasing that has no sensible accelerator mapping. The accelerator
equivalent (SURVEY §7) is a **prefix-doubling suffix array**: ~log2(n)
rounds of ``jax.lax.sort`` with composite (rank, rank+k) keys — sorts
are XLA-native and fast at chromosome scale — then

    BWT[k] = s'[SA[k] - 1]   (wrapping: SA[k] == 0 -> terminator)

which equals the tree DFS order because suffix comparison uses the
same ASCII byte order as the tree's sorted-alphabet child slots
(the terminator '$' = 0x24 sorts below A/C/G/T exactly as in the
merged alphabet — tree.rs:147-148, SURVEY §2.4-13).

Everything is int32 (ranks < n), static-shaped, jit-compiled once per
padded length bucket.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

TERMINATOR = 0x24  # '$'


@functools.partial(jax.jit, static_argnames=("rounds",))
def _suffix_array_fixed(s: jax.Array, rounds: int) -> jax.Array:
    """SA of the full (already terminated) uint8 array ``s``.

    The doubling rounds run inside ONE ``fori_loop`` body (``roll``
    takes a traced shift), so the compiled graph holds a single sort
    round instead of log2(n) inlined copies — at chromosome scale the
    unrolled version compiles far more slowly for an identical
    result.
    """
    n = s.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    rank0 = s.astype(jnp.int32)

    def round_fn(i, rank):
        k = jnp.left_shift(jnp.int32(1), i)
        rank2 = jnp.where(idx + k < n, jnp.roll(rank, -k), -1)
        # Lexicographic sort by (rank, rank2), carrying the index.
        r1s, r2s, order = jax.lax.sort(
            (rank, rank2, idx), dimension=0, num_keys=2
        )
        changed = (r1s != jnp.roll(r1s, 1)) | (r2s != jnp.roll(r2s, 1))
        changed = changed.at[0].set(False)
        new_sorted = jnp.cumsum(changed.astype(jnp.int32))
        return jnp.zeros_like(rank).at[order].set(new_sorted)

    rank = jax.lax.fori_loop(0, rounds, round_fn, rank0)
    _, sa = jax.lax.sort((rank, idx), dimension=0, num_keys=1)
    return sa


def suffix_array(text: str | bytes) -> np.ndarray:
    """Suffix array of ``text + '$'`` (terminator included).

    The input is padded to the next power of two with 0xFF: every real
    suffix is decided at or before the unique '$' (so pad bytes are
    never consulted between real suffixes), and pad-region suffixes
    start with 0xFF > any real byte, so they sort strictly last and
    the first len+1 entries are exactly the unpadded SA. One compile
    per power-of-two bucket instead of one per distinct length.
    """
    if isinstance(text, str):
        text = text.encode("latin-1")
    s = np.frombuffer(text + b"$", dtype=np.uint8)
    n = len(s)
    cap = 1 << max(1, math.ceil(math.log2(n)))
    padded = np.concatenate(
        [s, np.full(cap - n, 0xFF, dtype=np.uint8)]
    )
    rounds = max(1, math.ceil(math.log2(cap)))
    sa = np.asarray(_suffix_array_fixed(jnp.asarray(padded), rounds))
    return sa[:n]


def bwt_device(text: str | bytes) -> str:
    """BWT of ``text`` (with '$' terminator), identical to the
    suffix-tree DFS BWT of ``compute_stats`` for string 0."""
    if isinstance(text, str):
        text = text.encode("latin-1")
    s = np.frombuffer(text + b"$", dtype=np.uint8)
    sa = suffix_array(text)
    out = s[(sa - 1) % len(s)]
    return out.tobytes().decode("latin-1")
