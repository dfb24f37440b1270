"""Digest-keyed device-resident operand cache.

Repeated jobs over the same corpus (the all-pairs score matrix inside
``msa``, a re-run ``align-matrix``) re-upload identical host arrays on
every call. This bounded LRU keys device copies by content digest so
steady-state callers hand XLA an already-resident operand and skip
the host-to-device copy.

The reference has no analog (single-process CPU, its operands live in
RAM — ``/root/reference/src/main.rs:230-248`` reloads FASTA per run);
this is the device equivalent of "keep the corpus hot".

Correctness: the key is (shape, dtype, blake2b-128 of the raw bytes) —
a collision would need two distinct operands with identical 128-bit
digests. Capacity is bytes-bounded; eviction is LRU. Thread-safe for
the CPython-GIL access pattern the drivers use (dict ops are atomic).
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

import jax

#: resident-bytes bound. 512 MB covers dozens of 30 kb-corpus operand
#: stacks while staying a small fraction of a device's memory.
CAP_BYTES = 512 << 20

_cache: collections.OrderedDict = collections.OrderedDict()
_bytes = 0


def device_put_cached(arr: np.ndarray) -> jax.Array:
    """A device-resident copy of ``arr``, reused across calls.

    Operands larger than the whole cache bound are uploaded but never
    retained (a single over-cap entry would otherwise survive the
    LRU's ``len > 1`` stop condition forever). Long-lived processes
    that move between unrelated corpora should call :func:`clear` at
    job boundaries (the CLI does, per subcommand run).
    """
    global _bytes
    a = np.ascontiguousarray(arr)
    if a.nbytes > CAP_BYTES:
        return jax.device_put(a)
    key = (
        a.shape,
        str(a.dtype),
        hashlib.blake2b(a.tobytes(), digest_size=16).digest(),
    )
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return hit
    dev = jax.device_put(a)
    _cache[key] = dev
    _bytes += a.nbytes
    while _bytes > CAP_BYTES and len(_cache) > 1:
        _, old = _cache.popitem(last=False)
        _bytes -= old.nbytes
    return dev


def clear() -> None:
    """Drop every cached device array (frees the device references)."""
    global _bytes
    _cache.clear()
    _bytes = 0
