"""FM-index: BWT-backed substring counting/locating, batched on device.

No reference counterpart: ``/root/reference`` computes the BWT only to
print it (``src/suffixtree/tree.rs:740-803``, ``src/main.rs:177-214``).
This module closes the loop — the BWT becomes a queryable index:

* **build** rides the device prefix-doubling suffix array
  (``ops/bwt_device.suffix_array``: log2(n) rounds of ``lax.sort``),
  then derives the BWT, the C array and a full Occ table host-side;
* **count** is classic backward search: per pattern char c,
  ``lo, hi -> C[c] + Occ[lo][c], C[c] + Occ[hi][c]`` — O(|p|) with two
  rank lookups per step, independent of text length;
* **count_batch** runs thousands of backward searches in lockstep on
  device: patterns are right-aligned into one (B, Lp) int32 buffer so
  every search starts at the same column, and a single
  ``jax.lax.scan`` over columns advances all B (lo, hi) ranges with
  two flat gathers from the device-resident Occ table per step;
* **locate** reads positions straight out of the retained suffix
  array (it is a build byproduct here, so no SA sampling / LF walking
  is needed — memory is 4 bytes/char, fine at chromosome scale).

The terminator is the reference's ``'$'`` (0x24): ASCII-below A/C/G/T,
so row 0 of the conceptual sorted-rotation matrix is the terminator
row exactly as in the suffix-tree DFS BWT (SURVEY §2.4-13), and this
index's BWT string equals ``compute_stats``'s for the same text.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from genomics_rs_tpu.ops.bwt_device import TERMINATOR, suffix_array


@functools.partial(jax.jit, static_argnames=("A", "wide"))
def _search_batch_device(
    occ_flat: jax.Array,  # int32 ((n+1) * A,) row-major Occ
    cvec: jax.Array,  # int32 (A,) chars-below counts
    pats: jax.Array,  # int32 (B, Lp) codes, -1 pad (left), right-aligned
    n: jax.Array,  # int32 scalar: text length incl. terminator
    A: int,
    wide: bool = False,
):
    # ``wide``: (n+1)*A exceeds int32, so the flat gather index
    # lo * A + c would wrap silently (wrong counts — ADVICE r3).
    # Gather the 2-D Occ with (row, col) instead there; the row index
    # alone always fits int32.
    occ2d = occ_flat.reshape(-1, A) if wide else None
    B, Lp = pats.shape
    lo0 = jnp.zeros((B,), jnp.int32)
    hi0 = jnp.broadcast_to(n.astype(jnp.int32), (B,))

    def step(carry, col):
        lo, hi = carry
        valid = col >= 0
        c = jnp.where(valid, col, 0)
        base = cvec[c]
        if wide:
            nlo = base + occ2d[lo, c]
            nhi = base + occ2d[hi, c]
        else:
            nlo = base + occ_flat[lo * A + c]
            nhi = base + occ_flat[hi * A + c]
        lo = jnp.where(valid, nlo, lo)
        hi = jnp.where(valid, nhi, hi)
        return (lo, hi), None

    # Backward search: last pattern char first = rightmost column
    # first. Right-aligned padding puts every pattern's last char in
    # the final column, so the -1 guards only fire once a (shorter)
    # pattern has fully matched and its range must be held.
    cols = jnp.flip(pats.T, axis=0)
    (lo, hi), _ = jax.lax.scan(step, (lo0, hi0), cols)
    return lo, hi


@dataclasses.dataclass(eq=False)
class FMIndex:
    """Immutable FM-index over one text (terminator appended).

    ``eq=False``: ndarray fields make the generated ``__eq__``
    ambiguous (it would raise on comparison); indexes are
    identity-compared.
    """

    #: text bytes including the trailing terminator.
    text: bytes
    #: suffix array of ``text`` (length n = len(text)).
    sa: np.ndarray
    #: BWT bytes (length n).
    bwt: bytes
    #: sorted distinct byte values of ``text``.
    alphabet: np.ndarray
    #: byte value -> dense code, -1 for absent bytes (256,).
    code: np.ndarray
    #: (A,) count of text chars strictly below each alphabet char.
    cvec: np.ndarray
    #: (n+1, A) ranks: occ[i][c] = #occurrences of c in bwt[:i].
    occ: np.ndarray
    #: lazily cached device-resident (occ_flat, cvec) so repeated
    #: batch searches don't re-upload the Occ table every call.
    _dev: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @classmethod
    def build(cls, text: str | bytes, host: bool | None = None) -> "FMIndex":
        """Build the index.

        ``host=None`` (default) uses the linear-time native SA-IS
        (native/sais.cpp) when built — at chromosome scale it beats
        the device prefix-doubling SA by ~2 orders of magnitude —
        falling back to the device path. ``host=True`` requires the
        native path, ``host=False`` forces the device path (the BWT
        golden; both orders are bit-identical, pinned in tests).
        """
        if isinstance(text, str):
            text = text.encode("latin-1")
        if bytes([TERMINATOR]) in text:
            raise ValueError(
                "text must not contain the terminator byte '$'"
            )
        sa = None
        if host is None or host:
            from genomics_rs_tpu.suffixtree.native import (
                native_suffix_array,
            )

            sa = native_suffix_array(text + b"$")
            if sa is None and host:
                raise RuntimeError(
                    "host=True but the native library is unavailable"
                )
        if sa is None:
            sa = suffix_array(text)
        s = np.frombuffer(text + b"$", dtype=np.uint8)
        n = len(s)
        bwt = s[(sa - 1) % n]
        alphabet = np.unique(s)
        A = len(alphabet)
        code = np.full(256, -1, dtype=np.int32)
        code[alphabet] = np.arange(A, dtype=np.int32)
        counts = np.bincount(s, minlength=256)[alphabet]
        cvec = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
            np.int32
        )
        onehot = code[bwt][:, None] == np.arange(A, dtype=np.int32)
        occ = np.zeros((n + 1, A), dtype=np.int32)
        np.cumsum(onehot, axis=0, out=occ[1:])
        return cls(
            text=bytes(s),
            sa=sa.astype(np.int32),
            bwt=bwt.tobytes(),
            alphabet=alphabet,
            code=code,
            cvec=cvec,
            occ=occ,
        )

    @property
    def n(self) -> int:
        return len(self.text)

    def _pattern_code(self, byte: int) -> int:
        """Dense code for a PATTERN byte: the terminator is part of
        the index structure but not of the user's text, so patterns
        containing it count 0 like any absent byte."""
        if byte == TERMINATOR:
            return -1
        return int(self.code[byte])

    def _range(self, pattern: bytes) -> tuple[int, int]:
        lo, hi = 0, self.n
        for byte in reversed(pattern):
            c = self._pattern_code(byte)
            if c < 0:
                return 0, 0
            lo = int(self.cvec[c]) + int(self.occ[lo, c])
            hi = int(self.cvec[c]) + int(self.occ[hi, c])
            if lo >= hi:
                return 0, 0
        return lo, hi

    def count(self, pattern: str | bytes) -> int:
        """Occurrences of ``pattern`` in the text (overlaps counted)."""
        if isinstance(pattern, str):
            pattern = pattern.encode("latin-1")
        if not pattern:
            return self.n
        lo, hi = self._range(pattern)
        return hi - lo

    def locate(self, pattern: str | bytes) -> np.ndarray:
        """Sorted start offsets of every occurrence."""
        if isinstance(pattern, str):
            pattern = pattern.encode("latin-1")
        lo, hi = self._range(pattern) if pattern else (0, self.n)
        return np.sort(self.sa[lo:hi])

    def count_batch(
        self, patterns: list[str | bytes], device: bool = True
    ) -> np.ndarray:
        """Counts for many patterns in one device dispatch.

        Patterns containing bytes absent from the text (including the
        index's own terminator) count 0 and never reach the device;
        empty patterns count n (every position), matching
        :meth:`count`.
        """
        counts, _ = self.search_batch(patterns, device=device)
        return counts

    def search_batch(
        self, patterns: list[str | bytes], device: bool = True
    ) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """(counts, per-pattern (lo, hi) suffix-array ranges).

        The ranges make batched locate a pure ``sa[lo:hi]`` slice —
        no per-pattern host backward search after a device batch.
        """
        B = len(patterns)
        out = np.zeros(B, dtype=np.int64)
        ranges: list[tuple[int, int]] = [(0, 0)] * B
        # Vectorized encode: one pass over the joined pattern bytes
        # (the per-pattern Python loop dominated wall-clock at 100k
        # patterns — ~2 s of host time per batch).
        pb = [
            p.encode("latin-1") if isinstance(p, str) else p
            for p in patterns
        ]
        lens = np.array([len(p) for p in pb], dtype=np.int64)
        for k in np.flatnonzero(lens == 0):
            out[k] = self.n
            ranges[k] = (0, self.n)
        joined = np.frombuffer(b"".join(pb), dtype=np.uint8)
        if joined.size == 0:
            return out, ranges
        codes_all = self.code[joined].astype(np.int32)
        # The terminator is index structure, not text: absent.
        codes_all[joined == TERMINATOR] = -1
        offs = np.concatenate([[0], np.cumsum(lens)])
        nz = np.flatnonzero(lens > 0)
        # reduceat segment ends are the next listed start; empty
        # patterns add no bytes, so consecutive nz starts are exact.
        bad = (
            np.add.reduceat((codes_all < 0).astype(np.int64), offs[nz])
            > 0
        )
        keep = nz[~bad]  # searchable patterns (absent bytes count 0)
        if keep.size == 0:
            return out, ranges
        if not device:
            for k in keep:
                lo, hi = self._range(pb[int(k)])
                out[k] = hi - lo
                ranges[k] = (lo, hi)
            return out, ranges
        klens = lens[keep]
        Lp = int(klens.max())
        pats = np.full((len(keep), Lp), -1, dtype=np.int32)
        within = (
            np.arange(int(klens.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(klens) - klens, klens)
        )
        rowidx = np.repeat(np.arange(len(keep)), klens)
        pats[rowidx, within + np.repeat(Lp - klens, klens)] = codes_all[
            np.repeat(offs[keep], klens) + within
        ]
        if self._dev is None:
            self._dev = (
                jnp.asarray(self.occ.reshape(-1)),
                jnp.asarray(self.cvec),
            )
        occ_flat, cvec = self._dev
        A = len(self.alphabet)
        lo, hi = _search_batch_device(
            occ_flat,
            cvec,
            jnp.asarray(pats),
            jnp.int32(self.n),
            A=A,
            wide=(self.n + 1) * A >= 2**31,
        )
        lo, hi = np.asarray(lo), np.asarray(hi)
        out[keep] = np.maximum(hi.astype(np.int64) - lo, 0)
        for row, k in enumerate(keep):
            l, h = int(lo[row]), int(hi[row])
            ranges[k] = (l, h) if h > l else (0, 0)
        return out, ranges

    def locate_range(self, rng: tuple[int, int]) -> np.ndarray:
        """Sorted text offsets for a (lo, hi) range from
        :meth:`search_batch`."""
        lo, hi = rng
        return np.sort(self.sa[lo:hi])


#: joins contigs in a multi-reference index. 0x23 ('#') is below every
#: DNA/protein letter and distinct from the terminator; patterns never
#: contain it, so no match can span a contig boundary.
SEPARATOR = 0x23


@dataclasses.dataclass(eq=False)
class MultiFMIndex:
    """FM-index over a multi-contig reference (one joined text).

    Contigs are joined with :data:`SEPARATOR` bytes; a match would
    have to contain the separator to cross a boundary, so every hit
    lies inside exactly one contig and locating is coordinate
    arithmetic over the contig offset table.
    """

    index: FMIndex
    names: list[str]
    #: (K,) start offset of each contig in the joined text.
    offsets: np.ndarray
    lengths: np.ndarray

    @classmethod
    def build(cls, refs, host: bool | None = None) -> "MultiFMIndex":
        """``refs``: Sequence-likes with ``.name`` and ``.sequence``.
        ``host`` as in :meth:`FMIndex.build`."""
        if not refs:
            raise ValueError("empty reference list")
        names, parts = [], []
        for r in refs:
            if chr(SEPARATOR) in r.sequence:
                raise ValueError(
                    f"contig {r.name!r} contains the separator byte"
                )
            names.append(r.name)
            parts.append(r.sequence)
        joined = chr(SEPARATOR).join(parts)
        lengths = np.array([len(p) for p in parts], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths[:-1] + 1)])
        return cls(
            index=FMIndex.build(joined, host=host),
            names=names,
            offsets=offsets,
            lengths=lengths,
        )

    @staticmethod
    def _sanitize(patterns) -> list:
        """Separator bytes exist only as contig glue: a pattern
        containing one matches nothing in any contig, so it is
        replaced by an unsearchable stand-in (terminator byte) that
        the single-text index already counts 0."""
        sep = chr(SEPARATOR)
        out = []
        for p in patterns:
            has_sep = (
                SEPARATOR in p if isinstance(p, bytes) else sep in p
            )
            out.append(b"$" if has_sep else p)
        return out

    def count_batch(self, patterns, device: bool = True) -> np.ndarray:
        return self.search_batch(patterns, device=device)[0]

    def search_batch(self, patterns, device: bool = True):
        counts, ranges = self.index.search_batch(
            self._sanitize(patterns), device=device
        )
        # Empty patterns: the joined text's count would include the
        # separator/terminator positions locate_range filters out —
        # report the number of real contig positions so count ==
        # len(locate_range(rng)) holds for every pattern.
        real = int(self.lengths.sum())
        for k, p in enumerate(patterns):
            if len(p) == 0:
                counts[k] = real
        return counts, ranges

    def locate_range(
        self, rng: tuple[int, int]
    ) -> list[tuple[str, int]]:
        """Sorted (contig name, 0-based offset) for every hit."""
        hits = self.index.locate_range(rng).astype(np.int64)
        if hits.size == 0:
            return []
        k = np.searchsorted(self.offsets, hits, side="right") - 1
        local = hits - self.offsets[k]
        # Separator/terminator positions can only surface for empty
        # patterns; one vectorized mask drops those pseudo-hits.
        keep = local < self.lengths[k]
        return [
            (self.names[int(ki)], int(li))
            for ki, li in zip(k[keep], local[keep])
        ]
