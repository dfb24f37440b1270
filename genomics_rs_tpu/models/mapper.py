"""Seed-and-extend read mapping against long (multi-contig) references.

Framework extension — the reference aligns exactly two whole sequences
(``/root/reference/src/alignment/algo.rs:151-282``) and has no mapping
mode; full DP of every read against a chromosome costs
``|read| * |ref|`` cells per read. This module adds the standard
mapper decomposition, host work vectorized and DP on the device:

* **host** (irregular, pointer-chasing — host-side per SURVEY §7's
  stance): an exact k-mer index of the reference (2-bit Horner-packed
  keys, sorted array + binary search) and per-read candidate windows
  by diagonal voting. Everything is vectorized across the whole read
  batch — one pack, one ``searchsorted``, one grouped vote — no
  per-read Python loops;
* **device**: all candidate windows are extended in fixed-shape
  batched dispatches through :func:`~genomics_rs_tpu.models.reads.
  align_reads` (batched scan fill + lockstep batched traceback),
  local mode, so unaligned read ends become soft clips.

Cost per read drops from ``|read| * |ref|`` to
``|read| * (|read| + 4*band)`` — ~1,500x fewer DP cells for 100 bp
reads against a 1 Mb chromosome. Repetitive seeds are capped
(``max_hits``), so poly-A-style reads in repeat deserts go unmapped
rather than exploding the vote table — standard mapper behavior.

Strand handling mirrors ``align_reads(both_strands=True)``: the
reverse-complemented read rows ride the same vectorized seeding pass,
the orientation with more votes wins (forward wins ties), and a
``"-"`` result's coordinates/CIGAR are those of the oriented read.
:func:`~genomics_rs_tpu.models.reads.write_sam` consumes the results
directly (contig-relative ``mapinfo`` + per-result ``contig`` make POS
land on the right reference sequence).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.reads import align_reads
from genomics_rs_tpu.ops.traceback import AlignedSequences
from genomics_rs_tpu.sequence import Sequence

#: Row-chunk size for thread-parallel seeding (reads per chunk).
_PAR_CHUNK = 16384

#: ASCII byte -> 2-bit base code; 0xFF marks non-ACGT (either case).
_BASE = np.full(256, 0xFF, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _BASE[_c] = _i


def _pack_rows(enc4: np.ndarray, k: int):
    """Horner-pack every k-window of each row of a (B, L) 2-bit-code
    matrix: returns ``(keys, valid)`` of shape (B, L-k+1). ``valid``
    is False where the window contains a non-ACGT byte (code >= 4;
    padding uses 0xFF so padded tails are invalid automatically)."""
    B, L = enc4.shape
    n = L - k + 1
    if n <= 0:
        return (
            np.zeros((B, 0), np.uint64),
            np.zeros((B, 0), bool),
        )
    keys = np.zeros((B, n), np.uint64)
    for i in range(k):
        keys = (keys << np.uint64(2)) | (
            enc4[:, i : i + n].astype(np.uint64) & np.uint64(3)
        )
    bad = (enc4 >= 4).astype(np.int32)
    c = np.concatenate(
        [np.zeros((B, 1), np.int32), np.cumsum(bad, axis=1)], axis=1
    )
    valid = (c[:, k:] - c[:, :-k]) == 0
    return keys, valid


class KmerIndex:
    """Sorted exact k-mer index of one reference sequence.

    ``lookup`` positions are 0-based window starts, ascending within
    one key (stable sort keeps original order). Windows containing a
    non-ACGT byte are never indexed.
    """

    def __init__(self, ref: Sequence | list[Sequence], k: int = 21):
        if not 4 <= k <= 31:
            raise ValueError(f"k={k} outside [4, 31] (2-bit uint64 pack)")
        self.refs: list[Sequence] = (
            [ref] if isinstance(ref, Sequence) else list(ref)
        )
        if not self.refs:
            raise ValueError("empty reference list")
        self.k = k
        # Multi-contig: windows are packed per contig (no window ever
        # crosses a boundary) and positions are stored in the GLOBAL
        # concatenated coordinate space; `starts[c]` maps them back.
        self.starts = np.concatenate(
            [[0], np.cumsum([len(r) for r in self.refs])]
        ).astype(np.int64)
        all_keys, all_pos = [], []
        for c, r in enumerate(self.refs):
            enc4 = _BASE[r.encoded()][None, :]
            keys, valid = _pack_rows(enc4, k)
            pos = np.flatnonzero(valid[0])
            all_keys.append(keys[0][pos])
            all_pos.append(pos.astype(np.int64) + self.starts[c])
        keys = np.concatenate(all_keys)
        pos = np.concatenate(all_pos)
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._pos = pos[order]
        self._dev = None

    @property
    def ref(self) -> Sequence:
        """The first (or only) reference contig."""
        return self.refs[0]

    def contig_of(self, gpos: int) -> int:
        """Contig id owning global position ``gpos``."""
        return int(np.searchsorted(self.starts, gpos, "right") - 1)

    def __len__(self) -> int:
        return int(self._keys.size)

    def device_arrays(self):
        """Index as device-resident int32 arrays (keys, positions).

        Device seeding needs ``k <= 15`` so packed keys fit 30 bits —
        JAX defaults to 32-bit ints and 64-bit sorts/searches are slow
        on accelerators."""
        if self.k > 15:
            raise ValueError(
                f"device seeding requires k <= 15 (int32 keys); "
                f"index has k={self.k}"
            )
        if int(self.starts[-1]) > np.iinfo(np.int32).max:
            raise ValueError(
                "device seeding requires total reference length "
                f"< 2^31 (got {int(self.starts[-1])}); use the host "
                "seed engine"
            )
        if self._dev is None:
            import jax.numpy as jnp

            self._dev = (
                jnp.asarray(self._keys.astype(np.int64).astype(np.int32)),
                jnp.asarray(self._pos.astype(np.int32)),
            )
        return self._dev

    def lookup(self, key: int) -> np.ndarray:
        lo = np.searchsorted(self._keys, np.uint64(key), "left")
        hi = np.searchsorted(self._keys, np.uint64(key), "right")
        return self._pos[lo:hi]


@functools.lru_cache(maxsize=16)
def _device_vote_fn(k: int, S: int, H: int, band: int):
    """Build the jitted fixed-shape voting kernel for one plan.

    The ragged host pipeline (variable hit counts -> np.unique) cannot
    jit; this twin re-states it with static shapes: every sampled seed
    owns exactly ``H`` hit slots (masked beyond its true count — seeds
    over the cap contribute nothing, like the host filter), per-read
    candidate bins are sorted, and the bin-pair vote of EVERY hit
    position is its bin's count plus bin+1's count via two batched
    binary searches of the row into itself. The first argmax over the
    sorted row is the smallest bin holding the max — the host
    tie-break. Only needs int32: device seeding requires ``k <= 15``
    (30-bit packed keys).
    """
    import jax
    import jax.numpy as jnp

    def fn(enc4c, keys, pos, offs):
        C = enc4c.shape[0]
        skeys = jnp.zeros((C, S), jnp.int32)
        bad = jnp.zeros((C, S), bool)
        for i in range(k):
            col = enc4c[:, offs + i].astype(jnp.int32)
            skeys = (skeys << 2) | (col & 3)
            bad = bad | (col >= 4)
        lo = jnp.searchsorted(keys, skeys.ravel(), side="left")
        hi = jnp.searchsorted(keys, skeys.ravel(), side="right")
        lo = lo.reshape(C, S).astype(jnp.int32)
        cnt = (hi.reshape(C, S) - lo).astype(jnp.int32)
        seed_ok = (~bad) & (cnt > 0) & (cnt <= H)
        slot = jnp.arange(H, dtype=jnp.int32)
        idx = jnp.clip(lo[:, :, None] + slot, 0, pos.size - 1)
        hitmask = seed_ok[:, :, None] & (slot < cnt[:, :, None])
        hitpos = pos[idx]
        diag = hitpos - offs[None, :, None]
        bins = jnp.floor_divide(diag, band)
        BIG = jnp.int32(1) << 28  # > any real bin, +1 never wraps
        rows = jnp.where(hitmask, bins, BIG).reshape(C, S * H)
        rows = jnp.sort(rows, axis=1)

        def count_row(row):
            c1 = jnp.searchsorted(
                row, row, side="right"
            ) - jnp.searchsorted(row, row, side="left")
            c2 = jnp.searchsorted(
                row, row + 1, side="right"
            ) - jnp.searchsorted(row, row + 1, side="left")
            return c1 + c2

        pair = jax.vmap(count_row)(rows)
        pair = jnp.where(rows < BIG, pair, -1)
        best = jnp.argmax(pair, axis=1)
        bw = jnp.take_along_axis(rows, best[:, None], 1)[:, 0]
        v = jnp.take_along_axis(pair, best[:, None], 1)[:, 0]
        v = jnp.maximum(v, 0)
        # Contig anchor: smallest hit position inside the winning bin
        # pair (a real global reference coordinate).
        IMAX = jnp.int32(np.iinfo(np.int32).max)
        inwin = hitmask & (
            (bins == bw[:, None, None]) | (bins == bw[:, None, None] + 1)
        )
        amin = jnp.min(
            jnp.where(inwin, hitpos, IMAX).reshape(C, S * H), axis=1
        )
        anchor = jnp.where(v > 0, amin, -1)
        # Second-best non-overlapping bin pair (|bin - winner| > 1):
        # the MAPQ margin, mirroring the host engine.
        pair2 = jnp.where(jnp.abs(rows - bw[:, None]) <= 1, -1, pair)
        best2 = jnp.argmax(pair2, axis=1)
        v2 = jnp.maximum(
            jnp.take_along_axis(pair2, best2[:, None], 1)[:, 0], 0
        )
        return v, jnp.where(v > 0, bw * band, 0), anchor, v2

    return jax.jit(fn)


def _vote_windows_device(
    index: KmerIndex,
    enc4: np.ndarray,
    stride: int,
    max_hits: int,
    band: int,
    chunk: int = 16384,
):
    """Device twin of :func:`_vote_windows` — same results, computed
    on the accelerator with fixed shapes (chunked over reads; the
    last chunk is padded with invalid rows so one jit serves all)."""
    R, L = enc4.shape
    k = index.k
    n = L - k + 1
    votes = np.zeros(R, np.int64)
    votes2 = np.zeros(R, np.int64)
    wlo = np.zeros(R, np.int64)
    anchor = np.full(R, -1, np.int64)
    if n <= 0:
        return votes, wlo, wlo, anchor, votes2
    keys_d, pos_d = index.device_arrays()
    offs = np.arange(0, n, stride, dtype=np.int32)
    fn = _device_vote_fn(k, offs.size, max_hits, band)
    import jax.numpy as jnp

    offs_d = jnp.asarray(offs)
    for s in range(0, R, chunk):
        part = enc4[s : s + chunk]
        if part.shape[0] < chunk and R > chunk:
            pad = np.full(
                (chunk - part.shape[0], L), 0xFE, dtype=enc4.dtype
            )
            part = np.concatenate([part, pad])
        v, w, a, v2 = fn(jnp.asarray(part), keys_d, pos_d, offs_d)
        m = min(chunk, R - s)
        votes[s : s + m] = np.asarray(v)[:m]
        wlo[s : s + m] = np.asarray(w)[:m]
        anchor[s : s + m] = np.asarray(a)[:m]
        votes2[s : s + m] = np.asarray(v2)[:m]
    return votes, wlo, wlo + 2 * band, anchor, votes2


@dataclasses.dataclass
class MappedRead:
    """One read's mapping result (input order is preserved).

    ``read`` is the ORIENTED read (reverse-complemented when
    ``strand == "-"``); ``contig`` is the reference sequence the read
    mapped to (the first contig for unmapped reads);
    ``mapinfo = (i0, j0, end_i, end_j)`` spans query rows
    ``(i0, end_i]`` and CONTIG-RELATIVE reference columns
    ``(j0, end_j]`` of the local extension; ``seeds`` is the winning
    window's vote count (0 for reads with no usable seed); ``mapq``
    is a seed-margin uniqueness heuristic,
    ``min(60, 6 * (seeds - runner_up_seeds))`` — 0 when the best
    window is tied with another (including the other strand's best),
    60 when unambiguous; 0 for unmapped reads."""

    read: Sequence
    contig: Sequence
    strand: str
    mapped: bool
    score: int
    mapinfo: tuple[int, int, int, int]
    cigar: str
    aligned: AlignedSequences
    seeds: int
    mapq: int = 255


def _vote_windows(
    index: KmerIndex,
    enc4: np.ndarray,
    stride: int,
    max_hits: int,
    band: int,
):
    """Best candidate window per row of a (R, L) read matrix.

    Returns ``(votes, wlo, whi, anchor, votes2)`` per row: the winning
    diagonal bin-pair's vote count, its diagonal span ``[wlo, whi)``
    (window columns are ``diag .. diag + m``, so the caller widens by
    read length + band), and ``anchor`` — the smallest REFERENCE HIT
    POSITION among the winning bins' hits. The anchor is a real
    global coordinate inside the supporting contig, which is what the
    caller must use to assign the window's contig (the widened window
    itself may straddle a boundary). ``votes2`` is the second-best
    NON-OVERLAPPING bin pair's count — the margin behind MAPQ. Rows
    with no in-cap seed hits get votes == 0 and anchor == -1.
    """
    R, L = enc4.shape
    k = index.k
    n = L - k + 1
    votes = np.zeros(R, np.int64)
    votes2 = np.zeros(R, np.int64)
    wlo = np.zeros(R, np.int64)
    anchor = np.full(R, -1, np.int64)
    if n <= 0:
        return votes, wlo, wlo, anchor, votes2
    # Big batches: chunk rows across threads — the hot numpy ops
    # (gathers, searchsorted, unique/sort) release the GIL, and chunks
    # are independent, so results are bit-identical to one pass.
    if R >= 2 * _PAR_CHUNK:
        import concurrent.futures as cf
        import os as _os

        chunks = [
            (s, min(s + _PAR_CHUNK, R)) for s in range(0, R, _PAR_CHUNK)
        ]
        workers = min(_os.cpu_count() or 1, len(chunks))
        with cf.ThreadPoolExecutor(workers) as pool:
            parts = list(
                pool.map(
                    lambda se: _vote_windows(
                        index, enc4[se[0] : se[1]], stride, max_hits, band
                    ),
                    chunks,
                )
            )
        return tuple(np.concatenate(xs) for xs in zip(*parts))
    offs = np.arange(0, n, stride)
    # Pack ONLY the sampled offsets (k gathers of (R, S) columns) —
    # packing every window first and sampling after costs stride-times
    # the work and dominates the whole seeding pass.
    skeys = np.zeros((R, offs.size), np.uint64)
    sbad = np.zeros((R, offs.size), bool)
    for i in range(k):
        col = enc4[:, offs + i]
        skeys = (skeys << np.uint64(2)) | (
            (col & 3).astype(np.uint64)
        )
        sbad |= col >= 4
    svalid = ~sbad
    lo = np.searchsorted(index._keys, skeys.ravel(), "left")
    hi = np.searchsorted(index._keys, skeys.ravel(), "right")
    cnt = hi - lo
    use = svalid.ravel() & (cnt > 0) & (cnt <= max_hits)
    lo, cnt = lo[use], cnt[use]
    if lo.size == 0:
        return votes, wlo, wlo, anchor, votes2
    rid = np.repeat(np.arange(R), offs.size)[use]
    off = np.tile(offs, R)[use]
    # Ragged expansion of [lo, lo+cnt) hit runs into flat arrays:
    # within-run offset = global position - run start.
    total = int(cnt.sum())
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    hit_idx = np.repeat(lo, cnt) + (
        np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    )
    pos = index._pos[hit_idx]
    rid_f = np.repeat(rid, cnt)
    diag = pos - np.repeat(off, cnt)
    # Vote per (read, diagonal band); windows cover bin pairs (b, b+1)
    # so hits straddling a bin edge still count together.
    bins = diag // band
    binmin = bins.min()
    combo = rid_f * np.int64(1 << 40) + (bins - binmin)
    # Sorted-group pass (replaces np.unique) so each bin also yields
    # its minimum hit position — the winning window's contig anchor.
    order0 = np.argsort(combo, kind="stable")
    combo_s = combo[order0]
    pos_s = pos[order0]
    ub, first0 = np.unique(combo_s, return_index=True)
    uc = np.diff(np.concatenate([first0, [combo_s.size]]))
    uminpos = np.minimum.reduceat(pos_s, first0)
    nxt = np.searchsorted(ub, ub + 1)
    has_nxt = (nxt < ub.size) & (
        ub[np.minimum(nxt, ub.size - 1)] == ub + 1
    )
    nxt_cl = np.minimum(nxt, ub.size - 1)
    pair = uc + np.where(has_nxt, uc[nxt_cl], 0)
    pairpos = np.minimum(
        uminpos,
        np.where(has_nxt, uminpos[nxt_cl], np.iinfo(np.int64).max),
    )
    urid = (ub >> np.int64(40)).astype(np.int64)
    ubin = (ub & np.int64((1 << 40) - 1)) + binmin
    # Per-read argmax over bin pairs: sort by (read, -votes, bin) and
    # keep each read's first row (ties -> smallest diagonal bin).
    order = np.lexsort((ubin, -pair, urid))
    urid_s = urid[order]
    first = np.unique(urid_s, return_index=True)[1]
    rows = order[first]
    votes[urid_s[first]] = pair[rows]
    wlo[urid_s[first]] = ubin[rows] * band
    anchor[urid_s[first]] = pairpos[rows]
    # Second-best NON-OVERLAPPING bin pair (|bin - winner| > 1 —
    # adjacent pairs share hits and are not independent candidates):
    # the uniqueness signal behind MAPQ.
    winbin = np.full(R, np.int64(1) << 60)
    winbin[urid_s[first]] = ubin[rows]
    pair2 = np.where(np.abs(ubin - winbin[urid]) <= 1, -1, pair)
    order2 = np.lexsort((ubin, -pair2, urid))
    urid_s2 = urid[order2]
    first2 = np.unique(urid_s2, return_index=True)[1]
    votes2[urid_s2[first2]] = np.maximum(pair2[order2[first2]], 0)
    return votes, wlo, wlo + 2 * band, anchor, votes2


class ExtensionPlan(NamedTuple):
    """Per-read seeding outcome of :func:`plan_extensions`.

    ``chosen[i]``/``strands[i]``: the orientation read ``i`` extends
    in; ``votes``/``votes2``: its winning and runner-up vote counts
    (MAPQ margin). ``mapped_ix`` lists the reads with a candidate
    window; for the t-th of them ``win_seqs[t]`` is the window's
    reference slice, starting at contig offset ``win_starts[t]`` of
    ``win_contig[t]``.
    """

    chosen: list
    strands: list
    votes: np.ndarray
    votes2: np.ndarray
    mapped_ix: list
    win_seqs: list
    win_starts: list
    win_contig: list


def plan_extensions(
    queries: list[Sequence],
    index: KmerIndex,
    *,
    stride: int,
    band: int,
    max_hits: int,
    min_seeds: int,
    both_strands: bool,
    seed_engine: str = "host",
) -> ExtensionPlan:
    """Seed every read and pick its extension window (host work plus
    the optional device vote). A read's plan depends on that read
    alone, so planning a subset of reads gives those reads' windows
    exactly as :func:`map_reads` extends them."""
    B = len(queries)
    # Case-normalize for seeding AND extension: the index case-folds
    # (soft-masked lowercase reference regions still seed) and the DP
    # layer compares raw bytes, so both sides must see one case or a
    # read over a lowercase region would seed, then score 0.
    def _upper(q: Sequence) -> Sequence:
        if q.sequence.isupper():
            return q
        return Sequence(q.name, q.sequence.upper(), q.quality)

    oriented = [_upper(q) for q in queries]
    if both_strands:
        oriented = oriented + [q.reverse_complement() for q in oriented[:B]]
    L = max(max(len(q) for q in oriented), 1)
    # One-pass batch encode (200k per-read encoded() calls cost ~1 s
    # per 100k-read both-strand batch — the round-4 mapper profile).
    from genomics_rs_tpu.models.reads import encode_batch

    enc4 = _BASE[encode_batch(oriented, L, 0xFE)]
    lens = np.array([len(q) for q in oriented], np.int64)
    if seed_engine == "device":
        votes, wlo, whi, anchor, votes2 = _vote_windows_device(
            index, enc4, stride, max_hits, band
        )
    elif seed_engine == "host":
        votes, wlo, whi, anchor, votes2 = _vote_windows(
            index, enc4, stride, max_hits, band
        )
    else:
        raise ValueError(f"unknown seed_engine {seed_engine!r}")
    if both_strands:
        use_rc = votes[B:] > votes[:B]  # forward wins ties
        pick = np.where(use_rc, np.arange(B) + B, np.arange(B))
        # The losing orientation's best window is itself a competing
        # alignment: it joins the runner-up margin behind MAPQ.
        other = np.where(use_rc, votes[:B], votes[B:])
        votes2 = np.maximum(votes2[pick], other)
        votes, wlo, whi, anchor = (
            votes[pick], wlo[pick], whi[pick], anchor[pick],
        )
        chosen = [oriented[int(p)] for p in pick]
        strands = ["-" if rc else "+" for rc in use_rc]
    else:
        chosen = oriented
        strands = ["+"] * B

    total = int(index.starts[-1])
    # Whole-batch window math (the per-read loop paid a searchsorted
    # + a handful of int conversions per read — ~1 s at 100k reads):
    # the widened window can straddle a contig boundary; the anchor —
    # a real hit position from the winning bins — names the
    # supporting contig, and the window is clipped to it.
    starts_a = np.asarray(index.starts, np.int64)
    # anchor == -1 (no in-cap seed hits) never yields a window — the
    # clip below only keeps the contig gather in bounds for those
    # rows; the keep mask drops them regardless of min_seeds.
    cids = (
        np.searchsorted(
            starts_a, np.clip(anchor, 0, None), "right"
        ).astype(np.int64)
        - 1
    )
    cids = np.clip(cids, 0, max(len(starts_a) - 2, 0))
    c0s = starts_a[cids]
    c1s = starts_a[np.minimum(cids + 1, len(starts_a) - 1)]
    ws_a = np.maximum(np.maximum(wlo - band, 0), c0s)
    we_a = np.minimum(
        np.minimum(whi + lens[: len(whi)] + band, total), c1s
    )
    keep = (votes >= min_seeds) & (anchor >= 0) & (we_a > ws_a)
    mapped_ix, win_seqs, win_starts, win_contig = [], [], [], []
    for i in np.flatnonzero(keep):
        cid = int(cids[i])
        c0 = int(c0s[i])
        ws, we = int(ws_a[i]), int(we_a[i])
        contig = index.refs[cid]
        win_seqs.append(
            Sequence(contig.name, contig.sequence[ws - c0 : we - c0].upper())
        )
        win_starts.append(ws - c0)
        win_contig.append(contig)
        mapped_ix.append(int(i))

    return ExtensionPlan(
        chosen, strands, votes, votes2,
        mapped_ix, win_seqs, win_starts, win_contig,
    )


def map_reads(
    queries: list[Sequence],
    ref: Sequence | list[Sequence],
    scores: Scores,
    *,
    index: KmerIndex | None = None,
    k: int = 21,
    stride: int | None = None,
    band: int = 32,
    max_hits: int = 64,
    min_seeds: int = 2,
    both_strands: bool = True,
    engine: str = "auto",
    seed_engine: str = "host",
    with_paths: bool = False,
    batch: int = 4096,
) -> list[MappedRead]:
    """Map ``queries`` against ``ref``; results keep input order.

    ``ref`` may be one contig or a list (a multi-FASTA assembly);
    votes ride one global concatenated coordinate space, the winning
    window is clipped to its owning contig, and each result's
    ``contig``/``mapinfo`` are contig-relative — ready for the SAM
    writer. ``stride`` samples every stride-th read k-mer as a seed
    (default ``max(1, k // 2)`` — two seeds cover any exact match of
    length ``>= k + stride``); ``min_seeds`` is the vote threshold
    below which a read is reported unmapped without an extension
    dispatch. Pass a prebuilt ``index`` to amortize it across calls
    (its ``k`` then wins). ``seed_engine="device"`` votes on the
    accelerator via the fixed-shape jitted twin (requires ``k <= 15``;
    bit-identical to the host engine).

    Extension windows are ``read_len + 4*band`` wide
    (:func:`plan_extensions`).
    """
    if band < 1:
        raise ValueError(f"band={band} must be >= 1 (diagonal bin width)")
    if max_hits < 1:
        raise ValueError(f"max_hits={max_hits} must be >= 1")
    refs = [ref] if isinstance(ref, Sequence) else list(ref)
    if index is None:
        index = KmerIndex(refs, k)
    if len(index.refs) != len(refs) or any(
        a.sequence is not b.sequence and a.sequence != b.sequence
        for a, b in zip(index.refs, refs)
    ):
        raise ValueError("index was built for a different reference")
    k = index.k
    stride = max(1, k // 2) if stride is None else max(1, stride)
    B = len(queries)
    if B == 0:
        return []
    plan = plan_extensions(
        queries,
        index,
        stride=stride,
        band=band,
        max_hits=max_hits,
        min_seeds=min_seeds,
        both_strands=both_strands,
        seed_engine=seed_engine,
    )
    chosen, strands, votes, votes2 = (
        plan.chosen, plan.strands, plan.votes, plan.votes2
    )
    mapped_ix, win_seqs, win_starts, win_contig = (
        plan.mapped_ix, plan.win_seqs, plan.win_starts, plan.win_contig
    )

    ext: dict[int, tuple] = {}
    if mapped_ix:
        aligned, cigars, mapinfo = align_reads(
            [chosen[i] for i in mapped_ix],
            win_seqs,
            scores,
            is_local=True,
            engine=engine,
            with_paths=with_paths,
            with_cigars=True,
            with_mapinfo=True,
            batch=batch,
        )
        for j, i in enumerate(mapped_ix):
            i0, j0, ei, ej = mapinfo[j]
            ws = win_starts[j]
            ext[i] = (
                aligned[j],
                cigars[j],
                (i0, j0 + ws, ei, ej + ws),
                win_contig[j],
            )

    out: list[MappedRead] = []
    for i in range(B):
        q = chosen[i]
        if i in ext and "M" in ext[i][1]:
            a, cg, info, contig = ext[i]
            out.append(
                MappedRead(
                    read=q,
                    contig=contig,
                    strand=strands[i],
                    mapped=True,
                    score=a.score,
                    mapinfo=info,
                    cigar=cg,
                    aligned=a,
                    seeds=int(votes[i]),
                    mapq=min(60, 6 * int(votes[i] - votes2[i])),
                )
            )
        else:
            # Unmapped: no candidate window, OR an extension whose
            # walk is a zero-plateau pure-D/I run (reference local
            # quirk — no aligned block). Emitted with the ORIGINAL
            # read and forward strand: orientation is meaningless for
            # an unmapped record, and an RC SEQ with no 0x10 flag
            # would reconstruct the wrong-strand read downstream.
            empty = AlignedSequences(
                s1=queries[i],
                s2=Sequence(refs[0].name, ""),
                alignment=[],
                score=0,
                matches=0,
                mismatches=0,
                gap_extensions=0,
                opening_gaps=0,
            )
            out.append(
                MappedRead(
                    read=queries[i],
                    contig=refs[0],
                    strand="+",
                    mapped=False,
                    score=0,
                    mapinfo=(0, 0, 0, 0),
                    cigar="",
                    aligned=empty,
                    seeds=int(votes[i]),
                    mapq=0,
                )
            )
    return out


def map_pairs(
    reads1: list[Sequence],
    reads2: list[Sequence],
    ref: Sequence | list[Sequence],
    scores: Scores,
    **kwargs,
) -> tuple[list[MappedRead], list[MappedRead]]:
    """Map both ends of a paired-end library (framework extension).

    ``reads1[i]`` and ``reads2[i]`` are mates. Both ends ride the same
    prebuilt index and the same batched machinery; pairing itself is
    pure SAM bookkeeping, done in :func:`write_sam_paired`.
    """
    if len(reads1) != len(reads2):
        raise ValueError(
            f"mate count mismatch: {len(reads1)} vs {len(reads2)}"
        )
    refs = [ref] if isinstance(ref, Sequence) else list(ref)
    if kwargs.get("index") is None:
        kwargs["index"] = KmerIndex(refs, kwargs.pop("k", 21))
    else:
        kwargs.pop("k", None)
    res1 = map_reads(reads1, refs, scores, **kwargs)
    res2 = map_reads(reads2, refs, scores, **kwargs)
    return res1, res2


def write_sam_paired(
    path: str,
    res1: list[MappedRead],
    res2: list[MappedRead],
    header_refs: list[Sequence] | None = None,
    max_insert: int = 1000,
) -> int:
    """Write mate-annotated SAM records for paired mapping results.

    Pair flags follow SAM 1.6: 0x1 on every record, 0x40/0x80 for
    first/second of pair, 0x8/0x20 mirror the mate's unmapped/strand
    state, and 0x2 (proper pair) is set when both ends map to the same
    contig on opposite strands in FR orientation (the forward end
    starts at or left of the reverse end's start) with an outer
    distance <= ``max_insert``. RNEXT is ``=`` for same-contig mates,
    PNEXT the mate's folded POS, and TLEN the signed outer distance
    (+ on the leftmost record, - on the rightmost, 0 when undefined).
    Records interleave (R1, R2) per template. Returns the number of
    proper pairs.
    """
    from genomics_rs_tpu.models.reads import (
        _sam_header,
        _sam_line,
        sam_records,
    )

    def records(res):
        return sam_records(
            [r.contig for r in res],
            [r.aligned for r in res],
            [r.cigar for r in res],
            [r.mapinfo for r in res],
            [r.strand for r in res],
            [r.mapq for r in res],
        )

    if len(res1) != len(res2):
        raise ValueError(
            f"mate count mismatch: {len(res1)} vs {len(res2)}"
        )
    rec1, rec2 = records(res1), records(res2)
    proper = 0
    with open(path, "w") as f:
        f.write(
            _sam_header(
                [r.contig for r in res1 + res2], header_refs
            )
        )
        for a, b in zip(rec1, rec2):
            a["flag"] |= 0x1 | 0x40
            b["flag"] |= 0x1 | 0x80
            for me, mate in ((a, b), (b, a)):
                if not mate["mapped"]:
                    me["flag"] |= 0x8
                if mate["flag"] & 0x10:
                    me["flag"] |= 0x20
            is_proper = False
            tlen_a = tlen_b = 0
            if a["mapped"] and b["mapped"] and a["rname"] == b["rname"]:
                fwd, rev = (a, b) if not a["flag"] & 0x10 else (b, a)
                lo = min(a["pos"], b["pos"])
                hi = max(a["ref_end"], b["ref_end"])
                outer = hi - lo + 1
                is_proper = (
                    (a["flag"] & 0x10) != (b["flag"] & 0x10)
                    and fwd["pos"] <= rev["pos"]
                    and outer <= max_insert
                )
                # Signed TLEN on any same-contig pair, proper or not.
                if a["pos"] < b["pos"] or (
                    a["pos"] == b["pos"] and a["ref_end"] <= b["ref_end"]
                ):
                    tlen_a, tlen_b = outer, -outer
                else:
                    tlen_a, tlen_b = -outer, outer
            if is_proper:
                a["flag"] |= 0x2
                b["flag"] |= 0x2
                proper += 1
            for me, mate, tl in ((a, b, tlen_a), (b, a, tlen_b)):
                if mate["mapped"]:
                    rnext = (
                        "=" if mate["rname"] == me["rname"] and me["mapped"]
                        else mate["rname"]
                    )
                    pnext = mate["pos"]
                else:
                    rnext, pnext = "*", 0
                f.write(_sam_line(me, rnext, pnext, tl))
    return proper
