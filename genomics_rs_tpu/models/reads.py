"""Batched short-read alignment with full per-read tracebacks.

The reference aligns exactly one pair per process run
(``/root/reference/src/main.rs:123-153``); the score-only read batches
(``parallel/batch.score_pairs``) extend that to thousands of pairs but
return only (score, end). This driver completes the read-mapping use
case: every read gets its full alignment — path, stats, CIGAR — with
the whole O(m*n) fill AND the O(m+n) walks batched on device:

* the fill is a ``vmap``-ed wavefront scan that emits one uint8
  direction code per cell;
* every read's traceback is walked in lockstep by ONE device dispatch
  (``ops/traceback_batch.walk_batch`` — a ``lax.scan`` whose state is
  (i, j, done) per read), so no bitmap ever reaches the host;
* classification (reference quirks: ``is_match`` off-by-one,
  open-vs-extend ``last_choice``) is whole-batch numpy
  (``ops/traceback_batch.classify_batch``) — per-read results are
  bit-identical to ``PairwiseAligner.align`` on that pair (pinned by
  tests).

CIGAR convention (query = s1 vs reference = s2): ``M`` consumes both
(match or mismatch), ``I`` consumes only the query (the DP's DELETE
move, gap in s2), ``D`` consumes only the reference (the DP's INSERT
move, gap in s1).
"""

from __future__ import annotations

import functools
import logging

import numpy as np

import jax

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.engine import resolve_engine
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.ops.traceback import (
    AlignedSequences,
    AlignmentChoice,
)
from genomics_rs_tpu.ops.traceback_batch import classify_batch, walk_batch
from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence, round_up

log = logging.getLogger(__name__)


@functools.partial(jax.jit, static_argnames=("is_local",))
def _fill_batch(s1b, s2b, ms, ns, scores: Scores, is_local: bool):
    def one(s1e, s2e, m, n):
        res = gotoh_fill_scan(s1e, s2e, m, n, scores, is_local)
        return res.dirs, res.score, res.start_i, res.start_j

    return jax.vmap(one, in_axes=(0, 0, 0, 0))(s1b, s2b, ms, ns)


def cigar(aligned: AlignedSequences) -> str:
    """Run-length CIGAR string (query = s1) from the move path."""
    ops = []
    for choice, _, _ in reversed(aligned.alignment):
        if choice in (AlignmentChoice.MATCH, AlignmentChoice.MISMATCH):
            op = "M"
        elif choice in (
            AlignmentChoice.DELETE,
            AlignmentChoice.OPEN_DELETE,
        ):
            op = "I"  # consumes only the query (gap in s2)
        else:
            op = "D"  # consumes only the reference (gap in s1)
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return "".join(f"{count}{op}" for op, count in ops)


def _sam_token(name: str) -> str:
    """SAM QNAME/RNAME cannot contain whitespace; a bare ``>``/``@``
    header yields ``name == ""`` and split() then has no tokens."""
    parts = name.split()
    return parts[0] if parts else "*"


def sam_records(
    refs: list[Sequence],
    aligned: list[AlignedSequences],
    cigars: list[str],
    mapinfo: list[tuple[int, int, int, int]],
    strands: list[str] | None = None,
    mapqs: list[int] | None = None,
) -> list[dict]:
    """Per-read SAM record fields (before mate annotation / writing).

    Each dict carries ``qname, flag, rname, pos, cigar, seq, qual,
    score, mapped, ref_end`` — ``pos`` is 1-based after edge folding,
    ``ref_end`` the 1-based inclusive last reference column the CIGAR
    consumes (0 when unmapped). ``flag`` holds only 0x4/0x10 here;
    pairing layers OR in their bits before writing.

    Edge normalization: the reference's local termination quirk
    (``algo.rs:351-405`` — a zero cell still takes a move when an arm
    matches) can walk through zero-score plateaus, yielding paths that
    begin/end with D or I runs. SAM forbids clip-adjacent D and
    records gain nothing from them, so edge D runs are folded into POS
    and edge I runs into the soft clips; the TSV/path outputs keep the
    raw reference-faithful walk.
    """
    import re

    out = []
    for k, a in enumerate(aligned):
        qname = _sam_token(a.s1.name)
        seq = a.s1.sequence or "*"
        qual = a.s1.quality or "*"
        i0, j0, end_i, _ = mapinfo[k]
        runs = [
            [int(n), op]
            for n, op in re.findall(r"(\d+)([MID])", cigars[k])
        ]
        pos = j0 + 1
        head_clip = i0
        tail_clip = len(a.s1) - end_i
        while runs and runs[0][1] != "M":
            n, op = runs.pop(0)
            if op == "D":
                pos += n
            else:
                head_clip += n
        while runs and runs[-1][1] != "M":
            n, op = runs.pop()
            if op == "I":
                tail_clip += n
        if not runs:
            out.append(
                dict(
                    qname=qname, flag=4, rname="*", pos=0, cigar="*",
                    seq=seq, qual=qual, score=a.score, mapped=False,
                    ref_end=0, mapq=0,
                )
            )
            continue
        flag = 16 if strands is not None and strands[k] == "-" else 0
        head = f"{head_clip}S" if head_clip else ""
        tail = f"{tail_clip}S" if tail_clip > 0 else ""
        cig = head + "".join(f"{n}{op}" for n, op in runs) + tail
        ref_len = sum(n for n, op in runs if op in ("M", "D"))
        out.append(
            dict(
                qname=qname, flag=flag, rname=_sam_token(refs[k].name),
                pos=pos, cigar=cig, seq=seq, qual=qual, score=a.score,
                mapped=True, ref_end=pos + ref_len - 1,
                # 255 = "MAPQ unavailable" unless the caller supplies
                # a real value (the mapper's seed-margin heuristic).
                mapq=255 if mapqs is None else int(mapqs[k]),
            )
        )
    return out


def _sam_header(
    refs: list[Sequence], header_refs: list[Sequence] | None
) -> str:
    sq: dict[str, int] = {}
    # header_refs (when given) lists the FULL reference set so @SQ
    # covers contigs no read mapped to; per-read refs follow so any
    # record's RNAME is guaranteed declared.
    for r in (header_refs or []) + list(refs):
        name = _sam_token(r.name)
        if sq.setdefault(name, len(r)) != len(r):
            raise ValueError(
                f"distinct references share SAM RNAME {name!r} with "
                "different lengths — rename them (RNAME is the "
                "header's first whitespace token)"
            )
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    lines += [f"@SQ\tSN:{n}\tLN:{ln}" for n, ln in sq.items()]
    lines.append("@PG\tID:genomics_rs_tpu\tPN:genomics_rs_tpu")
    return "\n".join(lines) + "\n"


def _sam_line(r: dict, rnext="*", pnext=0, tlen=0) -> str:
    return (
        f"{r['qname']}\t{r['flag']}\t{r['rname']}\t{r['pos']}\t"
        f"{r['mapq']}\t{r['cigar']}\t{rnext}\t{pnext}\t"
        f"{tlen}\t{r['seq']}\t{r['qual']}\tAS:i:{r['score']}\n"
    )


def write_sam(
    path: str,
    refs: list[Sequence],
    aligned: list[AlignedSequences],
    cigars: list[str],
    mapinfo: list[tuple[int, int, int, int]],
    strands: list[str] | None = None,
    header_refs: list[Sequence] | None = None,
    mapqs: list[int] | None = None,
) -> None:
    """Write read alignments as SAM 1.6 (framework extension).

    One record per read: FLAG 16 marks a reverse-strand mapping (the
    record's SEQ/QUAL are then the reverse-complemented read, exactly
    what ``align_reads(both_strands=True)`` selected); a local
    alignment's unaligned query ends become soft clips around the
    M/I/D CIGAR; POS is the 1-based ref column after the walk end. A
    read whose local alignment is empty (score 0, empty CIGAR) is
    emitted unmapped (FLAG 4). AS:i carries the DP score. ``refs`` is
    the per-read reference list — @SQ lines are deduped by name in
    first-appearance order. See :func:`sam_records` for the
    zero-plateau edge normalization.
    """
    with open(path, "w") as f:
        f.write(_sam_header(refs, header_refs))
        for r in sam_records(
            refs, aligned, cigars, mapinfo, strands, mapqs
        ):
            f.write(_sam_line(r))


def encode_batch(
    seqs: list[Sequence], pad_to: int, pad_value: int
) -> np.ndarray:
    """Stack per-sequence encodings, encoding each distinct object once.

    The single-ref mapper broadcast repeats the SAME ``Sequence``
    object B times; encoding per row would redo the byte translation
    B times. When every row is one object the result is a read-only
    ``np.broadcast_to`` view — no host-side duplication (the device
    transfer materializes the batch either way).
    """
    if not seqs:
        return np.zeros((0, pad_to), np.uint8)
    first = seqs[0]
    if all(s is first for s in seqs) and len(seqs) > 1:
        return np.broadcast_to(
            first.encoded(pad_to=pad_to, pad_value=pad_value),
            (len(seqs), pad_to),
        )
    # One pass over the joined bytes instead of per-sequence
    # frombuffer+concatenate calls (mapper profile: 200k encoded()
    # calls ~= 1 s per 50k-read batch).
    joined = np.frombuffer(
        "".join(s.sequence for s in seqs).encode("ascii"), np.uint8
    )
    lens = np.array([len(s.sequence) for s in seqs], np.int64)
    if lens.max(initial=0) > pad_to:
        raise ValueError(f"pad_to={pad_to} < longest sequence")
    out = np.full((len(seqs), pad_to), pad_value, np.uint8)
    L0 = int(lens[0])
    if (lens == L0).all():
        # Uniform lengths (the sequencing-read norm): a straight
        # reshape-copy — the ragged fancy-index scatter below costs
        # 3x the per-read encodes it replaces at 100k x 128 bp.
        out[:, :L0] = joined.reshape(len(seqs), L0)
        return out
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
        offs, lens
    )
    rowidx = np.repeat(np.arange(len(seqs), dtype=np.int64), lens)
    out[rowidx, within] = joined
    return out


#: Resident direction-table budget per round, bytes. The vmapped scan
#: emits a per-cell diag-major table of ``(L1+L2+1) * (L1+1)`` bytes
#: per read; rounds are sized to stay under this.
_SCAN_DIRS_BUDGET = 2 << 30


def align_reads(
    queries: list[Sequence],
    refs: list[Sequence],
    scores: Scores,
    is_local: bool = True,
    batch: int = 4096,
    engine: str = "auto",
    with_paths: bool = True,
    with_cigars: bool = False,
    both_strands: bool = False,
    with_mapinfo: bool = False,
):
    """Full alignments for query[i] vs ref[i], batched on device.

    Reads are chunked into ``batch``-sized device rounds (each round =
    one fill dispatch + one walk dispatch). Multi-round batches run
    software-pipelined one round deep: the next round's device work is
    dispatched before the previous round's results are transferred and
    classified, overlapping host classification with device compute
    (JAX dispatch is async; the round size is halved so two resident
    direction tables stay within the memory budget). ``engine`` is
    resolved by :func:`~genomics_rs_tpu.ops.engine.resolve_engine`.
    ``with_paths=False`` skips
    building each result's per-move ``alignment`` list — the remaining
    Python cost then scales with reads, not moves; pair it with
    ``with_cigars=True``, which returns ``(aligned, cigars)`` using
    the batch-vectorized CIGARs (an empty ``alignment`` yields nothing
    through :func:`cigar`). Output order matches input.

    ``both_strands=True`` additionally aligns each query's reverse
    complement in the SAME fill/walk dispatches (the round's device
    batch doubles; the round size is halved to keep memory flat) and
    keeps the better-scoring orientation, forward winning ties. The
    return value then grows a ``strands`` list of ``"+"``/``"-"``:
    ``(aligned, strands)`` or ``(aligned, cigars, strands)``. A
    ``"-"`` result's path/stats/CIGAR are those of the
    reverse-complemented query vs the ref, read-mapper style.

    ``with_mapinfo=True`` appends a list of per-read walk endpoints
    ``(i0, j0, end_i, end_j)`` in oriented-query coordinates — the
    aligned block spans query rows ``(i0, end_i]`` and ref columns
    ``(j0, end_j]`` (global mode: ``(0, 0, m, n)``). :func:`write_sam`
    consumes these for POS and soft clips. Optional returns always
    stack in the order ``aligned[, cigars][, strands][, mapinfo]``.
    """
    if len(refs) == 1 and len(queries) > 1:
        # Mapper convention: many reads against one reference.
        refs = refs * len(queries)
    if len(queries) != len(refs):
        raise ValueError(
            f"query/ref count mismatch: {len(queries)} vs {len(refs)}"
        )
    resolve_engine(engine)
    L1 = max(round_up(max((len(s) for s in queries), default=1), 128), 128)
    L2 = max(round_up(max((len(s) for s in refs), default=1), 128), 128)
    max_steps = L1 + L2 + 1
    # Bound the resident per-round direction-table memory.
    per_read = (L1 + L2 + 1) * (L1 + 1)
    batch = max(16, min(batch, _SCAN_DIRS_BUDGET // per_read))
    if both_strands:
        # The device batch doubles (forward + revcomp rows); halve the
        # round size so per-round memory stays within the same budget.
        batch = max(8, batch // 2)
    # Multi-round batches run software-pipelined: round k+1's fill and
    # walk are dispatched (async) before round k's results are pulled
    # home, so host-side classification overlaps device compute. Two
    # rounds' direction tables are then resident at once — halve the
    # round so the budget still holds.
    if len(queries) > batch:
        batch = max(16, batch // 2)

    out: list[AlignedSequences] = []
    all_cigars: list[str] = []
    all_strands: list[str] = []
    all_mapinfo: list[tuple[int, int, int, int]] = []

    def _fill_and_walk(s1x, s2x, msx, nsx):
        codes, sc, si, sj = _fill_batch(
            s1x, s2x, msx, nsx, scores, is_local
        )
        walked = walk_batch(
            codes, si, sj, "diag", max_steps, packed_moves=True
        )
        return walked + (sc, si, sj)

    def _dispatch(k0: int):
        qs = queries[k0 : k0 + batch]
        rs = refs[k0 : k0 + batch]
        b = len(qs)
        if both_strands:
            qs = qs + [q.reverse_complement() for q in qs]
            rs = rs + rs
        s1b = encode_batch(qs, L1, PAD_S1)
        s2b = encode_batch(rs, L2, PAD_S2)
        ms = np.array([len(s) for s in qs], dtype=np.int32)
        ns = np.array([len(s) for s in rs], dtype=np.int32)
        # Multi-chip: equal slices of the round by explicit device
        # placement (the device-loop pattern of
        # parallel.batch.device_loop_scores) — fills AND walks on all
        # local devices overlap via async dispatch, merged at harvest.
        devs = jax.local_devices()
        Bq = len(ms)
        if len(devs) > 1 and Bq >= 2 * len(devs):
            from genomics_rs_tpu.parallel.batch import pad_batch

            (s1p, s2p, mp, np_), Bp = pad_batch(
                (s1b, s2b, ms, ns), Bq, len(devs)
            )
            per = Bp // len(devs)
            parts = []
            for kd, d in enumerate(devs):
                sl = slice(kd * per, (kd + 1) * per)
                parts.append(
                    _fill_and_walk(
                        jax.device_put(np.ascontiguousarray(s1p[sl]), d),
                        jax.device_put(np.ascontiguousarray(s2p[sl]), d),
                        mp[sl],
                        np_[sl],
                    )
                )
        else:
            parts = [_fill_and_walk(s1b, s2b, ms, ns)]
        return (k0, b, qs, rs, s1b, s2b, ms, ns, parts)

    def _harvest(state) -> None:
        k0, b, qs, rs, s1b, s2b, ms, ns, parts = state
        Bq = len(ms)
        # One D2H transfer per device slice; trim the round padding.
        got = [jax.device_get(p) for p in parts]
        moves, counts, i_f, j_f, done, sc_h, si_h, sj_h = (
            np.concatenate([np.asarray(g[f]) for g in got])[:Bq]
            for f in range(8)
        )
        # Moves arrive 4-codes-per-byte (packed_moves); unpack only
        # the longest live prefix.
        from genomics_rs_tpu.ops.traceback_batch import unpack_moves4

        moves = unpack_moves4(
            moves, int(counts.max()) if len(counts) else 0
        )
        # A global retrace is complete only at (0, 0) — a mid-table
        # stop code there means a corrupt fill (the per-pair host
        # walker raises "Unexpected stop code during global retrace").
        complete = (
            done if is_local else done & (i_f == 0) & (j_f == 0)
        )
        if not bool(np.all(complete)):
            bad = int(np.flatnonzero(~np.asarray(complete))[0])
            # In a both-strands round, rows [b, 2b) are the revcomp
            # copies of reads [0, b) — report the source read index.
            which = f"read {k0 + bad % b}" + (
                " (revcomp row)" if both_strands and bad >= b else ""
            )
            raise RuntimeError(
                f"{which} retrace did not terminate at "
                f"({int(i_f[bad])}, {int(j_f[bad])})"
            )
        aligned, cigars = classify_batch(
            moves,
            counts,
            si_h,
            sj_h,
            sc_h,
            qs,
            rs,
            with_paths=with_paths,
            encoded=(s1b, s2b, ms, ns),
        )
        # Walk endpoints in oriented-query coords: the aligned block
        # spans query rows (i_f, si] and ref columns (j_f, sj] — all
        # zeros / (m, n) for a completed global retrace.
        info = np.stack(
            [np.asarray(x, dtype=np.int64) for x in (i_f, j_f, si_h, sj_h)],
            axis=1,
        )
        if both_strands:
            # Keep the better orientation per read; forward wins ties.
            use_rc = np.asarray(sc_h[b:]) > np.asarray(sc_h[:b])
            aligned = [
                aligned[b + i] if rc else aligned[i]
                for i, rc in enumerate(use_rc)
            ]
            cigars = [
                cigars[b + i] if rc else cigars[i]
                for i, rc in enumerate(use_rc)
            ]
            info = np.where(use_rc[:, None], info[b:], info[:b])
            all_strands.extend("-" if rc else "+" for rc in use_rc)
        out.extend(aligned)
        all_cigars.extend(cigars)
        if with_mapinfo:
            all_mapinfo.extend(
                (int(r[0]), int(r[1]), int(r[2]), int(r[3])) for r in info
            )

    # One-deep software pipeline: harvest round k only after round
    # k+1's device work is queued. Harvests run in round order, so
    # outputs keep the input order.
    pending = None
    for k0 in range(0, len(queries), batch):
        current = _dispatch(k0)
        if pending is not None:
            _harvest(pending)
        pending = current
    if pending is not None:
        _harvest(pending)
    ret = [out]
    if with_cigars:
        ret.append(all_cigars)
    if both_strands:
        ret.append(all_strands)
    if with_mapinfo:
        ret.append(all_mapinfo)
    if len(ret) == 1:
        return out
    return tuple(ret)
