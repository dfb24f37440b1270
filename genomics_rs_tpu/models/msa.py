"""Center-star multiple sequence alignment on the device engines.

No reference counterpart: ``/root/reference`` stops at pairwise
alignment (``src/alignment/algo.rs``) and whole-corpus LCS similarity
(``src/main.rs:216-379``). This module composes those two capabilities
into a proper MSA:

1. **Center selection** — the all-pairs global score matrix comes from
   the batched device engines (one bucketed dispatch over the whole
   corpus, ``parallel/allpairs.py``); the center is the sequence with
   the maximum summed score against the rest (the classic center-star
   2-approximation pivot, argmax instead of argmin because these are
   similarity scores).
2. **Star alignments** — every other sequence is globally aligned to
   the center by :func:`~genomics_rs_tpu.models.aligner.align_batch`
   (one compiled fill shape per padded length).
3. **Merge** — "once a gap, always a gap": between two center chars
   (a "slot") the merged alignment carries the MAXIMUM of the gap
   runs any pairwise alignment put there, each row's inserted chars
   first and padding after — provably identical to the sequential
   two-pointer merge (``_merge_center``, kept as the test oracle),
   but built in O(width) numpy per row instead of re-spelling every
   previous row on every merge. Each row's projection against the
   center reproduces its pairwise alignment exactly (pinned by
   ``tests/test_msa.py``).

Ties in center selection keep the smallest index (deterministic).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.aligner import align_batch
from genomics_rs_tpu.ops.traceback import AlignedSequences, AlignmentChoice
from genomics_rs_tpu.sequence import SequenceContainer
from genomics_rs_tpu.utils.profiling import PhaseTimer

log = logging.getLogger(__name__)

_GAP = "-"


@dataclasses.dataclass
class MSAResult:
    """A finished multiple alignment.

    ``rows[k]`` is the gapped row for ``names[k]`` — all rows share one
    length, and removing the gaps recovers the input sequences
    verbatim.
    """

    names: list[str]
    rows: list[str]
    center_index: int
    #: [j][i] = global score for i <= j (lower triangle, like
    #: AllPairsResult.matrix).
    score_matrix: np.ndarray

    @property
    def width(self) -> int:
        return len(self.rows[0]) if self.rows else 0

    def conservation(self) -> str:
        """'*' where a column is gap-free and fully identical."""
        out = []
        for col in zip(*self.rows):
            first = col[0]
            out.append(
                "*"
                if first != _GAP and all(ch == first for ch in col)
                else " "
            )
        return "".join(out)


def _alignment_ops(aln: AlignedSequences) -> str:
    """Forward per-column ops of a pairwise alignment.

    'M' consumes a char of both sequences, 'I' only of s2 (gap in s1),
    'D' only of s1 (gap in s2) — the display convention
    (``display/alignment.py``).
    """
    C = AlignmentChoice
    ops = []
    for choice, _, _ in reversed(aln.alignment):
        if choice in (C.INSERT, C.OPEN_INSERT):
            ops.append("I")
        elif choice in (C.DELETE, C.OPEN_DELETE):
            ops.append("D")
        else:
            ops.append("M")
    return "".join(ops)


def _gapped_pair(center: str, other: str, ops: str) -> tuple[str, str]:
    """Expand an op string into the two gapped row strings."""
    ci = oi = 0
    crow: list[str] = []
    orow: list[str] = []
    for op in ops:
        if op == "I":
            crow.append(_GAP)
        else:
            crow.append(center[ci])
            ci += 1
        if op == "D":
            orow.append(_GAP)
        else:
            orow.append(other[oi])
            oi += 1
    if ci != len(center) or oi != len(other):
        raise AssertionError(
            "pairwise alignment did not consume both sequences "
            f"({ci}/{len(center)}, {oi}/{len(other)})"
        )
    return "".join(crow), "".join(orow)


def write_pair_fasta(path: str, aln: AlignedSequences, is_local: bool):
    """Write one pairwise alignment as a 2-record gapped FASTA.

    A global alignment spells both sequences whole. A local alignment
    covers a region, not the whole pair: the gapped REGION is written
    with ``span=start-end`` (0-based, end exclusive) in each header —
    the retrace start cell (``alignment[0]``) is the region end.
    Headers carry ``score=`` (60-column wrapped rows).
    """
    ops = _alignment_ops(aln)
    s1, s2 = aln.s1.sequence, aln.s2.sequence
    if is_local:
        n1 = sum(1 for o in ops if o in "MD")
        n2 = sum(1 for o in ops if o in "MI")
        si = aln.alignment[0][1] if aln.alignment else 0
        sj = aln.alignment[0][2] if aln.alignment else 0
        rowa, rowb = _gapped_pair(s1[si - n1 : si], s2[sj - n2 : sj], ops)
        spans = (f" span={si - n1}-{si}", f" span={sj - n2}-{sj}")
    else:
        rowa, rowb = _gapped_pair(s1, s2, ops)
        spans = ("", "")
    with open(path, "w") as f:
        for name, row, span in (
            (aln.s1.name, rowa, spans[0]),
            (aln.s2.name, rowb, spans[1]),
        ):
            f.write(f">{name} score={aln.score}{span}\n")
            for p0 in range(0, len(row), 60):
                f.write(row[p0 : p0 + 60] + "\n")


def _merge_center(
    master: str, rows: list[str], new_center: str, new_row: str
) -> tuple[str, list[str], str]:
    """Merge a gapped center into the master (once a gap, always a gap).

    ``master`` and ``new_center`` are two gapped spellings of the SAME
    center sequence; the merged center takes a gap wherever either
    has one (aligned gap columns are shared). Returns the merged
    center, the re-padded existing rows, and the padded new row.
    """
    a = b = 0
    merged: list[str] = []
    # Per existing row and the new row: which source column feeds each
    # merged column (-1 = inserted gap).
    take_a: list[int] = []
    take_b: list[int] = []
    la, lb = len(master), len(new_center)
    while a < la or b < lb:
        ca = master[a] if a < la else None
        cb = new_center[b] if b < lb else None
        if ca is not None and cb is not None and (ca == cb or (ca != _GAP and cb != _GAP)):
            # Same center char (they must match — both spell the
            # center) or two aligned gap columns.
            merged.append(ca)
            take_a.append(a)
            take_b.append(b)
            a += 1
            b += 1
        elif ca == _GAP or cb is None:
            # master has an extra gap column here: pad the new row.
            merged.append(_GAP)
            take_a.append(a)
            take_b.append(-1)
            a += 1
        else:
            # new alignment opened a gap the master lacks: pad master
            # and every existing row.
            merged.append(_GAP)
            take_a.append(-1)
            take_b.append(b)
            b += 1
    out_rows = [
        "".join(r[i] if i >= 0 else _GAP for i in take_a) for r in rows
    ]
    padded_new = "".join(
        new_row[i] if i >= 0 else _GAP for i in take_b
    )
    return "".join(merged), out_rows, padded_new


def _build_rows(
    center: str, others: list[str], ops_list: list[str]
) -> tuple[str, list[str]]:
    """Merged MSA rows from per-pair op strings (slot-count merge).

    Slot p is the gap run between center chars p-1 and p (slot 0
    before the first, slot C after the last). The merged width gives
    every slot the max run over all pairs; each row places its own
    inserted chars at the head of the slot and pads the rest — the
    exact column layout the sequential two-pointer merge
    (``_merge_center``) produces, in O(width) numpy per row.
    """
    C = len(center)
    K1 = len(others)
    gaps = np.zeros((K1, C + 1), np.int64)
    parsed = []
    for k, ops in enumerate(ops_list):
        opsb = np.frombuffer(ops.encode("latin-1"), np.uint8)
        isI = opsb == ord("I")
        ccex = np.concatenate([[0], np.cumsum(~isI)[:-1]])
        slots = ccex[isI]
        gaps[k] = np.bincount(slots, minlength=C + 1)
        parsed.append((opsb, isI, ccex, slots))
    M = gaps.max(axis=0) if K1 else np.zeros(C + 1, np.int64)
    W = C + int(M.sum())
    preM = np.concatenate([[0], np.cumsum(M)])
    base = np.arange(C + 1) + preM[:-1]  # slot p's first column
    pos_center = base[:C] + M[:C]  # center char p's column
    center_b = np.frombuffer(center.encode("latin-1"), np.uint8)
    master = np.full(W, ord(_GAP), np.uint8)
    master[pos_center] = center_b
    rows: list[str] = []
    for (opsb, isI, ccex, slots), other in zip(parsed, others):
        if (~isI).sum() != C:
            raise AssertionError(
                "pairwise alignment did not consume the center "
                f"({int((~isI).sum())}/{C})"
            )
        other_b = np.frombuffer(other.encode("latin-1"), np.uint8)
        noD = opsb != ord("D")
        if noD.sum() != len(other):
            raise AssertionError(
                "pairwise alignment did not consume the row sequence "
                f"({int(noD.sum())}/{len(other)})"
            )
        oiex = np.concatenate([[0], np.cumsum(noD)[:-1]])
        out = np.full(W, ord(_GAP), np.uint8)
        cops = opsb[~isI]  # the op consuming each center char
        m_mask = cops == ord("M")
        out[pos_center[m_mask]] = other_b[oiex[~isI][m_mask]]
        # I-run chars go at the head of their slot, in run order.
        rank = np.arange(len(slots)) - np.searchsorted(slots, slots)
        out[base[slots] + rank] = other_b[oiex[isI]]
        rows.append(out.tobytes().decode("latin-1"))
    return master.tobytes().decode("latin-1"), rows


def center_star_msa(
    container: SequenceContainer,
    scores: Scores,
    engine: str = "auto",
    matrix=None,
) -> MSAResult:
    """Multiple alignment of every sequence in ``container``.

    The pairwise score pass runs as batched device dispatches
    (``allpairs_scores``); the K-1 star alignments run through
    :func:`~genomics_rs_tpu.models.aligner.align_batch` (global mode).

    ``matrix`` (a ``SubstMatrix``) switches to full-matrix scoring —
    protein MSA: the score pass uses the batched matrix engine
    (``allpairs_matrix_scores``) and the star alignments the matrix
    aligner; gap costs still come from ``scores.g``/``scores.h``.
    """
    from genomics_rs_tpu.parallel.allpairs import allpairs_scores

    seqs = container.sequences
    if not seqs:
        raise ValueError("msa needs at least one sequence")
    names = [s.name for s in seqs]
    if len(seqs) == 1:
        return MSAResult(
            names, [seqs[0].sequence], 0, np.zeros((1, 1), np.int64)
        )

    with PhaseTimer("msa").span("compute the pairwise score matrix"):
        if matrix is not None:
            from genomics_rs_tpu.parallel.allpairs import (
                allpairs_matrix_scores,
            )

            ap = allpairs_matrix_scores(
                container, matrix, g=scores.g, h=scores.h,
                is_local=False,
            )
        else:
            ap = allpairs_scores(
                container, scores, is_local=False, engine=engine
            )
    # Symmetrize the lower triangle (diagonal self-scores excluded
    # from the center sum: constant offset per row ranking otherwise).
    mat = ap.matrix
    full = mat + mat.T
    np.fill_diagonal(full, 0)
    sums = full.sum(axis=1)
    center = int(np.argmax(sums))
    log.info(
        "MSA center: %s (summed score %d)", names[center], sums[center]
    )

    cseq = seqs[center]
    order = [k for k in range(len(seqs)) if k != center]
    others = [seqs[k] for k in order]
    with PhaseTimer("msa").span("align the corpus to the center"):
        ops_list = [
            _alignment_ops(al)
            for al in align_batch(
                [(cseq, o) for o in others],
                scores,
                is_local=False,
                engine=engine,
                matrix=matrix,
            )
        ]
        master, rows = _build_rows(
            cseq.sequence, [o.sequence for o in others], ops_list
        )

    # Rows back in corpus order, center included.
    all_rows = [""] * len(seqs)
    all_rows[center] = master
    for pos, k in enumerate(order):
        all_rows[k] = rows[pos]
    return MSAResult(names, all_rows, center, mat)


def write_msa_fasta(result: MSAResult, path: str) -> None:
    """Aligned-FASTA output (60-column wrapped)."""
    with open(path, "w") as f:
        for name, row in zip(result.names, result.rows):
            f.write(f">{name}\n")
            for i in range(0, len(row), 60):
                f.write(row[i : i + 60] + "\n")


def format_msa_clustal(result: MSAResult, width: int = 60) -> str:
    """CLUSTAL-style block rendering with a conservation line."""
    cons = result.conservation()
    namew = max((len(n) for n in result.names), default=0)
    namew = min(max(namew, 10), 30)
    lines = ["genomics_rs_tpu multiple sequence alignment", ""]
    for start in range(0, result.width, width):
        for name, row in zip(result.names, result.rows):
            lines.append(
                f"{name[:namew]:<{namew}}  {row[start:start + width]}"
            )
        lines.append(f"{'':<{namew}}  {cons[start:start + width]}")
        lines.append("")
    return "\n".join(lines)
