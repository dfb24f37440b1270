"""Pairwise aligner: the user-facing alignment API.

Combines the device wavefront fill (``ops/gotoh_scan``) with the host
traceback, mirroring the ``alignment_table`` + ``retrace``
pipeline of the reference (``/root/reference/src/alignment/algo.rs``)
while staying fully jit-compiled on device for the O(m*n) part.

Sequences are padded to multiples of ``PAD_MULTIPLE`` so recompilation
only happens per length bucket, not per pair.
"""

from __future__ import annotations

import functools
import logging

import jax
import numpy as np

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.engine import resolve_engine
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.ops.traceback import AlignedSequences, traceback_host
from genomics_rs_tpu.sequence import (
    PAD_S1,
    PAD_S2,
    Sequence,
    SequenceContainer,
    round_up,
)
from genomics_rs_tpu.utils.profiling import PhaseTimer, spinner

log = logging.getLogger(__name__)

PAD_MULTIPLE = 128


@functools.partial(jax.jit, static_argnames=("is_local", "emit_dirs"))
def _fill(
    s1e,
    s2e,
    m,
    n,
    scores: Scores,
    is_local: bool,
    emit_dirs: bool = True,
    subst_lut=None,
):
    return gotoh_fill_scan(
        s1e,
        s2e,
        m,
        n,
        scores,
        is_local,
        emit_dirs=emit_dirs,
        subst_lut=subst_lut,
    )


class PairwiseAligner:
    """Global (Needleman-Wunsch) / local (Smith-Waterman) affine-gap aligner.

    Args:
      scores: scoring parameters (``scores.s_transition`` turns on
        kimura transition scoring).
      is_local: local vs global alignment.
      engine: a fill engine name, resolved by
        :func:`genomics_rs_tpu.ops.engine.resolve_engine`.
      matrix: optional full substitution matrix (``SubstMatrix``,
        e.g. ``get_matrix("BLOSUM62")``) for protein alignment — an
        extension (the reference scores two values only,
        ``algo.rs:245-248``); mutually exclusive with
        ``s_transition``. Gap costs still come from ``scores``.

    The fill writes one uint8 direction code per cell,
    (Lm+Ln+1) x (Lm+1) bytes on the device (about 1.8 GB for a pair
    of 30 kb genomes), which is copied to the host and walked there.
    """

    def __init__(
        self,
        scores: Scores,
        is_local: bool = False,
        engine: str = "auto",
        matrix=None,
    ):
        self.scores = scores
        self.is_local = is_local
        self.engine = resolve_engine(engine)
        self.matrix = matrix
        self._lut = None
        if matrix is not None:
            if getattr(scores, "s_transition", None) is not None:
                raise ValueError(
                    "matrix and scores.s_transition are mutually "
                    "exclusive"
                )
            self._lut = np.ascontiguousarray(
                matrix.byte_lut(), dtype=np.int32
            )

    def _encode(self, seq1: Sequence, seq2: Sequence):
        m, n = len(seq1), len(seq2)
        Lm = max(round_up(m, PAD_MULTIPLE), PAD_MULTIPLE)
        Ln = max(round_up(n, PAD_MULTIPLE), PAD_MULTIPLE)
        s1e = seq1.encoded(pad_to=Lm, pad_value=PAD_S1)
        s2e = seq2.encoded(pad_to=Ln, pad_value=PAD_S2)
        return s1e, s2e, m, n

    def align(self, seq1: Sequence, seq2: Sequence) -> AlignedSequences:
        s1e, s2e, m, n = self._encode(seq1, seq2)
        if self.matrix is not None:
            from genomics_rs_tpu.ops.subst import warn_unknown_bytes

            warn_unknown_bytes(
                self.matrix,
                np.concatenate([s1e[:m], s2e[:n]]),
                where="align",
            )

        timer = PhaseTimer("align")
        with spinner(
            "Computing sequence table...", "Sequence table computed"
        ), timer.span("fill table", cells=(m + 1.0) * (n + 1.0)):
            res = _fill(
                s1e,
                s2e,
                m,
                n,
                self.scores,
                self.is_local,
                subst_lut=self._lut,
            )
            jax.block_until_ready(res.score)
        with spinner(
            "Retracing optimal alignment...", "Retrace complete"
        ), timer.span("retrace"):
            dirs = np.asarray(res.dirs)
            out = traceback_host(
                dirs,
                int(res.start_i),
                int(res.start_j),
                int(res.score),
                seq1,
                seq2,
                self.is_local,
            )
        return out

    def score_only(self, seq1: Sequence, seq2: Sequence) -> int:
        """Alignment score without traceback: no direction table, so
        the fill needs only O(m+n) device memory."""
        s1e, s2e, m, n = self._encode(seq1, seq2)
        res = _fill(
            s1e,
            s2e,
            m,
            n,
            self.scores,
            self.is_local,
            emit_dirs=False,
            subst_lut=self._lut,
        )
        return int(res.score)


def align_batch(
    pairs: list[tuple[Sequence, Sequence]],
    scores: Scores,
    is_local: bool = False,
    engine: str = "auto",
    matrix=None,
) -> list[AlignedSequences]:
    """Full alignments (path + stats) for a list of pairs, in order.

    No reference analog (``algo.rs`` aligns one pair per process run).
    Each pair is aligned by :class:`PairwiseAligner`; pairs are padded
    to multiples of ``PAD_MULTIPLE``, so pairs of similar length share
    one compiled fill (pre-bucket very mixed lists with
    ``parallel/allpairs.bucketize_pairs``). ``matrix`` selects
    full-matrix (protein) scoring with gap costs from ``scores``.
    """
    if matrix is not None:
        scores = Scores(s_match=0, s_mismatch=0, g=scores.g, h=scores.h)
    aligner = PairwiseAligner(
        scores, is_local=is_local, engine=engine, matrix=matrix
    )
    return [aligner.align(a, b) for a, b in pairs]


def align_pair(
    container: SequenceContainer,
    scores: Scores,
    is_local: bool = False,
    engine: str = "auto",
    matrix=None,
) -> AlignedSequences:
    """Align the first two sequences of a container.

    Parity shim for the reference's Align mode entry
    (``/root/reference/src/main.rs:123-153`` — warns and uses only the
    first two sequences, ``algo.rs:161-163``).
    """
    if len(container.sequences) > 2:
        log.warning("More than two sequences found. Only the first two will be used.")
    aligner = PairwiseAligner(
        scores, is_local=is_local, engine=engine, matrix=matrix
    )
    return aligner.align(container.sequences[0], container.sequences[1])
