"""Device-side compute ops: Gotoh DP fills, traceback, BWT.

The fills are plain JAX (``gotoh_scan``: anti-diagonal ``lax.scan``;
``gotoh_tile``: its boundary-injected tile twin; ``gotoh_matrix``:
full substitution matrices) compiled by XLA; ``engine`` resolves the
``engine=`` names every driver takes.
"""

from genomics_rs_tpu.ops.bwt_device import bwt_device, suffix_array
from genomics_rs_tpu.ops.gotoh_scan import FillResult, gotoh_fill_scan
from genomics_rs_tpu.ops.gotoh_tile import tile_fill
from genomics_rs_tpu.ops.traceback import (
    AlignedSequences,
    AlignmentChoice,
    classify_moves,
    traceback_host,
)

__all__ = [
    "FillResult",
    "gotoh_fill_scan",
    "tile_fill",
    "AlignedSequences",
    "AlignmentChoice",
    "classify_moves",
    "traceback_host",
    "bwt_device",
    "suffix_array",
]
