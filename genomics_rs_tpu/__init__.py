"""genomics_rs_tpu — an accelerator computational-genomics framework.

A from-scratch JAX/XLA rebuild of the capabilities of the
``genomics-rs`` reference (pairwise global/local alignment with affine
gaps, suffix trees + BWT, all-pairs genome comparison):

* the Gotoh three-matrix DP fill is expressed over anti-diagonal
  wavefronts (``lax.scan``, compiled by XLA),
* traceback is reconstructed from compact direction codes (the
  reference materialises 48 B/cell — we store one byte, or 2 bits
  packed),
* batches of sequence pairs are ``vmap``-ed and sharded over a
  ``jax.sharding.Mesh`` with ``shard_map``; stats merge with XLA
  collectives,
* the pointer-chasing suffix-tree/BWT subsystem stays host-side with a
  C++ core.

Public surface mirrors the reference library facade
(``/root/reference/src/lib.rs:3-6``): ``alignment``-style ops, config,
sequence IO and the suffix tree are importable without the CLI.
"""

from genomics_rs_tpu.config import Config, Scores, get_config
from genomics_rs_tpu.ops.subst import (
    SubstMatrix,
    blosum62,
    get_matrix,
    load_matrix_file,
)
from genomics_rs_tpu.sequence import Sequence, SequenceContainer

__all__ = [
    "Config",
    "Scores",
    "get_config",
    "Sequence",
    "SequenceContainer",
    "SubstMatrix",
    "blosum62",
    "get_matrix",
    "load_matrix_file",
]

__version__ = "0.1.0"
