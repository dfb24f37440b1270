"""DP fill engine names, resolved in one place.

Every driver (pairwise aligner, batch scoring, all-pairs, reads, MSA,
the sequence-parallel pipeline) takes an ``engine`` argument and
resolves it here, so the choice of fill for a given input is one
table instead of a test repeated in each module.

Today there is one engine: ``"scan"``, the anti-diagonal ``lax.scan``
wavefront (``ops/gotoh_scan.py``, ``ops/gotoh_tile.py``) that XLA
compiles for whatever backend JAX runs on. ``"auto"`` resolves to it.
"""

from __future__ import annotations

#: Engine names accepted by every ``engine=`` argument besides "auto".
ENGINES = ("scan",)

#: What the CLI's ``--engine`` flags offer.
ENGINE_CHOICES = ("auto",) + ENGINES


def resolve_engine(engine: str = "auto") -> str:
    """The concrete fill engine for ``engine``.

    ``"auto"`` picks the engine for the running backend; a concrete
    name is validated and returned unchanged. Unknown names raise
    ``ValueError`` (an unknown engine must never fall back silently).
    """
    if engine == "auto":
        return "scan"
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {ENGINE_CHOICES}"
        )
    return engine
