"""Scoring configuration.

TOML-compatible with the reference config format
(``/root/reference/src/config.rs:6-40``, ``config.toml:1-5``): a
``[scores]`` table with integer ``s_match``, ``s_mismatch``, ``g`` (gap
extension) and ``h`` (gap open).

``Scores`` is registered as a JAX pytree so it can be passed straight
through ``jit``/``vmap``/``shard_map`` boundaries; fields are Python
ints host-side and become int32 scalars on device.
"""

from __future__ import annotations

import dataclasses
import sys
import tomllib

import jax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scores:
    """Affine-gap scoring parameters.

    The total penalty of a gap of length L is ``h + L*g`` (both are
    usually negative), matching the reference recurrence
    (``/root/reference/src/alignment/algo.rs:231-247``).

    ``s_transition`` is an extension (the reference knows
    only match/mismatch, ``src/config.rs:6-18``): when set, DNA
    transitions (A<->G, C<->T) score ``s_transition`` and all other
    mismatches keep ``s_mismatch`` (Kimura-style two-class scoring).
    ``None`` (the default) is bit-exact reference behaviour — and a
    *structurally* different pytree, so jit compiles the classic
    kernels unchanged.

    Soft-masked input caveat: matching stays case-sensitive for
    reference parity (``sequence.rs:102-115`` — ``'a' != 'A'``), so
    cross-case pairs like ``'a'`` vs ``'G'`` are ordinary mismatches
    and score ``s_mismatch`` even when the base pair is biologically
    a transition; same-case transitions (``a<->g``, ``c<->t``,
    ``A<->G``, ``C<->T``) score ``s_transition``. Uppercase
    soft-masked FASTA before loading if cross-case transition scoring
    is wanted (``ops/subst.py`` module docs).
    """

    s_match: int = 1
    s_mismatch: int = -2
    g: int = -1  # gap extension
    h: int = -5  # gap open
    s_transition: int | None = None

    def as_tuple(self) -> tuple:
        """Hashable round-trippable form: ``Scores(*t)`` rebuilds it.

        Length 4 when classic (keeps every existing static-arg cache
        key stable), 5 with a transition score.
        """
        base = (self.s_match, self.s_mismatch, self.g, self.h)
        if self.s_transition is None:
            return base
        return base + (self.s_transition,)


@dataclasses.dataclass(frozen=True)
class Config:
    scores: Scores = dataclasses.field(default_factory=Scores)


def get_config(filepath: str = "config.toml") -> Config:
    """Load a TOML config file.

    Mirrors ``get_config`` (``/root/reference/src/config.rs:21-40``)
    including its exit-on-error behaviour so CLI semantics match.
    """
    try:
        with open(filepath, "rb") as f:
            raw = tomllib.load(f)
    except OSError:
        print(f"Could not read config file: {filepath}", file=sys.stderr)
        raise SystemExit(1)
    except tomllib.TOMLDecodeError:
        print(f"Could not parse config file: {filepath}", file=sys.stderr)
        raise SystemExit(1)

    try:
        s = raw["scores"]
        scores = Scores(
            s_match=int(s["s_match"]),
            s_mismatch=int(s["s_mismatch"]),
            g=int(s["g"]),
            h=int(s["h"]),
            # Optional extension key; absent in reference configs.
            s_transition=(
                int(s["s_transition"]) if "s_transition" in s else None
            ),
        )
    except (KeyError, TypeError, ValueError):
        print(f"Could not parse config file: {filepath}", file=sys.stderr)
        raise SystemExit(1)

    return Config(scores=scores)
