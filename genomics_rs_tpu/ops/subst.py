"""Substitution-scoring extensions: transition/transversion + matrices.

The reference scores every aligned pair of characters with exactly two
values — ``s_match`` / ``s_mismatch`` (``/root/reference/src/alignment/
algo.rs:245-248``, ``src/config.rs:6-18``). This module extends the
framework beyond that (a capability the reference lacks):

* **Kimura-style DNA scoring** (``Scores.s_transition``): mismatches
  split into *transitions* (purine<->purine A<->G, pyrimidine<->
  pyrimidine C<->T — biochemically frequent) and *transversions*
  (everything else). Three score classes: match / transition /
  transversion (= ``s_mismatch``).

* **Full substitution matrices** (:class:`SubstMatrix`): an arbitrary
  integer matrix over an explicit alphabet — BLOSUM62 is built in, any
  matrix in the standard NCBI format loads from a file. This is what
  protein alignment needs.

Design note (why the funny encoding): the wavefront fills compare
one fixed per-lane character against a streamed one, every cell, as
elementwise vector code — a table *gather* per cell is not.
Kimura scoring therefore re-encodes characters **host-side** so the
class test becomes one XOR:

    A -> 0, G -> 2 (purines, even)   C -> 1, T -> 3 (pyrimidines, odd)
    a -> 4, g -> 6, c -> 5, t -> 7   (soft-masked lowercase: bit 2 =
                                      case, bits 0-1 = class)
    any other byte b -> (b << 2) | 1024

With that map, for encoded values x and y:

* ``x == y``  iff the original bytes were equal (the map is injective:
  non-ACGT codes are strictly increasing in b and always >= 1024),
* ``x ^ y == 2`` iff the pair is a DNA transition: {0,2} and {1,3} are
  the only pairs of codes XOR-ing to 2 — bit 10 sits above the bits
  ``<< 2`` uses, so it is XOR-linear: two non-ACGT codes XOR to
  ``(a ^ b) << 2 >= 4``, and any mixed pair's XOR has bit 10 set.

So kernels pay **two extra vector ops per cell** (an XOR-compare and a
select) and zero extra memory traffic, only in compile variants where
``s_transition`` is set — the classic two-score path compiles
unchanged.

Full-matrix scoring keeps the oracle engines (scan / numpy / C++) and
short/mid-length device paths; see :func:`pair_profile` for the
device-friendly formulation (substitution scores precomputed outside
the DP recurrence as a (256, 256) byte-pair lookup).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax.numpy as jnp

#: Host-side kimura re-encoding table (int32[256]); see module docstring.
#: Lowercase acgt (soft-masked FASTA) gets its own class codes 4-7:
#: bit 2 carries the case, bits 0-1 the class, so x == y is still
#: byte equality (reference parity: 'a' != 'A' is a mismatch,
#: sequence.rs:102-115) while same-case transitions (a<->g, c<->t)
#: XOR to 2 exactly like uppercase. Cross-case pairs score as
#: ordinary mismatches (transversion) — consistent with their
#: non-match status.
KIMURA_ENC = ((np.arange(256, dtype=np.int32) << 2) | 1024).astype(
    np.int32
)
KIMURA_ENC[ord("A")] = 0
KIMURA_ENC[ord("G")] = 2
KIMURA_ENC[ord("C")] = 1
KIMURA_ENC[ord("T")] = 3
KIMURA_ENC[ord("a")] = 4
KIMURA_ENC[ord("g")] = 6
KIMURA_ENC[ord("c")] = 5
KIMURA_ENC[ord("t")] = 7


def kimura_active(scores) -> bool:
    """True when ``scores`` carries a transition score (static: the
    field is part of the ``Scores`` pytree *structure*, so jit caches
    classic and kimura variants separately)."""
    return getattr(scores, "s_transition", None) is not None


def encode_chars(arr, scores):
    """Map encoded ASCII bytes to kernel character codes.

    Classic scoring: identity (byte equality is all kernels test).
    Kimura scoring: the XOR-friendly class encoding above. Works on
    numpy or jax arrays; always returns int32. The jax path uses a
    select chain rather than a table gather so it stays transparent
    under ``shard_map``'s varying-manual-axes typing (a constant LUT
    operand would not share the indices' varying axes) — it runs once
    per character in the wrapper, outside the DP loop.
    """
    if not kimura_active(scores):
        if isinstance(arr, np.ndarray):
            return arr.astype(np.int32)
        return arr.astype(jnp.int32)
    if isinstance(arr, np.ndarray):
        return KIMURA_ENC[arr]
    b = arr.astype(jnp.int32)
    code = (b << 2) | 1024
    for ch, v in (
        ("A", 0),
        ("G", 2),
        ("C", 1),
        ("T", 3),
        ("a", 4),
        ("g", 6),
        ("c", 5),
        ("t", 7),
    ):
        code = jnp.where(b == ord(ch), v, code)
    return code


def sentinel(value: int, scores) -> int:
    """Kernel sentinel/pad literal under the active encoding.

    Wrapper constants like ``0xFD`` (s1 row-0 guard) and ``0xFF``
    (s2 stream filler) are written directly, not through the LUT;
    mapping them through the same encoding in kimura mode preserves
    exactly the classic guarantees: unequal to every other byte's code
    and XOR-clean (non-ACGT codes never XOR to 2), so padded garbage
    can never score as a match or transition.
    """
    return int(KIMURA_ENC[value]) if kimura_active(scores) else value


def sub_score(c1, c2, sm, sx, st=None):
    """Per-cell substitution score (vector op; shared by all kernels).

    ``st is None`` is the reference's two-score form. With ``st``, the
    characters must be :func:`encode_chars`-encoded and the score is
    match / transition / transversion.
    """
    if st is None:
        return jnp.where(c1 == c2, sm, sx)
    return jnp.where(
        c1 == c2, sm, jnp.where((c1 ^ c2) == 2, st, sx)
    )


def kimura_byte_lut(scores) -> np.ndarray:
    """(256, 256) int32 byte-pair scores under kimura scoring — the
    bridge that lets the LUT-based oracles (C++ ``gotoh_score_cpu_subst``,
    scan ``subst_lut``) cross-check the kimura kernels."""
    b = np.arange(256, dtype=np.uint8)
    return sub_score_np(
        b[:, None],
        b[None, :],
        scores.s_match,
        scores.s_mismatch,
        scores.s_transition,
    ).astype(np.int32)


def sub_score_np(a: np.ndarray, b, sm: int, sx: int, st=None):
    """Numpy twin of :func:`sub_score` (int64 oracle path). ``a``/``b``
    are raw ASCII byte arrays/scalars — no pre-encoding needed."""
    if st is None:
        return np.where(a == b, sm, sx)
    ea = KIMURA_ENC[np.asarray(a, dtype=np.uint8)]
    eb = KIMURA_ENC[np.asarray(b, dtype=np.uint8)]
    return np.where(ea == eb, sm, np.where((ea ^ eb) == 2, st, sx))


# ---------------------------------------------------------------------------
# Full substitution matrices (protein scoring)
# ---------------------------------------------------------------------------

#: Canonical BLOSUM62 (NCBI), alphabet ARNDCQEGHILKMFPSTWYVBZX*.
_BLOSUM62_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
_BLOSUM62_ROWS = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""


@dataclasses.dataclass(frozen=True, eq=False)
class SubstMatrix:
    """An integer substitution matrix over an explicit alphabet.

    ``matrix[i, j]`` scores alphabet char i aligned against char j.
    Bytes outside the alphabet score as the wildcard row/column when
    the alphabet has one (``X`` for protein matrices), else as the
    matrix minimum — never better than any in-alphabet pairing.
    """

    alphabet: str
    matrix: np.ndarray  # int32 (A, A)
    name: str = ""

    def __post_init__(self):
        A = len(self.alphabet)
        m = np.asarray(self.matrix, dtype=np.int32)
        if m.shape != (A, A):
            raise ValueError(
                f"matrix shape {m.shape} != ({A}, {A}) for alphabet "
                f"{self.alphabet!r}"
            )
        if len(set(self.alphabet)) != A:
            raise ValueError(f"duplicate chars in alphabet {self.alphabet!r}")
        object.__setattr__(self, "matrix", m)

    @property
    def max_abs(self) -> int:
        return int(np.abs(self.matrix).max())

    def byte_lut(self) -> np.ndarray:
        """(256, 256) int32: score for every byte pair (see class doc
        for out-of-alphabet bytes). ~256 KB — built once per matrix."""
        fallback = (
            self.alphabet.index("X")
            if "X" in self.alphabet
            else None
        )
        default = (
            int(self.matrix.min()) if fallback is None else None
        )
        idx = np.full(256, -1, dtype=np.int32)
        for i, ch in enumerate(self.alphabet):
            idx[ord(ch)] = i
        A = len(self.alphabet)
        ext = np.empty((A + 1, A + 1), dtype=np.int32)
        ext[:A, :A] = self.matrix
        if fallback is None:
            ext[A, :] = default
            ext[:, A] = default
        else:
            ext[A, : A + 1] = np.append(
                self.matrix[fallback], self.matrix[fallback, fallback]
            )
            ext[: A + 1, A] = np.append(
                self.matrix[:, fallback], self.matrix[fallback, fallback]
            )
        idx = np.where(idx < 0, A, idx)
        return ext[np.ix_(idx, idx)]

    def unknown_fraction(self, byte_arr) -> float:
        """Fraction of ``byte_arr`` outside this matrix's alphabet.

        Out-of-alphabet bytes (including lowercase/soft-masked
        protein letters — the alphabet is case-sensitive) score as
        the wildcard/minimum row, which silently flattens the
        alignment. User-facing entry points call
        :func:`warn_unknown_bytes` so that is loud, not silent.
        """
        a = np.asarray(byte_arr, dtype=np.uint8).reshape(-1)
        if a.size == 0:
            return 0.0
        known = np.zeros(256, dtype=bool)
        known[[ord(c) for c in self.alphabet]] = True
        return float(np.count_nonzero(~known[a])) / a.size


def warn_unknown_bytes(
    matrix: "SubstMatrix", byte_arr, where: str = "", threshold=0.02
) -> float:
    """Log a warning when a significant fraction of ``byte_arr`` falls
    outside ``matrix``'s alphabet (they all score as the wildcard /
    matrix-minimum row — e.g. soft-masked lowercase protein input
    would silently align as all-X). Returns the fraction."""
    import logging

    frac = matrix.unknown_fraction(byte_arr)
    if frac > threshold:
        logging.getLogger(__name__).warning(
            "%s%.1f%% of input bytes are outside the %s alphabet "
            "(case-sensitive) and score as the wildcard/minimum row; "
            "uppercase soft-masked sequences if that is unintended",
            f"{where}: " if where else "",
            100 * frac,
            matrix.name or "substitution-matrix",
        )
    return frac


def blosum62() -> SubstMatrix:
    """The canonical NCBI BLOSUM62 matrix (24 x 24)."""
    rows = [
        [int(v) for v in line.split()]
        for line in _BLOSUM62_ROWS.strip().splitlines()
    ]
    return SubstMatrix(
        alphabet=_BLOSUM62_ALPHABET,
        matrix=np.asarray(rows, dtype=np.int32),
        name="BLOSUM62",
    )


def dna_matrix(scores) -> SubstMatrix:
    """An ACGT matrix equivalent to ``scores`` (incl. ``s_transition``)
    — the bridge for cross-checking the matrix engines against the
    classic/kimura kernels."""
    sm = scores.s_match
    sx = scores.s_mismatch
    st = scores.s_transition if kimura_active(scores) else sx
    A = "ACGT"
    transitions = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}
    m = np.empty((4, 4), dtype=np.int32)
    for i, a in enumerate(A):
        for j, b in enumerate(A):
            m[i, j] = sm if a == b else (st if (a, b) in transitions else sx)
    return SubstMatrix(alphabet=A, matrix=m, name="dna")


def load_matrix_file(path: str) -> SubstMatrix:
    """Parse a matrix in the standard NCBI format.

    Lines starting with ``#`` are comments; the first data line lists
    the column alphabet (whitespace-separated single chars); each
    following line is ``<row char> <ints...>``. Asymmetric matrices are
    accepted (scored as matrix[row=s1 char][col=s2 char]).
    """
    col_chars: list[str] = []
    row_chars: list[str] = []
    rows: list[list[int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if not col_chars:
                if any(len(p) != 1 for p in parts):
                    raise ValueError(
                        f"{path}: header must list single chars, got {parts!r}"
                    )
                col_chars = parts
                continue
            if len(parts) != len(col_chars) + 1 or len(parts[0]) != 1:
                raise ValueError(
                    f"{path}: row {parts[:2]!r}... must be "
                    f"'<char> <{len(col_chars)} ints>'"
                )
            row_chars.append(parts[0])
            rows.append([int(v) for v in parts[1:]])
    if not col_chars or not rows:
        raise ValueError(f"{path}: no matrix data found")
    if row_chars != col_chars:
        raise ValueError(
            f"{path}: row alphabet {row_chars!r} != column alphabet "
            f"{col_chars!r}"
        )
    return SubstMatrix(
        alphabet="".join(col_chars),
        matrix=np.asarray(rows, dtype=np.int32),
        name=path,
    )


#: Built-in matrices by (upper-cased) name.
BUILTIN_MATRICES = {"BLOSUM62": blosum62}


def get_matrix(name_or_path: str) -> SubstMatrix:
    """A built-in matrix by name, else an NCBI-format file by path."""
    builtin = BUILTIN_MATRICES.get(name_or_path.upper())
    if builtin is not None:
        return builtin()
    return load_matrix_file(name_or_path)
