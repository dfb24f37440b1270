"""ctypes bindings for the C++ suffix-tree core (native/suffixtree.cpp).

``NativeSuffixTree`` mirrors the Python oracle's public API
(``tree.SuffixTree``: insert_string / get_lcs / compute_stats) and is
output-identical — the golden tests run against both. The library is
built on demand with ``make -C native`` (g++, no external deps); when
unavailable, callers fall back to the Python tree.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

from genomics_rs_tpu.suffixtree.tree import (
    STRING_TERMINATORS,
    TreeStats,
    load_alphabet,
)

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libgenomics_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False


def _load_library() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("GENOMICS_TPU_NO_NATIVE"):
            _lib_failed = True
            return None
        # Always invoke make: it is a no-op when the .so is fresh, and
        # rebuilds when the C++ sources changed (a stale binary would
        # silently pass golden tests against dead code). The library
        # is never committed (-march=native output is host-specific).
        try:
            subprocess.run(
                ["make", "-C", os.path.join(_REPO_ROOT, "native")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception as e:  # noqa: BLE001 — any failure => fallback
            log.warning("native build failed (%s); using Python tree", e)
            if not os.path.exists(_LIB_PATH):
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            log.warning("could not load %s (%s)", _LIB_PATH, e)
            _lib_failed = True
            return None

        lib.st_new.restype = ctypes.c_void_p
        lib.st_new.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.st_free.argtypes = [ctypes.c_void_p]
        lib.st_insert.restype = ctypes.c_int
        lib.st_insert.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.st_stats.restype = ctypes.c_int
        lib.st_stats.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.st_lcs.restype = ctypes.c_int
        lib.st_lcs.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gotoh_score_cpu.restype = ctypes.c_int
        lib.gotoh_score_cpu.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gotoh_score_cpu_subst.restype = ctypes.c_int
        lib.gotoh_score_cpu_subst.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.st_similarity.restype = ctypes.c_int
        lib.st_similarity.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char,
            ctypes.c_char,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sais_u8.restype = ctypes.c_int
        lib.sais_u8.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def native_suffix_array(text: bytes):
    """Linear-time host suffix array (native/sais.cpp), or None when
    the native library is unavailable.

    Returns the int32 suffix array of ``text`` exactly as
    ``ops.bwt_device.suffix_array`` orders it when ``text`` carries
    its own trailing terminator (proper-prefix suffixes first) —
    cross-checked in tests/test_fmindex.py.
    """
    lib = _load_library()
    if lib is None:
        return None
    import numpy as np

    n = len(text)
    sa = np.empty(n, dtype=np.int32)
    rc = lib.sais_u8(
        text, n, sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    if rc != 0:
        raise RuntimeError(f"sais_u8 failed (rc={rc})")
    return sa


class NativeSuffixTree:
    """C++-backed generalized suffix tree (API-compatible subset)."""

    def __init__(self, alphabet_file: str, initial_allocation: int = 16):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("native suffix tree library unavailable")
        self._lib = lib
        self.alphabet = load_alphabet(alphabet_file)
        merged = "".join(self.alphabet).encode("latin-1")
        self._handle = lib.st_new(merged, len(merged))
        self.strings: list[str] = []
        self.stats = TreeStats()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.st_free(handle)
            self._handle = None

    def _require_handle(self):
        if not getattr(self, "_handle", None):
            raise RuntimeError(
                "suffix tree handle is unusable (a prior insert failed "
                "and left the arena corrupted)"
            )

    def insert_string(
        self,
        new_string: str,
        enable_suffix_links: bool = True,
        print_time: bool = False,
    ) -> None:
        self._require_handle()
        string_idx = len(self.strings)
        if string_idx >= len(STRING_TERMINATORS):
            raise ValueError("Suffix tree supports at most 32 strings")
        bad = set(new_string) & set(STRING_TERMINATORS)
        if bad:
            raise ValueError(
                f"sequence contains terminator characters {sorted(bad)!r}"
            )
        full = new_string + STRING_TERMINATORS[string_idx]
        self.strings.append(full)
        rc = self._lib.st_insert(
            self._handle,
            full.encode("latin-1"),
            len(full),
            1 if enable_suffix_links else 0,
        )
        if rc != 0:
            # The C++ arena is half-mutated at this point; deregister
            # the string and poison the handle so later queries can't
            # silently return results from a corrupted tree (matching
            # the reference's hard-stop, tree.rs:56-63).
            self.strings.pop()
            self._lib.st_free(self._handle)
            self._handle = None
            raise KeyError("Character not found in alphabet")

    def get_lcs(self, a: int, b: int) -> tuple[int, int, int]:
        self._require_handle()
        out = (ctypes.c_int64 * 3)()
        rc = self._lib.st_lcs(self._handle, a, b, out)
        if rc != 0:
            raise RuntimeError("st_lcs failed")
        return (int(out[0]), int(out[1]), int(out[2]))

    def compute_stats(self, string_idx: int = 0) -> TreeStats:
        self._require_handle()
        if string_idx != 0:
            raise ValueError("compute_stats supports string 0 only")
        slen = len(self.strings[0])
        out = (ctypes.c_int64 * 7)()
        avg = ctypes.c_double()
        buf = ctypes.create_string_buffer(slen + 1)
        rc = self._lib.st_stats(self._handle, out, ctypes.byref(avg), buf, slen)
        if rc != 0:
            raise RuntimeError(f"st_stats failed ({rc})")
        st = self.stats
        st.num_internal = int(out[0])
        st.num_leaves = int(out[1])
        st.num_nodes = int(out[2])
        st.max_string_depth = int(out[3])
        st.longest_repeat_len = int(out[4])
        st.longest_repeat_start = int(out[5])
        st.bwt = buf.raw[:slen].decode("latin-1").strip()
        st.average_string_depth = float(avg.value)
        return st


import functools


@functools.lru_cache(maxsize=16)
def _merged_alphabet(alphabet_file: str) -> bytes:
    return "".join(load_alphabet(alphabet_file)).encode("latin-1")


def similarity_native(
    a: str, b: str, alphabet_file: str
) -> tuple[int, int]:
    """Compare-mode pair similarity, fully in C++ (score, first_lcs).

    Output-identical to the Python recursion in
    ``comparison/driver.py::recursive_lcs_similarity`` — same tree
    code, same LCS tie-breaks, same prefix/suffix recursion
    (``/root/reference/src/main.rs:267-308``) — but ~20x faster: the
    whole recursion runs natively with one reused arena instead of a
    Python loop building a fresh ctypes-wrapped tree per sub-pair.
    The ctypes call releases the GIL, so a thread pool scales it.
    """
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    merged = _merged_alphabet(alphabet_file)
    out = (ctypes.c_int64 * 2)()
    rc = lib.st_similarity(
        merged,
        len(merged),
        a.encode("latin-1"),
        len(a),
        b.encode("latin-1"),
        len(b),
        STRING_TERMINATORS[0].encode("latin-1"),
        STRING_TERMINATORS[1].encode("latin-1"),
        out,
    )
    if rc != 0:
        raise KeyError("Character not found in alphabet")
    return (int(out[0]), int(out[1]))


def gotoh_score_cpu(
    s1: bytes, s2: bytes, sm: int, sx: int, g: int, h: int, is_local: bool
) -> tuple[int, int, int]:
    """Reference-equivalent CPU Gotoh score (the large-scale oracle)."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = (ctypes.c_int64 * 3)()
    rc = lib.gotoh_score_cpu(
        s1, len(s1), s2, len(s2), sm, sx, g, h, 1 if is_local else 0, out
    )
    if rc != 0:
        raise RuntimeError("gotoh_score_cpu failed")
    return (int(out[0]), int(out[1]), int(out[2]))


def gotoh_score_cpu_subst(
    s1: bytes, s2: bytes, lut256, g: int, h: int, is_local: bool
) -> tuple[int, int, int]:
    """LUT-scored CPU Gotoh oracle: ``sub(a, b) = lut256[a, b]``.

    Covers kimura transition scoring (``ops/subst.kimura_byte_lut``)
    and full substitution matrices (``SubstMatrix.byte_lut``) — the
    reference has no analog (two-score model only, algo.rs:245-248).
    """
    import numpy as _np

    lib = _load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    lut = _np.ascontiguousarray(lut256, dtype=_np.int32)
    if lut.shape != (256, 256):
        raise ValueError(f"lut256 must be (256, 256), got {lut.shape}")
    out = (ctypes.c_int64 * 3)()
    rc = lib.gotoh_score_cpu_subst(
        s1,
        len(s1),
        s2,
        len(s2),
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        g,
        h,
        1 if is_local else 0,
        out,
    )
    if rc != 0:
        raise RuntimeError("gotoh_score_cpu_subst failed")
    return (int(out[0]), int(out[1]), int(out[2]))
