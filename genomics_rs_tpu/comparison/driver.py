"""All-pairs genome comparison driver.

Library-grade port of the Compare-mode logic the reference keeps inline
in ``main`` (``/root/reference/src/main.rs:216-379``):

* every ``.fasta`` file in a directory is loaded into one container
  (we sort filenames for determinism; the reference inherits the OS
  directory order — documented deviation);
* for each pair (i, j) with i <= j the similarity score is the total
  length of recursively-found longest common substrings: take the LCS
  of the pair via a fresh 2-string generalized suffix tree, then
  recurse on the (prefix_i, prefix_j) and (suffix_i, suffix_j)
  remainders while the LCS is non-empty (``main.rs:267-308``);
* the matrix cell holds ``(score, len_i, len_j, first_lcs_len)`` and
  only the lower triangle (i <= j, stored at [j][i]) is filled
  (``main.rs:263-265,310-315``);
* suffix links are always enabled in the per-pair tree
  (``main.rs:273-274`` hardcodes true regardless of the CLI flag).

Parallelism: the reference fans out with a rayon thread pool; here
pairs are scheduled over a process pool (host CPU work), and the
same driver can be pointed at the device batch aligner for DP-based
scoring (see parallel/allpairs.py).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import time

import numpy as np

from genomics_rs_tpu.sequence import SequenceContainer

log = logging.getLogger(__name__)


def recursive_lcs_similarity(
    s1: str, s2: str, alphabet_file: str, engine: str = "auto"
) -> tuple[int, int]:
    """(total recursive LCS length, first LCS length) for one pair.

    ``engine="native"`` runs the whole recursion in C++ with a reused
    arena (``native/suffixtree.cpp::st_similarity``, ~20x the Python
    loop); ``"python"`` keeps the per-sub-pair tree loop below (the
    parity oracle); ``"auto"`` prefers native when available. Both are
    output-identical (tests pin it).
    """
    if engine in ("auto", "native"):
        try:
            from genomics_rs_tpu.suffixtree.native import (
                similarity_native,
            )

            return similarity_native(s1, s2, alphabet_file)
        except (RuntimeError, OSError, AttributeError):
            if engine == "native":
                raise
    from genomics_rs_tpu.suffixtree import make_tree

    def get_matches(a: str, b: str):
        st = make_tree(alphabet_file, len(a) + len(b))
        st.insert_string(a, True, False)
        st.insert_string(b, True, False)
        return (*st.get_lcs(0, 1), a, b)

    stack = [(*_reorder(get_matches(s1, s2)),)]
    first_lcs_length = stack[0][0]
    score = 0
    while stack:
        lcs_length, st_i, st_j, a, b = stack.pop()
        if lcs_length > 0:
            stack.append(_reorder(get_matches(a[:st_i], b[:st_j])))
            stack.append(
                _reorder(get_matches(a[st_i + lcs_length :], b[st_j + lcs_length :]))
            )
        score += lcs_length
    return score, first_lcs_length


def _reorder(t):
    # get_lcs returns (i, j, len); the driver stack carries (len, i, j, a, b).
    i, j, length, a, b = t
    return (length, i, j, a, b)


@dataclasses.dataclass
class CompareResult:
    names: list[str]
    lengths: list[int]
    #: [j][i] = (score, len_i, len_j, first_lcs) for i <= j; zeros above.
    matrix: np.ndarray
    elapsed_s: float


def _pair_task(args):
    i, j, s1, s2, alphabet_file = args
    score, first = recursive_lcs_similarity(s1, s2, alphabet_file)
    return (i, j, score, first)


def load_fasta_dir(fasta_dir: str) -> SequenceContainer:
    container = SequenceContainer()
    for fname in sorted(os.listdir(fasta_dir)):
        if not fname.endswith(".fasta"):
            continue
        container.from_fasta(os.path.join(fasta_dir, fname))
    return container


def compare_all_pairs(
    container: SequenceContainer,
    alphabet_file: str,
    threads: int = 1,
) -> CompareResult:
    """Fill the all-pairs similarity matrix (lower triangle)."""
    seqs = [s.sequence for s in container.sequences]
    names = [s.name for s in container.sequences]
    num = len(seqs)
    matrix = np.zeros((num, num, 4), dtype=np.int64)

    tasks = [
        (i, j, seqs[i], seqs[j], alphabet_file)
        for j in range(num)
        for i in range(num)
        if i <= j
    ]

    try:
        from genomics_rs_tpu.suffixtree.native import native_available

        use_threads = native_available()
    except Exception:  # noqa: BLE001
        use_threads = False

    t0 = time.perf_counter()
    if threads <= 1:
        results = map(_pair_task, tasks)
        for i, j, score, first in results:
            matrix[j, i] = (score, len(seqs[i]), len(seqs[j]), first)
    elif use_threads:
        # The native similarity call releases the GIL, so a thread
        # pool scales without process-spawn/import overhead.
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=threads
        ) as ex:
            for i, j, score, first in ex.map(_pair_task, tasks):
                matrix[j, i] = (score, len(seqs[i]), len(seqs[j]), first)
    else:
        with concurrent.futures.ProcessPoolExecutor(max_workers=threads) as ex:
            for i, j, score, first in ex.map(_pair_task, tasks):
                matrix[j, i] = (score, len(seqs[i]), len(seqs[j]), first)
    elapsed = time.perf_counter() - t0
    log.info(
        "[Compare] Time taken to compare: %d us (%d ms)",
        int(elapsed * 1e6),
        int(elapsed * 1e3),
    )
    return CompareResult(names=names, lengths=[len(s) for s in seqs], matrix=matrix, elapsed_s=elapsed)


def write_similarity_tsv(result: CompareResult, path: str = "similarity_matrix.tsv") -> str:
    """TSV writer matching the reference's format (main.rs:330-360):
    header row of indices, then one row per sequence with scores."""
    num = len(result.names)
    lines = ["\t" + "\t".join(str(i) for i in range(num)) + "\t"]
    for j in range(num):
        cells = "\t".join(str(int(result.matrix[j, i, 0])) for i in range(num))
        lines.append(f"{j}\t{cells}\t")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text
