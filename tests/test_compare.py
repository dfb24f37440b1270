"""Compare-mode driver tests.

The reference leaves Compare untested (SURVEY §4); these encode its
semantics: similarity(i, j) = total length of recursively-found LCSs
(``/root/reference/src/main.rs:267-308``), lower-triangle-only matrix,
cell = (score, len_i, len_j, first_lcs).
"""

import numpy as np
import pytest

from genomics_rs_tpu.comparison.driver import (
    compare_all_pairs,
    load_fasta_dir,
    recursive_lcs_similarity,
    write_similarity_tsv,
)

from conftest import data_path

ALPHA = data_path("alphabets", "banana.txt")


def test_recursive_lcs_pair():
    score, first = recursive_lcs_similarity("BANANA", "ABANANA", ALPHA)
    assert first == 6  # "BANANA" inside "ABANANA"
    assert score >= 6


def test_recursive_lcs_self():
    score, first = recursive_lcs_similarity("ABANANA", "ABANANA", ALPHA)
    assert first == 7
    assert score == 7


def test_native_similarity_matches_python():
    """The C++ whole-recursion path (st_similarity) must be
    output-identical to the Python per-sub-pair loop on randomized
    pairs — same tree code, same LCS tie-breaks, same recursion."""
    pytest.importorskip("genomics_rs_tpu.suffixtree.native")
    from genomics_rs_tpu.suffixtree.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(29)
    alpha = data_path("alphabets", "dna.txt")
    for trial in range(6):
        n1 = int(rng.integers(1, 400))
        a = "".join(rng.choice(list("ACGT"), n1))
        if trial % 2 == 0:
            # Mutated copy — exercises deep shared substrings.
            b = list(a)
            for _ in range(max(1, n1 // 30)):
                b[int(rng.integers(0, n1))] = rng.choice(list("ACGT"))
            b = "".join(b)
        else:
            b = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 400))))
        py = recursive_lcs_similarity(a, b, alpha, engine="python")
        nat = recursive_lcs_similarity(a, b, alpha, engine="native")
        assert py == nat, (trial, a, b, py, nat)


def test_compare_all_pairs(tmp_path):
    (tmp_path / "a.fasta").write_text(">a\nABANANA\n")
    (tmp_path / "b.fasta").write_text(">b\nBANANA\n")
    container = load_fasta_dir(str(tmp_path))
    assert [s.name for s in container.sequences] == ["a", "b"]

    result = compare_all_pairs(container, ALPHA, threads=1)
    mat = result.matrix
    # lower triangle filled: [j][i] with i <= j
    assert mat[0, 0, 0] == 7  # ABANANA self
    assert mat[1, 1, 0] == 6  # BANANA self
    assert mat[1, 0, 0] >= 6  # cross pair
    assert mat[1, 0, 3] == 6  # first LCS
    # upper triangle untouched
    assert tuple(mat[0, 1]) == (0, 0, 0, 0)
    # lengths recorded
    assert mat[1, 0, 1] == 7 and mat[1, 0, 2] == 6

    tsv = write_similarity_tsv(result, str(tmp_path / "sim.tsv"))
    lines = tsv.split("\n")
    assert lines[0] == "\t0\t1\t"
    assert lines[1].startswith("0\t7\t0\t")


def test_display_smoke():
    from genomics_rs_tpu.comparison.display import format_similarity_matrix

    mat = np.zeros((2, 2, 4), dtype=np.int64)
    mat[1, 0] = (6, 7, 6, 6)
    text = format_similarity_matrix(mat, color=False)
    assert "85" in text  # 6/7 = 85%


def test_alignment_display_smoke():
    from genomics_rs_tpu.config import Scores
    from genomics_rs_tpu.display.alignment import (
        format_aligned_sequences,
        format_alignment_table,
    )
    from genomics_rs_tpu.models.aligner import PairwiseAligner
    from genomics_rs_tpu.sequence import Sequence

    aligner = PairwiseAligner(Scores(1, -2, -2, -5), engine="scan")
    r = aligner.align(Sequence("s1", "ACGT"), Sequence("s2", "AGCGT"))
    text = format_aligned_sequences(r)
    assert "Alignment Score:" in text
    assert "Percent Identity" in text
    vis = format_alignment_table(r, color=False)
    assert vis is not None and "Sequence Table" in vis
