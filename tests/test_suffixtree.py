"""Suffix-tree parity tests.

Assertion values are ground truth from the reference integration tests
(``/root/reference/tests/test_suffixtree.rs``); golden BWT files and
FASTA corpora are read from a reference checkout when one is given
(``conftest.reference_file``), and seeded genomes check the two tree
implementations and the device BWT against each other.
"""

import pytest

from genomics_rs_tpu.sequence import SequenceContainer
from genomics_rs_tpu.suffixtree import native_available
from genomics_rs_tpu.suffixtree.native import NativeSuffixTree
from genomics_rs_tpu.suffixtree.tree import SuffixTree

from conftest import data_path, reference_file

_IMPLS = [SuffixTree]
if native_available():
    _IMPLS.append(NativeSuffixTree)


@pytest.fixture(params=_IMPLS, ids=lambda c: c.__name__)
def tree_cls(request):
    """Both implementations must be output-identical (same goldens)."""
    return request.param


def _alpha(name: str) -> str:
    return data_path("alphabets", name)


def test_tree_simple2(tree_cls):
    tree = tree_cls(_alpha("dna.txt"), 10)
    tree.insert_string("ACA", True, True)
    tree.compute_stats(0)
    assert tree.stats.num_nodes == 6


def test_tree_simple3(tree_cls):
    tree = tree_cls(_alpha("banana.txt"), 10)
    tree.insert_string("BANANA", True, True)
    tree.compute_stats(0)
    assert tree.stats.num_internal == 3
    assert tree.stats.num_leaves == 7
    assert tree.stats.num_nodes == 11
    assert tree.stats.average_string_depth == 2.0
    assert tree.stats.max_string_depth == 3
    assert tree.stats.bwt == "ANNB$AA"


def test_tree_simple4(tree_cls):
    tree = tree_cls(_alpha("english.txt"), 20)
    tree.insert_string("MISSISSIPPI", True, True)
    tree.compute_stats(0)
    assert tree.stats.num_internal == 6
    assert tree.stats.num_leaves == 12
    assert tree.stats.num_nodes == 19
    assert tree.stats.average_string_depth == 2.0
    assert tree.stats.max_string_depth == 4
    assert tree.stats.bwt == "IPSSM$PISSII"


def _golden_bwt(path: str) -> str:
    with open(reference_file(*path.split("/"))) as f:
        return f.read().replace("\n", "")


def _genome_tree(fasta: str, tree_cls):
    sc = SequenceContainer()
    sc.from_fasta(reference_file("test_data", fasta))
    tree = tree_cls(_alpha("dna.txt"), 200000)
    tree.insert_string(sc.sequences[0].sequence, True, True)
    tree.compute_stats(0)
    return tree


def test_tree_covid_wuhan(tree_cls):
    tree = _genome_tree("Covid_Wuhan.fasta", tree_cls)
    assert tree.stats.num_internal == 19098
    assert tree.stats.num_leaves == 29904
    assert tree.stats.num_nodes == 49003
    assert tree.stats.bwt == _golden_bwt("BWTs/Covid_Wuhan.fasta.BWT.out")


def test_tree_human_brca2(tree_cls):
    tree = _genome_tree("Human-BRCA2-cds.fasta", tree_cls)
    assert tree.stats.num_internal == 7299
    assert tree.stats.num_leaves == 11383
    assert tree.stats.num_nodes == 18683
    assert tree.stats.bwt == _golden_bwt("BWTs/Human-BRCA2-cds.fasta.BWT.txt")


def test_tree_slyco(tree_cls):
    tree = _genome_tree("Slyco.fasta", tree_cls)
    assert tree.stats.num_internal == 98972
    assert tree.stats.num_leaves == 155462
    assert tree.stats.num_nodes == 254435
    assert tree.stats.bwt == _golden_bwt("BWTs/Slyco.fas.BWT.out")


def test_generalized_suffix_tree(tree_cls):
    tree = tree_cls(_alpha("banana.txt"), 10)
    tree.insert_string("BANANA", True, True)
    tree.insert_string("ABANANA", True, True)
    tree.compute_stats(0)
    s1, s2, length = tree.get_lcs(0, 1)
    assert (s1, s2, length) == (0, 1, 6)


def test_generalized_suffix_tree2(tree_cls):
    tree = tree_cls(_alpha("banana.txt"), 10)
    tree.insert_string("BANANA", True, True)
    tree.insert_string("BANANAB", True, True)
    tree.insert_string("ABABABA", True, True)
    tree.compute_stats(0)
    s1, s2, length = tree.get_lcs(1, 2)
    assert (s1, s2, length) == (5, 4, 2)


def test_generalized_suffix_tree3(tree_cls):
    tree = tree_cls(_alpha("dna.txt"), 11)
    tree.insert_string("ATTAAAGGTTT", True, True)
    tree.insert_string("ATTAAAGGTTT", True, True)
    tree.insert_string("ACCTT", True, True)
    tree.compute_stats(0)
    tree.get_lcs(1, 2)  # smoke (reference asserts nothing here)


def test_generalized_suffix_tree_equal_sequences(tree_cls):
    tree = tree_cls(_alpha("dna.txt"), 11)
    tree.insert_string("ATTAAAGGTTT", True, True)
    tree.insert_string("ATTAAAGGTTT", True, True)
    tree.compute_stats(0)
    s1, s2, length = tree.get_lcs(0, 1)
    assert length == 11
    assert (s1, s2) == (0, 0)


def test_generalized_suffix_tree_equal_sequences_long(tree_cls):
    sc = SequenceContainer()
    sc.from_fasta(reference_file("test_data", "Covid_USA-CA4.fasta"))
    tree = tree_cls(_alpha("dna.txt"), 200000)
    tree.insert_string(sc.sequences[0].sequence, True, True)
    tree.insert_string(sc.sequences[0].sequence, True, True)
    s1, s2, length = tree.get_lcs(0, 1)
    assert length == len(sc.sequences[0].sequence)
    assert (s1, s2) == (0, 0)


@pytest.mark.skipif(not native_available(), reason="needs the C++ core")
def test_tree_chr12_native():
    """The reference's disabled-for-speed chr12 test
    (test_suffixtree.rs:239-257) — the C++ core runs it in seconds."""
    sc = SequenceContainer()
    sc.from_fasta(reference_file("test_data", "chr12.fasta"))
    s = sc.sequences[0].sequence
    tree = NativeSuffixTree(_alpha("dna.txt"), len(s))
    tree.insert_string(s, True, False)
    st = tree.compute_stats(0)
    assert st.num_internal == 699519
    assert st.num_leaves == 1078176
    assert st.num_nodes == 1777696
    # BWT must be a permutation of text + terminator.
    from collections import Counter

    assert Counter(st.bwt.replace("$", "")) == Counter(s.replace("$", ""))


def test_unknown_character_raises(tree_cls):
    """Unknown characters panic in the reference (tree.rs:56-63)."""
    tree = tree_cls(_alpha("dna.txt"), 10)
    with pytest.raises(KeyError):
        tree.insert_string("ACGN", True, False)


def test_string_cap_32(tree_cls):
    """Terminator scheme caps the tree at 32 strings (tree.rs:66-69)."""
    tree = tree_cls(_alpha("dna.txt"), 10)
    for _ in range(32):
        tree.insert_string("ACGT", True, False)
    with pytest.raises(ValueError):
        tree.insert_string("ACGT", True, False)


def _seeded_genome(n: int, seed: int) -> str:
    """A genome-like DNA string: random bases plus copied repeats, so
    the tree has deep internal nodes as real genomes do."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = bytearray(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)])
    for _ in range(max(1, n // 500)):
        L = int(rng.integers(20, 200))
        a, b = (int(x) for x in rng.integers(0, n - L, 2))
        s[b : b + L] = s[a : a + L]
    return s.decode()


@pytest.mark.parametrize("n,seed", [(1000, 1), (4000, 2), (12000, 3)])
def test_tree_seeded_genome_bwt(tree_cls, n, seed):
    """Seeded twin of the genome goldens: the tree's BWT equals the
    device suffix-array BWT, and its leaf count is n + 1."""
    from genomics_rs_tpu.ops.bwt_device import bwt_device

    s = _seeded_genome(n, seed)
    tree = tree_cls(_alpha("dna.txt"), n)
    tree.insert_string(s, True, True)
    tree.compute_stats(0)
    assert tree.stats.num_leaves == n + 1
    assert tree.stats.bwt == bwt_device(s)


@pytest.mark.skipif(not native_available(), reason="needs the C++ core")
@pytest.mark.parametrize("n,seed", [(3000, 4), (9000, 5)])
def test_tree_seeded_genome_impls_agree(n, seed):
    """The Python tree and the C++ core give identical statistics on
    the same seeded genome (the chr12/genome tests' twin)."""
    s = _seeded_genome(n, seed)
    stats = []
    for cls in (SuffixTree, NativeSuffixTree):
        tree = cls(_alpha("dna.txt"), n)
        tree.insert_string(s, True, True)
        tree.compute_stats(0)
        st = tree.stats
        stats.append(
            (
                st.num_internal,
                st.num_leaves,
                st.num_nodes,
                st.max_string_depth,
                st.bwt,
            )
        )
    assert stats[0] == stats[1]
