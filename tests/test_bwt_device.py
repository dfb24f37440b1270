"""Device suffix-array BWT vs the reference golden BWT files (when a
reference checkout is given) and the suffix-tree implementations."""

import numpy as np
import pytest

from genomics_rs_tpu.ops.bwt_device import bwt_device, suffix_array
from genomics_rs_tpu.sequence import SequenceContainer

from conftest import data_path, reference_file


def _golden_bwt(fname: str) -> str:
    with open(reference_file("BWTs", fname)) as f:
        return f.read().replace("\n", "")


def test_bwt_tiny_analytic():
    # BANANA / MISSISSIPPI goldens from the reference tests
    # (test_suffixtree.rs:8-48); the tree BWT output strips the
    # terminator row's '$'? No — it includes it; goldens keep it.
    assert bwt_device("BANANA") == "ANNB$AA"
    assert bwt_device("MISSISSIPPI") == "IPSSM$PISSII"


def test_suffix_array_matches_numpy():
    rng = np.random.default_rng(71)
    for trial in range(4):
        n = int(rng.integers(2, 200))
        s = bytes(rng.choice(list(b"ACGT"), n)) + b"$"
        want = sorted(range(len(s)), key=lambda i: s[i:])
        got = suffix_array(s[:-1])
        assert list(got) == want, trial


@pytest.mark.parametrize(
    "fasta,golden",
    [
        ("Covid_Wuhan.fasta", "Covid_Wuhan.fasta.BWT.out"),
        ("Human-BRCA2-cds.fasta", "Human-BRCA2-cds.fasta.BWT.txt"),
        ("Slyco.fasta", "Slyco.fas.BWT.out"),
    ],
)
def test_bwt_genome_goldens(fasta, golden):
    sc = SequenceContainer()
    sc.from_fasta(reference_file("test_data", fasta))
    got = bwt_device(sc.sequences[0].sequence)
    assert got == _golden_bwt(golden)


@pytest.mark.parametrize("n,seed", [(29903, 0), (11382, 1), (2000, 2)])
def test_bwt_seeded_genome_matches_native_tree(n, seed):
    """Seeded twin of the genome goldens: the device BWT of a random
    genome of the golden's length equals the C++ suffix tree's BWT
    (which the goldens pin) and is a permutation of text + '$'."""
    from collections import Counter

    from genomics_rs_tpu.suffixtree import make_tree

    rng = np.random.default_rng(seed)
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes().decode()
    got = bwt_device(s)
    assert Counter(got) == Counter(s + "$")
    tree = make_tree(data_path("alphabets", "dna.txt"), n)
    tree.insert_string(s, True, True)
    tree.compute_stats(0)
    assert got == tree.stats.bwt
