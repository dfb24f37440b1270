"""``chip_smoke.py`` at tiny sizes on the CPU: its seeded generators,
its host-side checks, and every phase function end to end (the card
runs the same functions at full size)."""

import os

import numpy as np
import pytest

import chip_smoke as cs
from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.suffixtree import native_available

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)

needs_native = pytest.mark.skipif(
    not native_available(), reason="needs the C++ oracle"
)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generators_are_seeded(seed):
    a = cs.random_dna(np.random.default_rng(seed), 500)
    b = cs.random_dna(np.random.default_rng(seed), 500)
    assert a == b and set(a) <= set("ACGT") and len(a) == 500
    m1 = cs.mutate(np.random.default_rng(seed), a)
    m2 = cs.mutate(np.random.default_rng(seed), a)
    assert m1 == m2 and m1 != a


@pytest.mark.parametrize("sub_rate", [0.0, 0.01, 0.1])
def test_mutate_rates(sub_rate):
    rng = np.random.default_rng(5)
    a = cs.random_dna(rng, 20000)
    m = cs.mutate(rng, a, sub_rate=sub_rate, n_indels=0)
    assert len(m) == len(a)
    diff = sum(x != y for x, y in zip(a, m)) / len(a)
    assert abs(diff - sub_rate) <= 0.01


@pytest.mark.parametrize("n_indels,max_indel", [(20, 10), (5, 1)])
def test_mutate_indels_change_length(n_indels, max_indel):
    rng = np.random.default_rng(6)
    a = cs.random_dna(rng, 5000)
    m = cs.mutate(rng, a, sub_rate=0.0, n_indels=n_indels,
                  max_indel=max_indel)
    assert abs(len(m) - len(a)) <= n_indels * max_indel
    assert set(m) <= set("ACGT")


def test_simulated_reads_carry_their_origin():
    rng = np.random.default_rng(7)
    contigs = [("c1", cs.random_dna(rng, 3000)), ("c2", cs.random_dna(rng, 2000))]
    reads = cs.simulate_reads(rng, contigs, 50, read_len=100, err_rate=0.0)
    assert len(reads) == 50
    for name, seq, qual in reads:
        _, c, p, strand = name.split("_")
        frag = contigs[int(c)][1][int(p) : int(p) + 100]
        assert seq == (cs.revcomp(frag) if strand == "-" else frag)
        assert len(qual) == 100


@pytest.mark.parametrize(
    "row_a,row_b,is_local,want",
    [
        ("ACGT", "ACGT", False, 4),
        ("ACGT", "ACCT", False, 1),
        ("AC--GT", "ACTTGT", False, 4 - 5 - 2),  # one open + one extend
        ("A-C-", "AT-G", False, 1 + 3 * -6),  # kind switches reopen
        ("TTTACGT", "GGGACGT", True, 4),  # local restarts at the zero lane
        ("ACGT--", "ACGTAA", True, 0),  # a trailing gap floors at 0
    ],
)
def test_rescore_gapped(row_a, row_b, is_local, want):
    assert cs.rescore_gapped(row_a, row_b, SCORES, is_local) == want


def test_read_score_tsv(tmp_path):
    p = tmp_path / "s.tsv"
    p.write_text("\t0\t1\t\n0\t5\t0\t\n1\t-3\t7\t\n")
    assert cs.read_score_tsv(str(p)).tolist() == [[5, 0], [-3, 7]]


def test_read_pair_fasta(tmp_path):
    p = tmp_path / "a.fasta"
    p.write_text(">a score=3 span=0-4\nAC\nGT\n>b score=3 span=1-5\nA-GT\n")
    assert cs.read_pair_fasta(str(p)) == [
        ("a score=3 span=0-4", "ACGT"),
        ("b score=3 span=1-5", "A-GT"),
    ]


def test_main_refuses_cpu(capsys):
    assert cs.main([]) == 2
    assert "needs a GPU" in capsys.readouterr().err


@needs_native
def test_phase_align_tiny(tmp_path):
    res = cs.phase_align(str(tmp_path), seed=0, length=300)
    assert res["ok"], res
    for mode in ("global", "local"):
        r = res["modes"][mode]
        assert r["score"] == r["oracle"]
        assert r["path_spells_inputs"]
        assert r["path_rescore"] <= r["score"]


@needs_native
def test_phase_align_matrix_tiny(tmp_path):
    res = cs.phase_align_matrix(str(tmp_path), seed=0, n=3, n_local=2,
                                length=200)
    assert res["ok"], res
    assert res["pairs"] == 6 + 3


@needs_native
def test_phase_map_tiny(tmp_path):
    res = cs.phase_map(str(tmp_path), seed=0, ref_len=20000, n_reads=120,
                       n_sample=15)
    assert res["ok"], res
    assert res["correct_fraction"] >= cs.MAP_MIN_CORRECT
    assert res["as_sample"] == 15 and res["as_mismatches"] == 0


def test_phase_bwt_tiny(tmp_path):
    res = cs.phase_bwt(str(tmp_path), seed=0, length=500)
    assert res["ok"], res


@needs_native
def test_phase_data_parallel_tiny():
    import jax

    res = cs.phase_data_parallel(0, jax.devices()[:4], n=3, length=150)
    assert res["ok"], res
    assert res["pairs"] == 6


def test_phase_seq_parallel_score_tiny():
    import jax

    res = cs.phase_seq_parallel_score(0, jax.devices()[:4], length=600)
    assert res["ok"], res


def test_phase_seq_parallel_align_tiny():
    import jax

    res = cs.phase_seq_parallel_align(0, jax.devices()[:4], length=400)
    assert res["ok"], res


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the script cannot
    import the package and must exit non-zero."""
    import shutil
    import subprocess
    import sys

    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
