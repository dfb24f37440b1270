"""Center-star MSA tests (no reference counterpart — an extension).

Pins the three load-bearing properties of the merge:
  * every row degaps back to its input sequence verbatim;
  * projecting (center row, row k) onto their non-double-gap columns
    reproduces the pairwise alignment of center and k exactly
    ("once a gap, always a gap" never re-aligns a pair);
  * deterministic center selection (max summed score, smallest index
    on ties).
"""

import os

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.aligner import PairwiseAligner
from genomics_rs_tpu.models.msa import (
    _gapped_pair,
    _alignment_ops,
    center_star_msa,
    format_msa_clustal,
    write_msa_fasta,
)
from genomics_rs_tpu.sequence import Sequence, SequenceContainer

SCORES = Scores(s_match=1, s_mismatch=-2, g=-2, h=-5)


def _container(seqs):
    c = SequenceContainer()
    for i, s in enumerate(seqs):
        c.sequences.append(Sequence(name=f"s{i}", sequence=s))
    return c


def _msa(seqs):
    return center_star_msa(_container(seqs), SCORES, engine="scan")


def test_msa_rows_degap_to_inputs():
    seqs = ["ACACACTA", "AGCACACA", "ACACAGTA", "CACACTA"]
    res = _msa(seqs)
    assert len(res.rows) == len(seqs)
    width = len(res.rows[0])
    for row, seq in zip(res.rows, seqs):
        assert len(row) == width
        assert row.replace("-", "") == seq


def test_msa_projection_reproduces_pairwise():
    seqs = ["ACACACTA", "AGCACACA", "ACACAGTA", "CACACTA", "ACAC"]
    res = _msa(seqs)
    c = res.center_index
    aligner = PairwiseAligner(SCORES, is_local=False, engine="scan")
    center_seq = seqs[c]
    for k, seq in enumerate(seqs):
        if k == c:
            continue
        aln = aligner.align(
            Sequence("c", center_seq), Sequence("o", seq)
        )
        gc, go = _gapped_pair(center_seq, seq, _alignment_ops(aln))
        # Drop columns where BOTH the center row and row k are gaps —
        # those were inserted for other rows.
        proj_c, proj_o = [], []
        for a, b in zip(res.rows[c], res.rows[k]):
            if a == "-" and b == "-":
                continue
            proj_c.append(a)
            proj_o.append(b)
        assert "".join(proj_c) == gc
        assert "".join(proj_o) == go


def test_msa_identical_sequences():
    res = _msa(["ACGTACGT"] * 3)
    assert all(r == "ACGTACGT" for r in res.rows)
    assert res.conservation() == "*" * 8
    assert res.center_index == 0  # tie -> smallest index


def test_msa_center_is_max_sum():
    # s1 is similar to both others; s0/s2 differ more from each other.
    seqs = ["AAAATTTT", "AAAACTTT", "AAAACCTT"]
    res = _msa(seqs)
    mat = res.score_matrix
    full = mat + mat.T
    np.fill_diagonal(full, 0)
    assert res.center_index == int(np.argmax(full.sum(axis=1)))
    assert res.center_index == 1


def test_msa_single_and_two():
    res = _msa(["ACGT", "ACGG"])
    assert len(res.rows) == 2
    assert res.rows[0].replace("-", "") == "ACGT"
    one = center_star_msa(_container(["ACGT"]), SCORES, engine="scan")
    assert one.rows == ["ACGT"]


def test_msa_clustal_and_fasta_output(tmp_path):
    res = _msa(["ACACACTA", "AGCACACA", "ACACAGTA"])
    text = format_msa_clustal(res, width=6)
    assert "multiple sequence alignment" in text
    # Every block prints K rows + conservation line.
    for name in res.names:
        assert name in text
    out = tmp_path / "msa.fasta"
    write_msa_fasta(res, str(out))
    body = out.read_text().splitlines()
    # Parse back: rows round-trip.
    rows, cur = {}, None
    for line in body:
        if line.startswith(">"):
            cur = line[1:]
            rows[cur] = ""
        else:
            rows[cur] += line
    assert [rows[n] for n in res.names] == res.rows


def test_msa_cli(tmp_path):
    from genomics_rs_tpu.cli import main

    fa = tmp_path / "three.fasta"
    fa.write_text(">a\nACACACTA\n>b\nAGCACACA\n>c\nACACAGTA\n")
    cfg = tmp_path / "config.toml"
    cfg.write_text(
        "[scores]\ns_match = 1\ns_mismatch = -2\ng = -2\nh = -5\n"
    )
    out = tmp_path / "out.fasta"
    rc = main(
        [
            "-c",
            str(cfg),
            "msa",
            "-f",
            str(fa),
            "--engine",
            "scan",
            "--format",
            "fasta",
            "-o",
            str(out),
        ]
    )
    assert rc == 0
    assert out.exists()
    text = out.read_text()
    assert text.count(">") == 3


def test_msa_auto_engine_matches_scan():
    """The MSA is engine-invariant: "auto" rows == "scan" rows (same
    center, same merge)."""
    seqs = ["ACACACTA", "AGCACACA", "ACACAGTA", "CACACTA"]
    ref = _msa(seqs)
    got = center_star_msa(_container(seqs), SCORES, engine="auto")
    assert got.rows == ref.rows
    assert got.center_index == ref.center_index


def test_build_rows_matches_sequential_merge():
    """The O(width) slot-count merge (round 4) is bit-identical to
    the sequential two-pointer merge it replaced, on random op
    fuzz."""
    from genomics_rs_tpu.models.msa import (
        _build_rows,
        _gapped_pair,
        _merge_center,
    )

    rng = np.random.default_rng(77)
    for trial in range(30):
        C = int(rng.integers(1, 25))
        center = "".join(rng.choice(list("ACGT"), C))
        K1 = int(rng.integers(1, 5))
        others, ops_list = [], []
        for _ in range(K1):
            # A random valid op string: exactly C center-consuming
            # ops (M/D) with random I runs sprinkled in.
            ops = []
            oi = 0
            for p in range(C + 1):
                for _ in range(int(rng.integers(0, 3))):
                    ops.append("I")
                    oi += 1
                if p < C:
                    op = "M" if rng.random() < 0.7 else "D"
                    ops.append(op)
                    if op == "M":
                        oi += 1
            others.append("".join(rng.choice(list("ACGT"), oi)))
            ops_list.append("".join(ops))

        master_new, rows_new = _build_rows(center, others, ops_list)

        master_old = center
        rows_old: list[str] = []
        for other, ops in zip(others, ops_list):
            gc, go = _gapped_pair(center, other, ops)
            master_old, rows_old, padded = _merge_center(
                master_old, rows_old, gc, go
            )
            rows_old.append(padded)
        assert master_new == master_old, trial
        assert rows_new == rows_old, trial
