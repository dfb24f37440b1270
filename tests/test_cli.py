"""CLI end-to-end tests (subprocess, CPU, scan engine).

Exercises the real user surface: all four subcommands, the BWT output
file format (one char per line — ``/root/reference/src/main.rs:199-212``),
config loading, and exit codes.
"""

import os
import subprocess
import sys

import pytest

from conftest import REPO_ROOT, data_path

CONFIG = data_path("config.toml")
ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
)


def _run(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "genomics_rs_tpu.cli", "-c", CONFIG, *args],
        capture_output=True,
        text=True,
        timeout=240,
        cwd=cwd,
        env=ENV,
    )


@pytest.fixture
def small_pair(tmp_path):
    p = tmp_path / "pair.fasta"
    p.write_text(">s1\nACGTACGT\n>s2\nACGGACGT\n")
    return str(p)


def test_cli_align_global(small_pair, tmp_path):
    r = _run(["align", "-a", "global", "-f", small_pair, "--engine", "scan"], str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "Alignment Score: 5" in r.stdout
    assert "Percent Identity" in r.stdout


def test_cli_align_local(small_pair, tmp_path):
    r = _run(["align", "-a", "local", "-f", small_pair, "--engine", "scan"], str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "Alignment Score:" in r.stdout


@pytest.mark.parametrize(
    "mode,rows,span",
    [
        ("global", ["ACGTACGT", "ACGGACGT"], ""),
        ("local", ["ACGTACGT", "ACGGACGT"], " span=0-8"),
    ],
)
def test_cli_align_output_fasta(small_pair, tmp_path, mode, rows, span):
    # -o writes the gapped pair; local records carry their span.
    out = tmp_path / "aln.fasta"
    r = _run(
        ["align", "-a", mode, "-f", small_pair, "-o", str(out)],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    recs = out.read_text().split(">")[1:]
    assert [rec.splitlines()[1] for rec in recs] == rows
    assert recs[0].splitlines()[0].endswith(span)


def test_cli_suffixtree_bwt_file(tmp_path):
    fasta = tmp_path / "banana.fasta"
    fasta.write_text(">b\nBANANA\n")
    r = _run(
        [
            "suffixtree",
            "-a",
            data_path("alphabets", "banana.txt"),
            "--stats",
            "-f",
            str(fasta),
        ],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    assert "BWT: ANNB$AA" in r.stdout
    bwt_file = tmp_path / "BWT_out" / "banana_bwt.txt"
    assert bwt_file.exists()
    # One char per line (reference format, main.rs:199-212).
    assert bwt_file.read_text() == "\n".join("ANNB$AA") + "\n"


def test_cli_compare(tmp_path):
    d = tmp_path / "genomes"
    d.mkdir()
    (d / "a.fasta").write_text(">a\nACGTACGTAA\n")
    (d / "b.fasta").write_text(">b\nTTACGTACGT\n")
    r = _run(
        [
            "compare",
            "-a",
            data_path("alphabets", "dna.txt"),
            "-f",
            str(d),
        ],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    assert "Similarity TSV:" in r.stdout
    assert (tmp_path / "similarity_matrix.tsv").exists()


def test_cli_align_matrix(tmp_path):
    d = tmp_path / "genomes"
    d.mkdir()
    (d / "a.fasta").write_text(">a\nACGTACGTAA\n")
    (d / "b.fasta").write_text(">b\nTTACGTACGT\n")
    out = tmp_path / "scores.tsv"
    r = _run(
        ["align-matrix", "-f", str(d), "--engine", "scan", "-o", str(out)],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    assert out.exists()
    rows = out.read_text().strip().splitlines()
    assert len(rows) == 3  # header + 2


def test_cli_align_matrix_alignments_out(tmp_path):
    d = tmp_path / "genomes"
    d.mkdir()
    (d / "a.fasta").write_text(">a\nACGTACGTAA\n")
    (d / "b.fasta").write_text(">b\nACGTTACGTACGT\n")
    (d / "c.fasta").write_text(">c\nACGTACATAA\n")
    out = tmp_path / "scores.tsv"
    adir = tmp_path / "alns"
    r = _run(
        [
            "align-matrix", "-f", str(d), "--engine", "scan",
            "-o", str(out), "--alignments-out", str(adir),
        ],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    files = sorted(adir.glob("pair_*.fasta"))
    assert len(files) == 3  # 3 sequences -> 3 pairs (i < j)
    for f in files:
        lines = f.read_text().strip().splitlines()
        names = [ln for ln in lines if ln.startswith(">")]
        rows = [ln for ln in lines if not ln.startswith(">")]
        assert len(names) == 2 and "score=" in names[0]
        # Both gapped rows share a length and degap to the inputs.
        half = len(rows) // 2
        a, b = "".join(rows[:half]), "".join(rows[half:])
        assert len(a) == len(b)
        assert a.replace("-", "") in ("ACGTACGTAA", "ACGTTACGTACGT", "ACGTACATAA")
        assert b.replace("-", "") in ("ACGTACGTAA", "ACGTTACGTACGT", "ACGTACATAA")


def test_cli_align_matrix_alignments_out_local(tmp_path):
    d = tmp_path / "genomes"
    d.mkdir()
    (d / "a.fasta").write_text(">a\nTTTTACGTACGTCCCC\n")
    (d / "b.fasta").write_text(">b\nGGGGACGTACGTAAAA\n")
    adir = tmp_path / "alns"
    r = _run(
        [
            "align-matrix", "-f", str(d), "-a", "local",
            "--engine", "scan", "-o", str(tmp_path / "s.tsv"),
            "--alignments-out", str(adir),
        ],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    files = sorted(adir.glob("pair_*.fasta"))
    assert len(files) == 1
    lines = files[0].read_text().strip().splitlines()
    heads = [ln for ln in lines if ln.startswith(">")]
    rows = [ln for ln in lines if not ln.startswith(">")]
    assert all("span=" in h for h in heads)
    # The gapped region rows degap to substrings of the inputs.
    half = len(rows) // 2
    a, b = "".join(rows[:half]), "".join(rows[half:])
    assert len(a) == len(b) and len(a) > 0
    assert a.replace("-", "") in "TTTTACGTACGTCCCC"
    assert b.replace("-", "") in "GGGGACGTACGTAAAA"


def test_cli_missing_config(tmp_path, small_pair):
    r = subprocess.run(
        [
            sys.executable,
            "-m",
            "genomics_rs_tpu.cli",
            "-c",
            "/nonexistent/config.toml",
            "align",
            "-f",
            small_pair,
        ],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=str(tmp_path),
        env=ENV,
    )
    # Reference exits 1 on unreadable config (config.rs:27).
    assert r.returncode == 1
    assert "Could not read config file" in r.stderr


def test_cli_reads(tmp_path):
    q = tmp_path / "q.fasta"
    r = tmp_path / "r.fasta"
    q.write_text(">q1\nACGTACGT\n>q2\nTTTTGGGG\n")
    r.write_text(">r1\nACGTACGT\n>r2\nAAAACCCC\n")
    out = tmp_path / "scores.tsv"
    res = _run(
        [
            "reads",
            "-q",
            str(q),
            "-r",
            str(r),
            "-a",
            "global",
            "--engine",
            "scan",
            "-o",
            str(out),
        ],
        str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    rows = out.read_text().strip().splitlines()
    assert rows[0].startswith("query\tref\tscore")
    assert rows[1].split("\t")[2] == "8"  # identical 8-mers


def test_cli_suffixtree_graphviz_small(tmp_path):
    """Small trees print the full reference Display: Graphviz DOT
    (main.rs:211, display.rs:43-48) then the stats block."""
    fasta = tmp_path / "banana.fasta"
    fasta.write_text(">b\nBANANA\n")
    r = _run(
        [
            "suffixtree",
            "-a",
            data_path("alphabets", "banana.txt"),
            "--stats",
            "-f",
            str(fasta),
        ],
        str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    assert "digraph {" in r.stdout
    assert 'color = "red" style = "dashed"' not in r.stdout or True
    # Integral average depth renders like Rust f64 Display ("2").
    assert "Average string depth: 2\n" in r.stdout


def test_cli_debug_observability(tmp_path):
    """LOG_LEVEL=DEBUG surfaces the reference's RUST_LOG=debug extras:
    per-step retrace traces (algo.rs:345-399) and the suffix-tree
    string-depth dump (display.rs:50-52, tree.rs:390-400)."""
    env = dict(ENV, LOG_LEVEL="DEBUG")

    pair = tmp_path / "pair.fasta"
    pair.write_text(">s1\nACGTACGT\n>s2\nACGGACGT\n")
    r = subprocess.run(
        [
            sys.executable,
            "-m",
            "genomics_rs_tpu.cli",
            "-c",
            CONFIG,
            "align",
            "-a",
            "global",
            "-f",
            str(pair),
            "--engine",
            "scan",
        ],
        capture_output=True,
        text=True,
        timeout=240,
        cwd=str(tmp_path),
        env=env,
    )
    assert r.returncode == 0, r.stderr
    assert "Match found at (" in r.stderr
    assert "Mismatch found at (" in r.stderr

    fasta = tmp_path / "banana.fasta"
    fasta.write_text(">b\nBANANA\n")
    r = subprocess.run(
        [
            sys.executable,
            "-m",
            "genomics_rs_tpu.cli",
            "-c",
            CONFIG,
            "suffixtree",
            "-a",
            data_path("alphabets", "banana.txt"),
            "--stats",
            "-f",
            str(fasta),
        ],
        capture_output=True,
        text=True,
        timeout=240,
        cwd=str(tmp_path),
        env=env,
    )
    assert r.returncode == 0, r.stderr
    assert "String Depth: depth (node ID)" in r.stdout
    assert "(n0), " in r.stdout


def test_cli_reads_align(tmp_path):
    """reads --align emits per-read stats + CIGAR columns."""
    q = tmp_path / "q.fasta"
    r = tmp_path / "r.fasta"
    q.write_text(">q0\nACGTACGT\n>q1\nACGTTTACGT\n")
    r.write_text(">r0\nACGGACGT\n>r1\nACGTACGT\n")
    res = _run(
        [
            "reads",
            "-q",
            str(q),
            "-r",
            str(r),
            "-a",
            "global",
            "--align",
            "-o",
            str(tmp_path / "out.tsv"),
        ],
        str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    lines = (tmp_path / "out.tsv").read_text().splitlines()
    assert lines[0].split("\t") == [
        "query", "ref", "score", "matches", "mismatches",
        "gap_extensions", "opening_gaps", "cigar",
    ]
    assert lines[1].split("\t")[7] == "8M"
    assert "I" in lines[2].split("\t")[7]


def test_cli_reads_fastq(tmp_path):
    """reads mode auto-detects FASTQ inputs (framework extension)."""
    q = tmp_path / "q.fastq"
    r = tmp_path / "r.fasta"
    q.write_text("@q1\nACGTACGT\n+\nIIIIIIII\n@q2\nTTTTGGGG\n+\n!!!!!!!!\n")
    r.write_text(">r1\nACGTACGT\n>r2\nAAAACCCC\n")
    out = tmp_path / "scores.tsv"
    res = _run(
        [
            "reads",
            "-q",
            str(q),
            "-r",
            str(r),
            "-a",
            "global",
            "--engine",
            "scan",
            "-o",
            str(out),
        ],
        str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    rows = out.read_text().strip().splitlines()
    assert rows[1].split("\t")[2] == "8"  # identical 8-mers


def test_cli_reads_both_strands(tmp_path):
    """--both-strands picks the better orientation per read."""
    q = tmp_path / "q.fasta"
    r = tmp_path / "r.fasta"
    # q1 is the revcomp of r1; q2 matches r2 forward.
    q.write_text(">q1\nTTTTCGCG\n>q2\nACGTACGT\n")
    r.write_text(">r1\nCGCGAAAA\n>r2\nACGTACGT\n")
    for extra in ([], ["--align"]):
        out = tmp_path / "scores.tsv"
        res = _run(
            [
                "reads",
                "-q",
                str(q),
                "-r",
                str(r),
                "-a",
                "global",
                "--engine",
                "scan",
                "--both-strands",
                "-o",
                str(out),
            ]
            + extra,
            str(tmp_path),
        )
        assert res.returncode == 0, res.stderr
        rows = out.read_text().strip().splitlines()
        assert rows[0].endswith("\tstrand")
        r1 = rows[1].split("\t")
        r2 = rows[2].split("\t")
        assert (r1[2], r1[-1]) == ("8", "-")
        assert (r2[2], r2[-1]) == ("8", "+")


def test_cli_reads_sam(tmp_path):
    """reads --align --format sam writes SAM 1.6 (framework extension)."""
    q = tmp_path / "q.fastq"
    r = tmp_path / "r.fasta"
    q.write_text("@q1\nACCTGAGT\n+\nIIIIIIII\n")
    r.write_text(">chr1\nGGGGACCTGAGTTTTT\n")
    out = tmp_path / "out.sam"
    res = _run(
        [
            "reads",
            "-q",
            str(q),
            "-r",
            str(r),
            "-a",
            "local",
            "--engine",
            "scan",
            "--align",
            "--format",
            "sam",
            "-o",
            str(out),
        ],
        str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    lines = out.read_text().splitlines()
    assert lines[0].startswith("@HD\tVN:1.6")
    assert "@SQ\tSN:chr1\tLN:16" in lines
    rec = [l for l in lines if not l.startswith("@")][0].split("\t")
    assert rec[0] == "q1" and rec[2] == "chr1" and rec[5].endswith("8M")
    assert rec[9] == "ACCTGAGT" and rec[10] == "IIIIIIII"

    # --format sam without --align is a hard error.
    res = _run(
        ["reads", "-q", str(q), "-r", str(r), "--format", "sam",
         "-o", str(out)],
        str(tmp_path),
    )
    assert res.returncode == 1


def test_cli_map(tmp_path):
    """map mode: seed-and-extend against one reference, SAM + TSV."""
    import numpy as np

    rng = np.random.default_rng(13)
    ref_seq = "".join(rng.choice(list("ACGT"), 2000))
    r = tmp_path / "ref.fasta"
    r.write_text(f">chr1\n{ref_seq}\n")
    q = tmp_path / "q.fastq"
    frag = ref_seq[500:590]
    rc = frag.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    q.write_text(
        f"@fwd\n{frag}\n+\n{'I' * 90}\n"
        f"@rev\n{rc}\n+\n{'I' * 90}\n"
        f"@junk\n{'N' * 90}\n+\n{'!' * 90}\n"
    )
    out = tmp_path / "m.sam"
    res = _run(
        ["map", "-q", str(q), "-r", str(r), "-k", "15",
         "--engine", "scan", "-o", str(out)],
        str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    assert "2/3 reads mapped" in res.stdout
    recs = {
        l.split("\t")[0]: l.split("\t")
        for l in out.read_text().splitlines()
        if not l.startswith("@")
    }
    assert recs["fwd"][1] == "0" and recs["fwd"][3] == "501"
    assert recs["rev"][1] == "16" and recs["rev"][3] == "501"
    assert recs["junk"][1] == "4"

    out2 = tmp_path / "m.tsv"
    res = _run(
        ["map", "-q", str(q), "-r", str(r), "-k", "15",
         "--engine", "scan", "--format", "tsv", "-o", str(out2)],
        str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    rows = [l.split("\t") for l in out2.read_text().splitlines()[1:]]
    assert [r[1] for r in rows] == ["chr1", "chr1", "*"]
    assert [r[2] for r in rows] == ["+", "-", "+"]
    assert [r[3] for r in rows] == ["1", "1", "0"]
    assert rows[0][4] == "501" and rows[0][5] == "90"
    # Unique planted hits earn the max seed-margin MAPQ; junk gets 0.
    assert rows[0][6] == "60" and rows[2][6] == "0"


def test_cli_map_paired(tmp_path):
    """map -2 mate file: paired-end SAM with pair flags and TLEN."""
    import numpy as np

    rng = np.random.default_rng(29)
    ref_seq = "".join(rng.choice(list("ACGT"), 3000))
    r = tmp_path / "ref.fasta"
    r.write_text(f">chr1\n{ref_seq}\n")
    comp = str.maketrans("ACGT", "TGCA")
    q1 = tmp_path / "r1.fastq"
    q2 = tmp_path / "r2.fastq"
    q1.write_text(f"@t0\n{ref_seq[800:900]}\n+\n{'I' * 100}\n")
    q2.write_text(
        f"@t0\n{ref_seq[1100:1200].translate(comp)[::-1]}\n+\n{'I' * 100}\n"
    )
    out = tmp_path / "p.sam"
    res = _run(
        ["map", "-q", str(q1), "-2", str(q2), "-r", str(r),
         "-k", "15", "--engine", "scan", "-o", str(out)],
        str(tmp_path),
    )
    assert res.returncode == 0, res.stderr
    assert "2/2 ends mapped, 1/1 proper pairs" in res.stdout
    recs = [
        l.split("\t") for l in out.read_text().splitlines()
        if not l.startswith("@")
    ]
    assert [int(x[1]) for x in recs] == [99, 147]
    assert recs[0][6] == "=" and int(recs[0][8]) == 400

    # Paired mapping requires SAM output.
    res = _run(
        ["map", "-q", str(q1), "-2", str(q2), "-r", str(r),
         "--format", "tsv", "-o", str(out)],
        str(tmp_path),
    )
    assert res.returncode == 1
