#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU, checked against oracles.

    python chip_smoke.py [--seed N]        # one card: all phases
    python chip_smoke.py --four-cards      # four cards: the mesh paths

Every input is generated from ``--seed`` inside the repository (work
files go to ``.smoke/``, removed at the end). One process runs every
phase and calls the CLI in-process (``genomics_rs_tpu.cli.main``):
a JAX process reserves most of the card's memory, so a second one
could not start.

One card, at the sizes users run (a SARS-CoV-2-length genome is
29,903 bp, NCBI NC_045512.2):

* ``align`` — two related 29,903 bp genomes, ``align -a global`` and
  ``-a local`` with full traceback. The score must equal the C++
  oracle (``native/gotoh_cpu.cpp``); the emitted alignment must spell
  the inputs and re-score on the host to at most the DP score (the
  reference's state-less retrace can emit a path below the optimum,
  so the gap is reported, not required to be zero).
* ``align-matrix`` — 10 seeded ~30 kb mutants: all 55 pairs global,
  and the 6 pairs of 3 of them local; every score equals the oracle.
* ``map`` — 50,000 reads of 150 bp (both strands, ~1% errors) against
  a 10 Mb reference in two contigs. At least ``MAP_MIN_CORRECT`` of
  the reads must map to their simulated origin; the ``AS:i`` of 200
  sampled reads must equal the oracle on the same read and window.
* ``bwt`` — the ``suffixtree`` subcommand writes a 29,903 bp genome's
  BWT with the C++ tree; the device suffix-array BWT must equal it.

Each phase prints one JSON line (card, cold and warm seconds, DP
cells/s, peak device bytes, check result); the last line is
``{"ok": true, "device": {...}}``. Any failure raises, and the exit
code is then non-zero; without a GPU the script exits 2 before any
phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "data", "config.toml")
DNA_ALPHABET = os.path.join(REPO, "data", "alphabets", "dna.txt")

#: NCBI NC_045512.2 (SARS-CoV-2 reference genome) length.
GENOME_LEN = 29903
#: Fraction of simulated reads that must map to their origin contig,
#: strand and position (within ``MAP_POS_SLACK`` bases, which absorbs
#: soft clips at error-bearing read ends).
MAP_MIN_CORRECT = 0.95
MAP_POS_SLACK = 20

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


# --------------------------------------------------------------------------
# Seeded inputs
# --------------------------------------------------------------------------


def random_dna(rng: np.random.Generator, n: int) -> str:
    return _BASES[rng.integers(0, 4, n)].tobytes().decode()


def mutate(
    rng: np.random.Generator,
    seq: str,
    sub_rate: float = 0.01,
    n_indels: int = 20,
    max_indel: int = 10,
) -> str:
    """A related genome: substitutions at ``sub_rate``, then
    ``n_indels`` insertions/deletions of 1..``max_indel`` bases."""
    s = np.frombuffer(seq.encode(), np.uint8).copy()
    hit = rng.random(len(s)) < sub_rate
    # A substitution always changes the base (+1..3 mod 4).
    idx = np.searchsorted(_BASES, s[hit])
    s[hit] = _BASES[(idx + rng.integers(1, 4, int(hit.sum()))) % 4]
    out = s.tobytes().decode()
    for _ in range(n_indels):
        p = int(rng.integers(0, len(out)))
        k = int(rng.integers(1, max_indel + 1))
        if rng.random() < 0.5:
            out = out[:p] + out[p + k :]
        else:
            out = out[:p] + random_dna(rng, k) + out[p:]
    return out


def write_fasta(path: str, records: list[tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for p in range(0, len(seq), 80):
                f.write(seq[p : p + 80] + "\n")


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def simulate_reads(
    rng: np.random.Generator,
    contigs: list[tuple[str, str]],
    n_reads: int,
    read_len: int = 150,
    err_rate: float = 0.01,
) -> list[tuple[str, str, str]]:
    """(name, bases, qualities) reads drawn uniformly from the contigs
    on both strands with ``err_rate`` substitutions. The origin is in
    the name: ``r<k>_<contig index>_<0-based start>_<+|->``."""
    lens = np.array([len(s) for _, s in contigs], np.int64)
    cid = rng.choice(len(contigs), n_reads, p=lens / lens.sum())
    reads = []
    for k in range(n_reads):
        c = int(cid[k])
        seq = contigs[c][1]
        p = int(rng.integers(0, len(seq) - read_len))
        frag = seq[p : p + read_len]
        strand = "-" if rng.random() < 0.5 else "+"
        if strand == "-":
            frag = revcomp(frag)
        b = np.frombuffer(frag.encode(), np.uint8).copy()
        hit = rng.random(read_len) < err_rate
        idx = np.searchsorted(_BASES, b[hit])
        b[hit] = _BASES[(idx + rng.integers(1, 4, int(hit.sum()))) % 4]
        reads.append((f"r{k}_{c}_{p}_{strand}", b.tobytes().decode(), "I" * read_len))
    return reads


def write_fastq(path: str, reads: list[tuple[str, str, str]]) -> None:
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


# --------------------------------------------------------------------------
# Host-side checks
# --------------------------------------------------------------------------


def oracle_score(a: str, b: str, scores, is_local: bool) -> int:
    """The C++ reference-equivalent fill's score."""
    from genomics_rs_tpu.suffixtree.native import gotoh_score_cpu

    return gotoh_score_cpu(
        a.encode(),
        b.encode(),
        scores.s_match,
        scores.s_mismatch,
        scores.g,
        scores.h,
        is_local,
    )[0]


def oracle_scores(jobs: list[tuple[str, str, bool]], scores) -> list[int]:
    """Oracle scores of many pairs on a host thread pool (the ctypes
    call releases the GIL)."""
    workers = max(1, len(os.sched_getaffinity(0)))
    with ThreadPoolExecutor(workers) as pool:
        return list(
            pool.map(lambda j: oracle_score(j[0], j[1], scores, j[2]), jobs)
        )


def read_pair_fasta(path: str) -> list[tuple[str, str]]:
    """(header, gapped row) records of an ``align -o`` file."""
    recs = []
    with open(path) as f:
        for block in f.read().split(">")[1:]:
            lines = block.splitlines()
            recs.append((lines[0], "".join(lines[1:])))
    return recs


def rescore_gapped(row_a: str, row_b: str, scores, is_local: bool) -> int:
    """Score of a gapped alignment under the reference recurrence: a
    gap column opens (h + g) unless the previous column was a gap in
    the same row, else extends (g); local mode floors every step at
    the zero lane exactly as the fill does (``gotoh_scan``)."""
    v = 0
    prev = None
    for ca, cb in zip(row_a, row_b):
        if ca != "-" and cb != "-":
            c = scores.s_match if ca == cb else scores.s_mismatch
            v = c + max(v, 0) if is_local else v + c
            prev = "S"
            continue
        kind = "I" if ca == "-" else "D"
        c = scores.g if prev == kind else scores.h + scores.g
        v = max(v + c, 0) if is_local else v + c
        prev = kind
    return v


def read_score_tsv(path: str) -> np.ndarray:
    """The lower-triangle matrix an ``align-matrix`` TSV holds."""
    with open(path) as f:
        rows = f.read().splitlines()[1:]
    return np.array(
        [[int(x) for x in r.split("\t")[1:-1]] for r in rows], np.int64
    )


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def run_cli(argv: list[str]) -> str:
    """``genomics_rs_tpu.cli.main(argv)`` in this process; returns its
    standard output and raises on a non-zero exit code."""
    from genomics_rs_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue()


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_align(work: str, seed: int, length: int = GENOME_LEN) -> dict:
    from genomics_rs_tpu.config import get_config
    from genomics_rs_tpu.models.aligner import PAD_MULTIPLE
    from genomics_rs_tpu.sequence import round_up

    scores = get_config(CONFIG).scores
    rng = np.random.default_rng(seed)
    a = random_dna(rng, length)
    b = mutate(rng, a)
    fasta = os.path.join(work, "pair.fasta")
    write_fasta(fasta, [("genome", a), ("mutant", b)])
    Lm = round_up(len(a), PAD_MULTIPLE)
    Ln = round_up(len(b), PAD_MULTIPLE)
    modes = {}
    ok = True
    for mode in ("global", "local"):
        is_local = mode == "local"
        out = os.path.join(work, f"aln_{mode}.fasta")
        argv = ["-c", CONFIG, "align", "-a", mode, "-f", fasta, "-o", out]
        stdout, cold = timed(lambda: run_cli(argv))
        stdout, warm = timed(lambda: run_cli(argv))
        score = int(re.search(r"Alignment Score: (-?\d+)", stdout).group(1))
        want = oracle_score(a, b, scores, is_local)
        (ha, ra), (hb, rb) = read_pair_fasta(out)
        if is_local:
            sa = [int(x) for x in re.search(r"span=(\d+)-(\d+)", ha).groups()]
            sb = [int(x) for x in re.search(r"span=(\d+)-(\d+)", hb).groups()]
            spelled = (
                ra.replace("-", "") == a[sa[0] : sa[1]]
                and rb.replace("-", "") == b[sb[0] : sb[1]]
            )
        else:
            spelled = ra.replace("-", "") == a and rb.replace("-", "") == b
        rescored = rescore_gapped(ra, rb, scores, is_local)
        mode_ok = score == want and spelled and rescored <= score
        ok &= mode_ok
        modes[mode] = dict(
            score=score,
            oracle=want,
            path_rescore=rescored,
            path_spells_inputs=spelled,
            cold_s=cold,
            warm_s=warm,
            dp_cells_per_s=(len(a) + 1.0) * (len(b) + 1.0) / warm,
            ok=mode_ok,
        )
    return dict(
        lengths=[len(a), len(b)],
        dirs_bytes=(Lm + Ln + 1) * (Lm + 1),
        cold_s=sum(m["cold_s"] for m in modes.values()),
        warm_s=sum(m["warm_s"] for m in modes.values()),
        dp_cells_per_s=2 * (len(a) + 1.0) * (len(b) + 1.0)
        / sum(m["warm_s"] for m in modes.values()),
        modes=modes,
        ok=ok,
    )


def genome_corpus(seed: int, n: int = 10, length: int = GENOME_LEN):
    """``n`` seeded mutants of one random genome."""
    rng = np.random.default_rng(seed + 1)
    base = random_dna(rng, length)
    return [(f"g{k}", mutate(rng, base)) for k in range(n)]


def phase_align_matrix(
    work: str, seed: int, n: int = 10, n_local: int = 3,
    length: int = GENOME_LEN,
) -> dict:
    from genomics_rs_tpu.config import get_config

    scores = get_config(CONFIG).scores
    genomes = genome_corpus(seed, n, length)
    runs = {}
    jobs, got = [], []
    for mode, k in (("global", n), ("local", n_local)):
        d = os.path.join(work, f"genomes_{mode}")
        os.makedirs(d, exist_ok=True)
        for name, seq in genomes[:k]:
            write_fasta(os.path.join(d, f"{name}.fasta"), [(name, seq)])
        tsv = os.path.join(work, f"scores_{mode}.tsv")
        argv = ["-c", CONFIG, "align-matrix", "-f", d, "-a", mode, "-o", tsv]
        _, cold = timed(lambda: run_cli(argv))
        _, warm = timed(lambda: run_cli(argv))
        mat = read_score_tsv(tsv)
        pairs = [(i, j) for j in range(k) for i in range(j + 1)]
        cells = sum(
            (len(genomes[i][1]) + 1.0) * (len(genomes[j][1]) + 1.0)
            for i, j in pairs
        )
        for i, j in pairs:
            jobs.append((genomes[i][1], genomes[j][1], mode == "local"))
            got.append(int(mat[j, i]))
        runs[mode] = dict(
            pairs=len(pairs),
            cold_s=cold,
            warm_s=warm,
            dp_cells_per_s=cells / warm,
        )
    want = oracle_scores(jobs, scores)
    mismatches = sum(int(g != w) for g, w in zip(got, want))
    return dict(
        pairs=len(jobs),
        cold_s=sum(r["cold_s"] for r in runs.values()),
        warm_s=sum(r["warm_s"] for r in runs.values()),
        dp_cells_per_s=runs["global"]["dp_cells_per_s"],
        runs=runs,
        oracle_mismatches=mismatches,
        ok=mismatches == 0,
    )


def map_inputs(
    seed: int, ref_len: int, n_reads: int
) -> tuple[list[tuple[str, str]], list[tuple[str, str, str]]]:
    rng = np.random.default_rng(seed + 2)
    split = ref_len * 3 // 5
    contigs = [
        ("contig1", random_dna(rng, split)),
        ("contig2", random_dna(rng, ref_len - split)),
    ]
    return contigs, simulate_reads(rng, contigs, n_reads)


def phase_map(
    work: str, seed: int, ref_len: int = 10_000_000, n_reads: int = 50_000,
    n_sample: int = 200,
) -> dict:
    from genomics_rs_tpu.cli import _build_parser
    from genomics_rs_tpu.config import get_config
    from genomics_rs_tpu.models.mapper import KmerIndex, plan_extensions
    from genomics_rs_tpu.sequence import Sequence

    scores = get_config(CONFIG).scores
    contigs, reads = map_inputs(seed, ref_len, n_reads)
    ref_path = os.path.join(work, "ref.fasta")
    reads_path = os.path.join(work, "reads.fastq")
    sam = os.path.join(work, "mapped.sam")
    write_fasta(ref_path, contigs)
    write_fastq(reads_path, reads)
    argv = ["-c", CONFIG, "map", "-q", reads_path, "-r", ref_path, "-o", sam]
    _, cold = timed(lambda: run_cli(argv))
    stdout, warm = timed(lambda: run_cli(argv))
    # The subcommand's own split of the warm run: seed + extend, index.
    split = re.search(
        r"reads mapped in ([0-9.]+)s \(index \d+ \d+-mers in ([0-9.]+)s",
        stdout,
    )

    records = {}
    with open(sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t")
            as_i = int(t[11].split(":")[2])
            records[t[0]] = (int(t[1]), t[2], int(t[3]), as_i)
    correct = 0
    for name, (flag, rname, pos, _) in records.items():
        _, c, p, strand = name.split("_")
        mapped = not flag & 4
        if (
            mapped
            and rname == contigs[int(c)][0]
            and ("-" if flag & 16 else "+") == strand
            and abs(pos - 1 - int(p)) <= MAP_POS_SLACK
        ):
            correct += 1
    frac = correct / len(reads)

    # The oracle on the same read and window: plan the sampled reads'
    # windows exactly as the map subcommand did (a read's plan depends
    # on that read alone), with the subcommand's own defaults.
    args = _build_parser().parse_args(argv)
    index = KmerIndex([Sequence(n, s) for n, s in contigs], args.k)
    mapped_names = [n for n, r in records.items() if not r[0] & 4]
    rng = np.random.default_rng(seed + 3)
    sample = sorted(
        rng.choice(len(mapped_names), min(n_sample, len(mapped_names)),
                   replace=False)
    )
    by_name = {n: s for n, s, _ in reads}
    queries = [Sequence(mapped_names[k], by_name[mapped_names[k]]) for k in sample]
    plan_kw = dict(
        stride=max(1, args.k // 2) if args.stride is None else args.stride,
        band=args.band,
        max_hits=args.max_hits,
        min_seeds=args.min_seeds,
        both_strands=not args.single_strand,
    )
    plan = plan_extensions(queries, index, **plan_kw)
    jobs = [
        (plan.chosen[i].sequence, w.sequence, True)
        for i, w in zip(plan.mapped_ix, plan.win_seqs)
    ]
    want = oracle_scores(jobs, scores)
    got = [records[queries[i].name][3] for i in plan.mapped_ix]
    as_mismatches = sum(int(g != w) for g, w in zip(got, want)) + (
        len(queries) - len(plan.mapped_ix)
    )
    # DP cells: read x window per extension, from the same planner run
    # on every read (host work, outside the timed runs).
    full = plan_extensions(
        [Sequence(n, s) for n, s, _ in reads], index, **plan_kw
    )
    cells = sum(
        (len(full.chosen[i]) + 1.0) * (len(w) + 1.0)
        for i, w in zip(full.mapped_ix, full.win_seqs)
    )
    return dict(
        reads=len(reads),
        ref_bp=ref_len,
        cold_s=cold,
        warm_s=warm,
        dp_cells_per_s=cells / warm,
        reads_per_s=len(reads) / warm,
        warm_map_s=float(split.group(1)),
        warm_index_s=float(split.group(2)),
        correct_fraction=frac,
        required_fraction=MAP_MIN_CORRECT,
        as_sample=len(queries),
        as_mismatches=as_mismatches,
        ok=frac >= MAP_MIN_CORRECT and as_mismatches == 0,
    )


def phase_bwt(work: str, seed: int, length: int = GENOME_LEN) -> dict:
    from genomics_rs_tpu.ops.bwt_device import bwt_device
    from genomics_rs_tpu.suffixtree import native_available

    rng = np.random.default_rng(seed + 4)
    seq = random_dna(rng, length)
    work = os.path.abspath(work)  # the CLI runs inside it
    fasta = os.path.join(work, "genome.fasta")
    write_fasta(fasta, [("genome", seq)])
    argv = ["-c", CONFIG, "suffixtree", "-a", DNA_ALPHABET, "--stats",
            "-f", fasta]
    with contextlib.chdir(work):
        _, cli_s = timed(lambda: run_cli(argv))
    with open(os.path.join(work, "BWT_out", "genome_bwt.txt")) as f:
        host = f.read().replace("\n", "")
    dev, cold = timed(lambda: bwt_device(seq))
    dev, warm = timed(lambda: bwt_device(seq))
    return dict(
        length=length,
        native_tree=native_available(),
        suffixtree_cli_s=cli_s,
        cold_s=cold,
        warm_s=warm,
        ok=dev == host,
    )


def pair_batch(genomes):
    """All i <= j pairs of a corpus as one padded encoded batch."""
    from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence, round_up

    seqs = [Sequence(n, s) for n, s in genomes]
    pairs = [(i, j) for j in range(len(seqs)) for i in range(j + 1)]
    L = round_up(max(len(s) for s in seqs), 128)
    s1b = np.stack([seqs[i].encoded(pad_to=L, pad_value=PAD_S1) for i, _ in pairs])
    s2b = np.stack([seqs[j].encoded(pad_to=L, pad_value=PAD_S2) for _, j in pairs])
    ms = np.array([len(seqs[i]) for i, _ in pairs], np.int32)
    ns = np.array([len(seqs[j]) for _, j in pairs], np.int32)
    return pairs, (s1b, s2b, ms, ns)


def phase_data_parallel(seed: int, devices, n: int = 10,
                        length: int = GENOME_LEN) -> dict:
    """(a) The all-pairs corpus on a ``data`` mesh of ``devices`` vs
    one card and vs the oracle."""
    import jax

    from genomics_rs_tpu.config import get_config
    from genomics_rs_tpu.parallel.batch import (
        batch_scores_sharded,
        pad_batch,
        score_pairs,
    )
    from genomics_rs_tpu.parallel.mesh import DATA_AXIS

    scores = get_config(CONFIG).scores
    genomes = genome_corpus(seed, n, length)
    pairs, (s1b, s2b, ms, ns) = pair_batch(genomes)
    mesh = jax.sharding.Mesh(np.asarray(devices), (DATA_AXIS,))
    (s1p, s2p, mp, np_), _ = pad_batch(
        (s1b, s2b, ms, ns), len(pairs), len(devices),
        pad_values=[None, None, 0, 0],
    )

    def sharded():
        out = batch_scores_sharded(mesh, s1p, s2p, mp, np_, scores, False)
        return np.asarray(out.score)[: len(pairs)]

    got, cold = timed(sharded)
    got, warm = timed(sharded)
    with jax.default_device(devices[0]):
        one, one_cold = timed(
            lambda: np.asarray(score_pairs(s1b, s2b, ms, ns, scores)[0])
        )
        one, one_warm = timed(
            lambda: np.asarray(score_pairs(s1b, s2b, ms, ns, scores)[0])
        )
    want = oracle_scores(
        [(genomes[i][1], genomes[j][1], False) for i, j in pairs], scores
    )
    cells = float(np.sum((ms + 1.0) * (ns + 1.0)))
    return dict(
        pairs=len(pairs),
        cold_s=cold,
        warm_s=warm,
        dp_cells_per_s=cells / warm,
        one_card_cold_s=one_cold,
        one_card_warm_s=one_warm,
        ok=got.tolist() == one.tolist() == want,
    )


def phase_seq_parallel_score(seed: int, devices, length: int = 120_000) -> dict:
    """(b) One long pair with rows sharded over a ``seq`` mesh vs the
    single-card scan score."""
    import jax

    from genomics_rs_tpu.config import get_config
    from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
    from genomics_rs_tpu.parallel.longseq import sharded_gotoh_score
    from genomics_rs_tpu.parallel.mesh import SEQ_AXIS
    from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence, round_up

    scores = get_config(CONFIG).scores
    rng = np.random.default_rng(seed + 5)
    a = random_dna(rng, length)
    b = mutate(rng, a)
    P = len(devices)
    L = round_up(max(len(a), len(b)), 128 * P)
    s1e = Sequence("a", a).encoded(pad_to=L, pad_value=PAD_S1)
    s2e = Sequence("b", b).encoded(pad_to=L, pad_value=PAD_S2)
    mesh = jax.sharding.Mesh(np.asarray(devices), (SEQ_AXIS,))

    def sharded():
        res = sharded_gotoh_score(mesh, s1e, s2e, len(a), len(b), scores)
        return int(res.score)

    got, cold = timed(sharded)
    got, warm = timed(sharded)
    single = jax.jit(
        lambda x, y: gotoh_fill_scan(
            x, y, len(a), len(b), scores, False, emit_dirs=False
        ).score
    )
    with jax.default_device(devices[0]):
        want, one_cold = timed(lambda: int(single(s1e, s2e)))
        want, one_warm = timed(lambda: int(single(s1e, s2e)))
    return dict(
        lengths=[len(a), len(b)],
        cold_s=cold,
        warm_s=warm,
        dp_cells_per_s=(len(a) + 1.0) * (len(b) + 1.0) / warm,
        one_card_cold_s=one_cold,
        one_card_warm_s=one_warm,
        ok=got == want,
    )


def phase_seq_parallel_align(seed: int, devices,
                             length: int = GENOME_LEN) -> dict:
    """(c) Full traceback of one pair sharded over a ``seq`` mesh:
    identical to the single-card aligner."""
    import jax

    from genomics_rs_tpu.config import get_config
    from genomics_rs_tpu.models.aligner import PairwiseAligner
    from genomics_rs_tpu.parallel.longseq import align_sharded
    from genomics_rs_tpu.parallel.mesh import SEQ_AXIS
    from genomics_rs_tpu.sequence import Sequence

    scores = get_config(CONFIG).scores
    rng = np.random.default_rng(seed)
    a = random_dna(rng, length)
    sa, sb = Sequence("genome", a), Sequence("mutant", mutate(rng, a))
    mesh = jax.sharding.Mesh(np.asarray(devices), (SEQ_AXIS,))
    got, cold = timed(lambda: align_sharded(mesh, sa, sb, scores))
    got, warm = timed(lambda: align_sharded(mesh, sa, sb, scores))
    with jax.default_device(devices[0]):
        aligner = PairwiseAligner(scores)
        want, one_cold = timed(lambda: aligner.align(sa, sb))
        want, one_warm = timed(lambda: aligner.align(sa, sb))
    return dict(
        lengths=[len(sa), len(sb)],
        cold_s=cold,
        warm_s=warm,
        dp_cells_per_s=(len(sa) + 1.0) * (len(sb) + 1.0) / warm,
        one_card_cold_s=one_cold,
        one_card_warm_s=one_warm,
        ok=got.score == want.score and got.alignment == want.alignment,
    )


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------


def nvidia_smi() -> list[str]:
    """``name, power.limit`` of every card, from a child process that
    stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-card paths, on four cards",
    )
    args = ap.parse_args(argv)

    import jax

    from genomics_rs_tpu.utils.jaxcache import enable_persistent_cache

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX found {dev.platform!r}",
            file=sys.stderr,
        )
        return 2
    want_cards = 4 if args.four_cards else 1
    if len(devices) < want_cards:
        print(
            f"chip_smoke: needs {want_cards} GPUs; JAX found "
            f"{len(devices)}",
            file=sys.stderr,
        )
        return 2
    enable_persistent_cache()
    cards = nvidia_smi()
    print(f"device_kind: {dev.device_kind}; devices: {len(devices)}")
    for line in cards:
        print(f"nvidia-smi: {line}")

    from genomics_rs_tpu.suffixtree import native_available

    if not native_available():
        raise RuntimeError("the C++ oracle (make -C native) did not build")

    work = os.path.join(REPO, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if args.four_cards:
        use = devices[:4]
        phases = [
            ("data_parallel_allpairs",
             lambda: phase_data_parallel(args.seed, use)),
            ("seq_parallel_score",
             lambda: phase_seq_parallel_score(args.seed, use)),
            ("seq_parallel_align",
             lambda: phase_seq_parallel_align(args.seed, use)),
        ]
    else:
        phases = [
            ("align", lambda: phase_align(work, args.seed)),
            ("align-matrix", lambda: phase_align_matrix(work, args.seed)),
            ("map", lambda: phase_map(work, args.seed)),
            ("bwt", lambda: phase_bwt(work, args.seed)),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        res = run()
        line = dict(phase=name, card=cards[0], **res)
        line["phase_s"] = time.perf_counter() - t0
        if args.four_cards:
            line["peak_bytes_in_use"] = [peak_bytes(d) for d in use]
        else:
            line["peak_bytes_in_use"] = peak_bytes(dev)
        print(json.dumps(line), flush=True)
        if not res["ok"]:
            raise SystemExit(f"chip_smoke: phase {name} failed its check")
    shutil.rmtree(work, ignore_errors=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(devices),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
