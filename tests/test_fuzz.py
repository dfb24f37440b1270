"""Parameter-space fuzzing beyond the reference's goldens.

The golden tests pin two scoring configs; these fuzz the engines
against the numpy oracle across scoring edge cases (zero gap-open,
zero extension, positive mismatch, asymmetric lengths) and the two
suffix-tree implementations against each other on random multi-string
corpora. Shapes are fixed so each engine compiles once.
"""

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence
from tests.test_alignment import _numpy_gotoh_score

from conftest import data_path

LPAD = 64

SCORE_GRID = [
    Scores(1, -2, -1, -5),
    Scores(1, -2, -2, 0),  # free gap open
    Scores(1, -2, 0, -5),  # free gap extension
    Scores(2, 1, -1, -3),  # positive mismatch
    Scores(5, -4, -3, -1),
]


def _enc(s, pv):
    return Sequence("x", s).encoded(pad_to=LPAD, pad_value=pv)


@pytest.mark.parametrize("sc", SCORE_GRID, ids=lambda s: str(s.as_tuple()))
def test_scan_vs_numpy_score_grid(sc):
    rng = np.random.default_rng(abs(hash(sc.as_tuple())) % 2**31)
    for trial in range(6):
        m = int(rng.integers(1, 50))
        n = int(rng.integers(1, 50))
        a = "".join(rng.choice(list("ACGT"), m))
        b = "".join(rng.choice(list("ACGT"), n))
        got = gotoh_fill_scan(
            _enc(a, PAD_S1), _enc(b, PAD_S2), m, n, sc, False
        )
        want = _numpy_gotoh_score(a, b, sc)
        assert int(got.score) == want, (trial, sc.as_tuple(), a, b)


def test_native_gotoh_vs_numpy_score_grid():
    from genomics_rs_tpu.suffixtree import native_available

    if not native_available():
        pytest.skip("native library not built")
    from genomics_rs_tpu.suffixtree.native import gotoh_score_cpu

    rng = np.random.default_rng(5)
    for sc in SCORE_GRID:
        for trial in range(6):
            m = int(rng.integers(1, 60))
            n = int(rng.integers(1, 60))
            a = "".join(rng.choice(list("ACGT"), m))
            b = "".join(rng.choice(list("ACGT"), n))
            got = gotoh_score_cpu(
                a.encode(), b.encode(), *sc.as_tuple(), False
            )[0]
            assert got == _numpy_gotoh_score(a, b, sc), (sc.as_tuple(), a, b)


def test_tree_impls_agree_random_corpora():
    """Python vs C++ trees: stats, BWT and LCS identical on random
    multi-string inputs (2-5 strings, duplicate strings included)."""
    from genomics_rs_tpu.suffixtree import native_available
    from genomics_rs_tpu.suffixtree.native import NativeSuffixTree
    from genomics_rs_tpu.suffixtree.tree import SuffixTree

    if not native_available():
        pytest.skip("native library not built")

    alpha = data_path("alphabets", "dna.txt")
    rng = np.random.default_rng(9)
    for trial in range(8):
        k = int(rng.integers(2, 6))
        strings = []
        for _ in range(k):
            n = int(rng.integers(3, 60))
            strings.append("".join(rng.choice(list("ACGT"), n)))
        if trial % 3 == 0:
            strings[1] = strings[0]  # duplicate-string path

        tp = SuffixTree(alpha, 64)
        tn = NativeSuffixTree(alpha, 64)
        for s in strings:
            tp.insert_string(s, True, False)
            tn.insert_string(s, True, False)
        sp = tp.compute_stats(0)
        sn = tn.compute_stats(0)
        assert (sp.num_nodes, sp.num_internal, sp.num_leaves) == (
            sn.num_nodes,
            sn.num_internal,
            sn.num_leaves,
        ), (trial, strings)
        assert sp.bwt == sn.bwt, (trial, strings)
        for a in range(k):
            for b in range(a + 1, k):
                assert tp.get_lcs(a, b) == tn.get_lcs(a, b), (
                    trial,
                    strings,
                    a,
                    b,
                )


def test_device_bwt_vs_tree_random():
    """Device suffix-array BWT equals the tree BWT on random strings."""
    from genomics_rs_tpu.ops.bwt_device import bwt_device
    from genomics_rs_tpu.suffixtree.tree import SuffixTree

    alpha = data_path("alphabets", "dna.txt")
    rng = np.random.default_rng(13)
    for trial in range(5):
        n = int(rng.integers(4, 120))
        s = "".join(rng.choice(list("ACGT"), n))
        tree = SuffixTree(alpha, n)
        tree.insert_string(s, True, False)
        st = tree.compute_stats(0)
        assert bwt_device(s) == st.bwt, (trial, s)


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_batch_vs_host_walker_score_grid(is_local):
    """Batched lockstep walk + whole-batch classification equals the
    per-pair host walker across the scoring grid (paths, stats,
    tie-breaks — the open-vs-extend and is_match quirks are scoring-
    sensitive, so the goldens' two configs are not enough)."""
    import jax

    from genomics_rs_tpu.ops.traceback import traceback_host
    from genomics_rs_tpu.ops.traceback_batch import (
        classify_batch,
        walk_batch,
    )

    rng = np.random.default_rng(17)
    qs, rs = [], []
    for b in range(8):
        m = int(rng.integers(2, 50))
        n = int(rng.integers(2, 50))
        q = "".join(rng.choice(list("ACGT"), m))
        r = "".join(rng.choice(list("ACGT"), n))
        if b % 2:  # related pairs: long SUB runs + gaps
            r = (q[: max(1, m // 2)] + r)[:n]
        qs.append(Sequence(f"q{b}", q))
        rs.append(Sequence(f"r{b}", r))
    s1b = np.stack([s.encoded(pad_to=LPAD, pad_value=PAD_S1) for s in qs])
    s2b = np.stack([s.encoded(pad_to=LPAD, pad_value=PAD_S2) for s in rs])
    ms = np.array([len(s) for s in qs], np.int32)
    ns = np.array([len(s) for s in rs], np.int32)

    def one(s1e, s2e, m, n, sc):
        res = gotoh_fill_scan(s1e, s2e, m, n, sc, is_local)
        return res.dirs, res.score, res.start_i, res.start_j

    fill = jax.jit(jax.vmap(one, (0, 0, 0, 0, None)))
    for sc in SCORE_GRID:
        dirs, score, si, sj = fill(s1b, s2b, ms, ns, sc)
        moves, counts, _, _, done = walk_batch(
            dirs, si, sj, "diag", 2 * LPAD + 1
        )
        assert bool(np.all(np.asarray(done))), sc.as_tuple()
        aligned, _ = classify_batch(
            np.asarray(moves), np.asarray(counts), np.asarray(si),
            np.asarray(sj), np.asarray(score), qs, rs, with_paths=True,
        )
        for b in range(len(qs)):
            want = traceback_host(
                np.asarray(dirs[b]), int(si[b]), int(sj[b]),
                int(score[b]), qs[b], rs[b], is_local,
            )
            got = aligned[b]
            assert got.alignment == want.alignment, (sc.as_tuple(), b)
            assert (
                got.score, got.matches, got.mismatches,
                got.gap_extensions, got.opening_gaps,
            ) == (
                want.score, want.matches, want.mismatches,
                want.gap_extensions, want.opening_gaps,
            ), (sc.as_tuple(), b)


@pytest.mark.parametrize("is_local", [False, True])
def test_align_batch_vs_scan_score_grid(is_local):
    """align_batch across the scoring grid vs the packed-dirs
    pipeline (scan dirs packed 16 per word, lockstep ``diag16`` walk,
    whole-batch classification) — paths/stats must match at every
    edge-case parameterization."""
    import jax.numpy as jnp

    from genomics_rs_tpu.models.aligner import align_batch
    from genomics_rs_tpu.ops.gotoh_scan import pack_dirs
    from genomics_rs_tpu.ops.traceback_batch import (
        classify_batch,
        walk_batch,
    )

    rng = np.random.default_rng(61 + int(is_local))
    for sc in SCORE_GRID:
        pairs = []
        base = "".join(rng.choice(list("ACGT"), 56))
        pairs.append((Sequence("a", base), Sequence("b", base[20:])))
        for _ in range(2):
            m = int(rng.integers(8, 60))
            n = int(rng.integers(8, 60))
            pairs.append(
                (
                    Sequence("a", "".join(rng.choice(list("ACGT"), m))),
                    Sequence("b", "".join(rng.choice(list("ACGT"), n))),
                )
            )
        got = align_batch(pairs, sc, is_local=is_local)
        fills = [
            gotoh_fill_scan(
                _enc(a.sequence, PAD_S1), _enc(b.sequence, PAD_S2),
                len(a), len(b), sc, is_local,
            )
            for a, b in pairs
        ]
        si = np.array([int(f.start_i) for f in fills], np.int32)
        sj = np.array([int(f.start_j) for f in fills], np.int32)
        moves, counts, _, _, done = walk_batch(
            jnp.stack([pack_dirs(f.dirs) for f in fills]),
            si, sj, "diag16", 2 * LPAD + 1,
        )
        assert bool(np.all(np.asarray(done))), sc.as_tuple()
        walked, _ = classify_batch(
            np.asarray(moves), np.asarray(counts), si, sj,
            np.array([int(f.score) for f in fills]),
            [a for a, _ in pairs], [b for _, b in pairs],
        )
        for (s1, s2), g, w in zip(pairs, got, walked):
            assert (
                g.score,
                g.alignment,
                g.matches,
                g.mismatches,
                g.opening_gaps,
                g.gap_extensions,
            ) == (
                w.score,
                w.alignment,
                w.matches,
                w.mismatches,
                w.opening_gaps,
                w.gap_extensions,
            ), (sc.as_tuple(), s1.sequence, s2.sequence)
