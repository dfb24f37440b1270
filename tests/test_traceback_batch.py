"""Batched traceback walker + whole-batch classification parity.

``ops/traceback_batch.walk_batch`` must chase every read's direction
codes with exactly the per-pair host walker's semantics (reference
retrace movement rules, ``algo.rs:339-421``), for both code layouts
(diag-major scan cells and their diag16 packed words), and so must
the single-walk ``walk_block``; ``classify_batch`` must reproduce
``classify_moves``'s stats/paths/quirks (``algo.rs:351-399``,
SURVEY §2.4-5) vectorized over the batch.
"""

import numpy as np
import pytest

import jax

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.models.reads import cigar
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.ops.traceback import traceback_host
from genomics_rs_tpu.ops.traceback_batch import classify_batch, walk_batch
from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence, round_up

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


def _random_pairs(rng, B, lo=3, hi=60):
    qs, rs = [], []
    for b in range(B):
        lq = int(rng.integers(lo, hi))
        lr = int(rng.integers(lo, hi))
        q = "".join(rng.choice(list("ACGT"), lq))
        r = "".join(rng.choice(list("ACGT"), lr))
        if b % 2:  # related pairs exercise long SUB runs
            r = (q[: max(1, lq // 2)] + r)[:lr]
        qs.append(Sequence(f"q{b}", q))
        rs.append(Sequence(f"r{b}", r))
    return qs, rs


def _scan_batch(qs, rs, is_local, align=8):
    L1 = round_up(max(len(s) for s in qs), align)
    L2 = round_up(max(len(s) for s in rs), align)
    s1b = np.stack([s.encoded(pad_to=L1, pad_value=PAD_S1) for s in qs])
    s2b = np.stack([s.encoded(pad_to=L2, pad_value=PAD_S2) for s in rs])
    ms = np.array([len(s) for s in qs], np.int32)
    ns = np.array([len(s) for s in rs], np.int32)

    def one(s1e, s2e, m, n):
        res = gotoh_fill_scan(s1e, s2e, m, n, SCORES, is_local)
        return res.dirs, res.score, res.start_i, res.start_j

    dirs, sc, si, sj = jax.vmap(one, (0, 0, 0, 0))(s1b, s2b, ms, ns)
    return L1, L2, dirs, sc, si, sj


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_batch_diag_and_classify_parity(is_local):
    rng = np.random.default_rng(0)
    qs, rs = _random_pairs(rng, 16)
    L1, L2, dirs, sc, si, sj = _scan_batch(qs, rs, is_local)
    moves, counts, i_f, j_f, done = walk_batch(
        dirs, si, sj, "diag", L1 + L2 + 1
    )
    assert bool(np.all(np.asarray(done)))
    aligned, cigs = classify_batch(
        np.asarray(moves),
        np.asarray(counts),
        np.asarray(si),
        np.asarray(sj),
        np.asarray(sc),
        qs,
        rs,
        with_paths=True,
    )
    for b in range(len(qs)):
        ref = traceback_host(
            np.asarray(dirs[b]),
            int(si[b]),
            int(sj[b]),
            int(sc[b]),
            qs[b],
            rs[b],
            is_local,
        )
        got = aligned[b]
        assert got.alignment == ref.alignment, b
        for f in (
            "score",
            "matches",
            "mismatches",
            "gap_extensions",
            "opening_gaps",
        ):
            assert getattr(got, f) == getattr(ref, f), (b, f)
        assert cigs[b] == cigar(ref), b


def _pack_host(cells: np.ndarray) -> np.ndarray:
    """Independent host packing of diag-major cells (K, Mp) into
    (ceil(K/16), Mp) int32 words, 16 codes per word, low bits first."""
    K, Mp = cells.shape
    Kp = -(-K // 16) * 16
    c = np.zeros((Kp, Mp), np.int64)
    c[:K] = cells
    words = np.zeros((Kp // 16, Mp), np.int64)
    for t in range(16):
        words |= c[t::16] << (2 * t)
    return words.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("K", [1, 15, 16, 17, 33, 129])
def test_pack_dirs_layout(K):
    """pack_dirs == the host packing, across word-boundary lengths;
    every code unpacks back with the walkers' shift-and-mask."""
    from genomics_rs_tpu.ops.gotoh_scan import pack_dirs

    rng = np.random.default_rng(K)
    cells = rng.integers(0, 4, (K, 7)).astype(np.uint8)
    words = np.asarray(pack_dirs(jax.numpy.asarray(cells)))
    assert np.array_equal(words, _pack_host(cells))
    k = np.arange(K)[:, None]
    back = (words[k // 16, np.arange(7)[None, :]] >> (2 * (k % 16))) & 3
    assert np.array_equal(back, cells)


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_batch_diag16_matches_diag(is_local):
    # The packed layout walks exactly like the per-cell layout.
    from genomics_rs_tpu.ops.gotoh_scan import pack_dirs

    rng = np.random.default_rng(1)
    qs, rs = _random_pairs(rng, 16)
    L1, L2, dirs, sc, si, sj = _scan_batch(qs, rs, is_local, align=16)
    packed = jax.vmap(pack_dirs)(dirs)
    ref = walk_batch(dirs, si, sj, "diag", L1 + L2 + 1)
    got = walk_batch(packed, si, sj, "diag16", L1 + L2 + 1)
    for name, a, b in zip(("moves", "counts", "i", "j", "done"), ref, got):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("max_steps", [8, 64])
def test_walk_block_matches_host_walker(is_local, max_steps):
    # The single-pair device walk over packed words (resumed when
    # the move buffer fills) vs traceback_host on the same table.
    from genomics_rs_tpu.ops.gotoh_scan import pack_dirs
    from genomics_rs_tpu.ops.traceback import classify_moves
    from genomics_rs_tpu.ops.traceback_device import device_walk

    rng = np.random.default_rng(4)
    qs, rs = _random_pairs(rng, 6)
    L1, L2, dirs, sc, si, sj = _scan_batch(qs, rs, is_local, align=16)
    for b in range(len(qs)):
        codes, i_f, j_f, done = device_walk(
            pack_dirs(dirs[b]), int(si[b]), int(sj[b]), 0,
            max_steps=max_steps,
        )
        assert bool(done), b
        if not is_local:
            assert (int(i_f), int(j_f)) == (0, 0), b
        got = classify_moves(
            codes, int(si[b]), int(sj[b]), int(sc[b]), qs[b], rs[b]
        )
        want = traceback_host(
            np.asarray(dirs[b]), int(si[b]), int(sj[b]), int(sc[b]),
            qs[b], rs[b], is_local,
        )
        assert got.alignment == want.alignment, b
        assert got.score == want.score, b


def test_classify_batch_no_paths_keeps_stats():
    rng = np.random.default_rng(2)
    qs, rs = _random_pairs(rng, 6)
    L1, L2, dirs, sc, si, sj = _scan_batch(qs, rs, False)
    moves, counts, *_ = walk_batch(
        dirs, si, sj, "diag", L1 + L2 + 1
    )
    full, cig_full = classify_batch(
        np.asarray(moves), np.asarray(counts), np.asarray(si),
        np.asarray(sj), np.asarray(sc), qs, rs, with_paths=True,
    )
    lean, cig_lean = classify_batch(
        np.asarray(moves), np.asarray(counts), np.asarray(si),
        np.asarray(sj), np.asarray(sc), qs, rs, with_paths=False,
    )
    assert cig_full == cig_lean
    for a, b in zip(full, lean):
        assert b.alignment == []
        assert (a.score, a.matches, a.mismatches, a.gap_extensions,
                a.opening_gaps) == (
            b.score,
            b.matches,
            b.mismatches,
            b.gap_extensions,
            b.opening_gaps,
        )
