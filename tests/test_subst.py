"""Substitution-scoring extensions: kimura transitions + full matrices.

A capability beyond the reference's two-score model
(``/root/reference/src/config.rs:6-18``); cross-checked oracle vs
oracle vs the batched/tiled/sharded fills, plus the classic path's
invariance.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.gotoh_numpy import gotoh_tables_numpy
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.ops.subst import (
    KIMURA_ENC,
    SubstMatrix,
    blosum62,
    dna_matrix,
    get_matrix,
    kimura_active,
    load_matrix_file,
    sub_score_np,
)
from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence

KIM = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5, s_transition=-1)
CLASSIC = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


import functools

import jax


@functools.partial(jax.jit, static_argnames=("is_local",))
def _fill_traced(s1, s2, m, n, scores, is_local, subst_lut=None):
    """One compiled scan per (shape, mode, scoring structure): scores
    and lengths ride as traced args, so the fuzz grids below do NOT
    compile a fresh XLA program per random score set. (Besides being
    faster, this sidesteps an XLA-CPU compiler segfault this suite
    hit when the whole run's distinct-compile count crossed a
    threshold — hundreds of constant-baked scan variants.)"""
    return gotoh_fill_scan(
        s1, s2, m, n, scores, is_local, emit_dirs=False,
        subst_lut=subst_lut,
    )


def _scan_score(a: str, b: str, scores, is_local, subst_lut=None) -> int:
    # Fixed pad buckets: every call shares one compiled scan per
    # (mode, scoring-structure) instead of one per length pair.
    pad = max(64, len(a) + 2, len(b) + 3)
    s1 = Sequence(name="a", sequence=a).encoded(pad_to=pad)
    s2 = Sequence(name="b", sequence=b).encoded(
        pad_to=pad, pad_value=PAD_S2
    )
    res = _fill_traced(
        jnp.asarray(s1),
        jnp.asarray(s2),
        len(a),
        len(b),
        scores,
        is_local,
        subst_lut=None if subst_lut is None else jnp.asarray(subst_lut),
    )
    return int(res.score)


def _numpy_score(a: str, b: str, scores, is_local, matrix=None) -> int:
    I, S, D = gotoh_tables_numpy(a, b, scores, is_local, matrix=matrix)
    if is_local:
        return int(max(0, I.max(), S.max(), D.max()))
    return int(max(I[-1, -1], S[-1, -1], D[-1, -1]))


class TestKimuraEncoding:
    def test_acgt_codes(self):
        assert [KIMURA_ENC[ord(c)] for c in "AGCT"] == [0, 2, 1, 3]

    def test_injective(self):
        assert len(set(KIMURA_ENC.tolist())) == 256

    def test_transitions_only_for_acgt(self):
        # x ^ y == 2 exactly for the same-case transition pairs
        # (soft-masked lowercase has its own class codes; cross-case
        # pairs stay transversions — they are non-matches).
        enc = KIMURA_ENC
        pairs = {
            (i, j)
            for i in range(256)
            for j in range(256)
            if (int(enc[i]) ^ int(enc[j])) == 2
        }
        expected = {
            (ord(a), ord(b))
            for a, b in [
                ("A", "G"), ("G", "A"), ("C", "T"), ("T", "C"),
                ("a", "g"), ("g", "a"), ("c", "t"), ("t", "c"),
            ]
        }
        assert pairs == expected

    def test_lowercase_classes(self):
        st_scores = Scores(1, -2, -1, -50, s_transition=-1)
        # Same-case lowercase transition scores st; cross-case is a
        # mismatch (transversion); lowercase self is a match.
        assert _scan_score("ag", "ga", st_scores, False) == -2
        assert _scan_score("a", "A", st_scores, False) == -2
        assert _scan_score("a", "a", st_scores, False) == 1

    def test_pad_bytes_stay_distinct(self):
        assert KIMURA_ENC[PAD_S1] != KIMURA_ENC[PAD_S2]
        assert (int(KIMURA_ENC[PAD_S1]) ^ int(KIMURA_ENC[PAD_S2])) != 2

    def test_sub_score_np(self):
        got = sub_score_np(
            np.frombuffer(b"AAAA", dtype=np.uint8),
            np.frombuffer(b"AGCN", dtype=np.uint8),
            5,
            -4,
            -1,
        )
        assert got.tolist() == [5, -1, -4, -4]


class TestKimuraOracles:
    def test_single_char_transition(self):
        # A vs G global: one substitution at transition cost.
        assert _scan_score("A", "G", KIM, False) == -1
        assert _numpy_score("A", "G", KIM, False) == -1

    def test_single_char_transversion(self):
        assert _scan_score("A", "C", KIM, False) == -2
        assert _numpy_score("A", "C", KIM, False) == -2

    def test_classic_unchanged_when_st_equals_sx(self):
        st_eq = Scores(1, -2, -1, -5, s_transition=-2)
        rng = np.random.default_rng(7)
        for _ in range(5):
            a = "".join(rng.choice(list("ACGT"), size=30))
            b = "".join(rng.choice(list("ACGT"), size=25))
            for loc in (False, True):
                assert _scan_score(a, b, st_eq, loc) == _scan_score(
                    a, b, CLASSIC, loc
                )

    @pytest.mark.parametrize("is_local", [False, True])
    def test_scan_vs_numpy_fuzz(self, is_local):
        rng = np.random.default_rng(11)
        for _ in range(8):
            a = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(5, 40))))
            b = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(5, 40))))
            s = Scores(
                int(rng.integers(1, 4)),
                int(rng.integers(-5, -1)),
                int(rng.integers(-3, 0)),
                int(rng.integers(-7, -1)),
                s_transition=int(rng.integers(-4, 0)),
            )
            assert _scan_score(a, b, s, is_local) == _numpy_score(
                a, b, s, is_local
            )

    def test_transition_rich_pair_beats_classic(self):
        # Gap-unaffordable scoring forces the substitutions, so the
        # all-transition pair scores 2*st vs 2*sx — pins that st is
        # actually applied (not just plumbed).
        kim = Scores(1, -2, -1, -50, s_transition=-1)
        classic = Scores(1, -2, -1, -50)
        a, b = "AG", "GA"
        assert _scan_score(a, b, kim, False) == -2
        assert _scan_score(a, b, classic, False) == -4


class TestKimuraKernels:
    """The surviving fills (vmapped batch, tiles, packed walks) vs the
    per-pair scan oracle, kimura."""

    def _batch(self, rng, B, lo, hi, Lm, Ln):
        ms = rng.integers(lo, hi + 1, B).astype(np.int32)
        ns = rng.integers(lo, hi + 1, B).astype(np.int32)
        s1b = np.stack(
            [
                Sequence("a", "".join(rng.choice(list("ACGTN"), m))).encoded(
                    pad_to=Lm
                )
                for m in ms
            ]
        )
        s2b = np.stack(
            [
                Sequence("b", "".join(rng.choice(list("ACGTN"), n))).encoded(
                    pad_to=Ln, pad_value=PAD_S2
                )
                for n in ns
            ]
        )
        return s1b, s2b, ms, ns

    def _oracle(self, s1b, s2b, ms, ns, scores, is_local):
        out = []
        for i in range(len(ms)):
            res = _fill_traced(
                jnp.asarray(s1b[i]),
                jnp.asarray(s2b[i]),
                np.int32(ms[i]),
                np.int32(ns[i]),
                scores,
                is_local,
            )
            out.append((int(res.score), int(res.start_i), int(res.start_j)))
        return out

    @pytest.mark.parametrize("is_local", [False, True])
    def test_flat_batch_kernel(self, is_local):
        # The vmapped batch (score_pairs) vs per-pair fills.
        from genomics_rs_tpu.parallel.batch import score_pairs

        rng = np.random.default_rng(21)
        s1b, s2b, ms, ns = self._batch(rng, 4, 20, 60, 64, 64)
        sc, si, sj = score_pairs(s1b, s2b, ms, ns, KIM, is_local)
        want = self._oracle(s1b, s2b, ms, ns, KIM, is_local)
        got = list(
            zip(
                np.asarray(sc).tolist(),
                np.asarray(si).tolist(),
                np.asarray(sj).tolist(),
            )
        )
        assert got == want

    @pytest.mark.parametrize("is_local", [False, True])
    def test_single_pair_fill_dirs_and_path(self, is_local):
        # The packed form of the scan's dirs, chased on device by
        # walk_block, must give the host walker's path.
        from genomics_rs_tpu.ops.gotoh_scan import pack_dirs
        from genomics_rs_tpu.ops.traceback import (
            classify_moves,
            traceback_host,
        )
        from genomics_rs_tpu.ops.traceback_device import device_walk

        rng = np.random.default_rng(23)
        a = "".join(rng.choice(list("ACGT"), 40))
        b = "".join(rng.choice(list("ACGT"), 37))
        sq1, sq2 = Sequence("a", a), Sequence("b", b)
        s1 = sq1.encoded(pad_to=48)
        s2 = sq2.encoded(pad_to=48, pad_value=PAD_S2)
        ref = gotoh_fill_scan(
            jnp.asarray(s1), jnp.asarray(s2), 40, 37, KIM, is_local
        )
        want = traceback_host(
            np.asarray(ref.dirs),
            int(ref.start_i),
            int(ref.start_j),
            int(ref.score),
            sq1,
            sq2,
            is_local,
        )
        codes, i_f, j_f, done = device_walk(
            pack_dirs(ref.dirs),
            int(ref.start_i),
            int(ref.start_j),
            0,
            max_steps=32,  # forces several resumes
        )
        assert bool(done)
        got = classify_moves(
            codes, int(ref.start_i), int(ref.start_j), int(ref.score),
            sq1, sq2,
        )
        assert got.alignment == want.alignment
        assert got.score == want.score

    @pytest.mark.parametrize("is_local", [False, True])
    def test_blocked_kernel_kimura(self, is_local):
        # Two stacked row tiles (the longseq pipeline's unit) carry the
        # fill exactly: the second tile's (m, n) probe / argmax equal
        # the one-shot scan's.
        from genomics_rs_tpu.ops.gotoh_tile import (
            global_boundary_left,
            global_boundary_top,
            tile_fill,
        )

        rng = np.random.default_rng(24)
        a = "".join(rng.choice(list("ACGT"), 32))
        b = "".join(rng.choice(list("ACGT"), 29))
        s1 = jnp.asarray(Sequence("a", a).encoded())
        s2 = jnp.asarray(Sequence("b", b).encoded())
        R = 16
        top = global_boundary_top(0, len(b), KIM)
        best = None
        for i0 in (0, R):
            res = tile_fill(
                s1[i0 : i0 + R],
                s2,
                top,
                global_boundary_left(i0, R, KIM),
                KIM,
                is_local,
                i0,
                0,
                len(a),
                len(b),
            )
            top = res.bottom
            cand = tuple(int(x) for x in res.best)
            best = cand if best is None or cand > best else best
        want = self._oracle(
            np.asarray(s1)[None], np.asarray(s2)[None],
            [len(a)], [len(b)], KIM, is_local,
        )[0]
        if is_local:
            assert best == want
        else:
            assert int(res.at_mn) == want[0]


class TestKimuraKernelsWide:
    """Remaining surfaces vs the scan oracle with kimura scoring."""

    def _mk(self, rng, B, lo, hi, Lm, Ln):
        return TestKimuraKernels._batch(None, rng, B, lo, hi, Lm, Ln)

    def _want(self, s1b, s2b, ms, ns, is_local):
        return TestKimuraKernels._oracle(
            None, s1b, s2b, ms, ns, KIM, is_local
        )

    @pytest.mark.parametrize("is_local", [False, True])
    @pytest.mark.parametrize(
        "B,lo,hi,Lm,Ln",
        [(5, 20, 60, 64, 64), (6, 1, 30, 32, 32), (3, 40, 96, 128, 96)],
        ids=["mid", "short-edges", "rect"],
    )
    def test_batch_shapes(self, is_local, B, lo, hi, Lm, Ln):
        # Mixed true lengths inside one padded batch, down to 1 base.
        from genomics_rs_tpu.parallel.batch import score_pairs

        rng = np.random.default_rng(31 + B + lo)
        s1b, s2b, ms, ns = self._mk(rng, B, lo, hi, Lm, Ln)
        sc, si, sj = score_pairs(s1b, s2b, ms, ns, KIM, is_local)
        got = list(
            zip(
                np.asarray(sc).tolist(),
                np.asarray(si).tolist(),
                np.asarray(sj).tolist(),
            )
        )
        assert got == self._want(s1b, s2b, ms, ns, is_local)

    def test_tile_fill(self):
        from genomics_rs_tpu.ops.gotoh_tile import (
            global_boundary_left,
            global_boundary_top,
            tile_fill,
        )

        rng = np.random.default_rng(34)
        a = "".join(rng.choice(list("ACGT"), 30))
        b = "".join(rng.choice(list("ACGT"), 28))
        s1 = Sequence("a", a).encoded()
        s2 = Sequence("b", b).encoded()
        res = tile_fill(
            jnp.asarray(s1),
            jnp.asarray(s2),
            global_boundary_top(0, len(b), KIM),
            global_boundary_left(0, len(a), KIM),
            KIM,
            False,
            0,
            0,
            len(a),
            len(b),
        )
        assert int(res.at_mn) == _scan_score(a, b, KIM, False)

    @pytest.mark.parametrize("is_local", [False, True])
    def test_tile_dirs_equal_scan_dirs(self, is_local):
        # A whole-table tile with emit_dirs=True emits exactly the
        # packed form of the scan's direction table.
        from genomics_rs_tpu.ops.gotoh_scan import pack_dirs
        from genomics_rs_tpu.ops.gotoh_tile import (
            global_boundary_left,
            global_boundary_top,
            tile_fill,
        )

        rng = np.random.default_rng(37)
        a = "".join(rng.choice(list("ACGT"), 24))
        b = "".join(rng.choice(list("ACGT"), 20))
        s1 = jnp.asarray(Sequence("a", a).encoded())
        s2 = jnp.asarray(Sequence("b", b).encoded())
        tile = tile_fill(
            s1, s2,
            global_boundary_top(0, len(b), KIM),
            global_boundary_left(0, len(a), KIM),
            KIM, is_local, 0, 0, len(a), len(b),
            emit_dirs=True,
        )
        full = gotoh_fill_scan(s1, s2, len(a), len(b), KIM, is_local)
        assert np.array_equal(
            np.asarray(tile.dirs), np.asarray(pack_dirs(full.dirs))
        )

    def test_aligner_end_to_end_kimura(self):
        # Public aligner API: scores equal the numpy tables' and the
        # path's global stats account for every base.
        from genomics_rs_tpu.models.aligner import PairwiseAligner

        rng = np.random.default_rng(36)
        a = "".join(rng.choice(list("ACGT"), 120))
        b = "".join(rng.choice(list("ACGT"), 110))
        for is_local in (False, True):
            got = PairwiseAligner(KIM, is_local=is_local).align(
                Sequence("a", a), Sequence("b", b)
            )
            assert got.score == _numpy_score(a, b, KIM, is_local)
            if not is_local:
                assert got.matches + got.mismatches + (
                    got.opening_gaps + got.gap_extensions
                ) == len(got.alignment)


class TestSubstMatrix:
    def test_blosum62_shape_and_symmetry(self):
        m = blosum62()
        assert m.matrix.shape == (24, 24)
        assert np.array_equal(m.matrix, m.matrix.T)
        al = m.alphabet
        assert m.matrix[al.index("W"), al.index("W")] == 11

    def test_byte_lut_unknown_maps_to_X(self):
        m = blosum62()
        lut = m.byte_lut()
        al = m.alphabet
        xa = m.matrix[al.index("X"), al.index("A")]
        assert lut[ord("J"), ord("A")] == xa  # J not in the alphabet
        assert lut[ord("A"), ord("A")] == 4

    def test_byte_lut_no_wildcard_uses_min(self):
        m = SubstMatrix("AB", np.array([[2, -1], [-1, 3]], dtype=np.int32))
        lut = m.byte_lut()
        assert lut[ord("Z"), ord("A")] == -1
        assert lut[ord("A"), ord("B")] == -1
        assert lut[ord("B"), ord("B")] == 3

    def test_dna_matrix_equals_kimura(self):
        lut = dna_matrix(KIM).byte_lut()
        rng = np.random.default_rng(3)
        for _ in range(4):
            a = "".join(rng.choice(list("ACGT"), size=20))
            b = "".join(rng.choice(list("ACGT"), size=24))
            for loc in (False, True):
                via_matrix = _scan_score(
                    a, b, CLASSIC, loc, subst_lut=lut
                )
                via_kimura = _scan_score(a, b, KIM, loc)
                assert via_matrix == via_kimura

    def test_matrix_numpy_vs_scan(self):
        m = blosum62()
        lut = m.byte_lut()
        rng = np.random.default_rng(5)
        aa = list("ARNDCQEGHILKMFPSTWYV")
        for _ in range(4):
            a = "".join(rng.choice(aa, size=int(rng.integers(8, 30))))
            b = "".join(rng.choice(aa, size=int(rng.integers(8, 30))))
            for loc in (False, True):
                assert _scan_score(
                    a, b, CLASSIC, loc, subst_lut=lut
                ) == _numpy_score(a, b, CLASSIC, loc, matrix=m)

    def test_known_blosum_global(self):
        # Hand-derivable: identical peptides score the sum of their
        # diagonal entries.
        pep = "WHW"
        m = blosum62()
        expect = 11 + 8 + 11
        assert _scan_score(pep, pep, CLASSIC, False, subst_lut=m.byte_lut()) == expect

    def test_lut_exclusive_with_transition(self):
        with pytest.raises(ValueError, match="mutually exclusive"):
            _scan_score("A", "A", KIM, False, subst_lut=blosum62().byte_lut())


class TestKimuraModels:
    """Batched and sharded alignment surfaces under kimura."""

    def test_align_batch_parity(self):
        from genomics_rs_tpu.models.aligner import (
            PairwiseAligner,
            align_batch,
        )

        rng = np.random.default_rng(51)
        pairs = [
            (
                Sequence("a%d" % i, "".join(rng.choice(list("ACGT"), 90))),
                Sequence("b%d" % i, "".join(rng.choice(list("ACGT"), 85))),
            )
            for i in range(3)
        ]
        for is_local in (False, True):
            got = align_batch(pairs, KIM, is_local=is_local)
            ref = PairwiseAligner(KIM, is_local=is_local, engine="scan")
            for (s1, s2), aln in zip(pairs, got):
                want = ref.align(s1, s2)
                assert aln.score == want.score
                assert aln.alignment == want.alignment

    def test_checkpointed_parity(self):
        # The sharded aligner's windowed refills (packed tile dirs +
        # device walks) under kimura, on a 4-device CPU mesh.
        from genomics_rs_tpu.models.aligner import PairwiseAligner
        from genomics_rs_tpu.parallel.longseq import align_sharded
        from genomics_rs_tpu.parallel.mesh import SEQ_AXIS, make_mesh

        rng = np.random.default_rng(52)
        a = Sequence("a", "".join(rng.choice(list("ACGT"), 300)))
        b = Sequence("b", "".join(rng.choice(list("ACGT"), 280)))
        mesh = make_mesh(4, axis_name=SEQ_AXIS)
        for is_local in (False, True):
            got = align_sharded(mesh, a, b, KIM, is_local=is_local)
            want = PairwiseAligner(KIM, is_local=is_local).align(a, b)
            assert got.score == want.score
            assert got.alignment == want.alignment


class TestKimuraParallel:
    """Kimura through the shard_map / mesh plumbing (8-dev CPU)."""

    def test_batch_scores_sharded(self):
        from genomics_rs_tpu.parallel.batch import batch_scores_sharded
        from genomics_rs_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(71)
        B, L = 8, 48
        ms = np.full(B, L, np.int32)
        seqs = [
            ("".join(rng.choice(list("ACGT"), L)),
             "".join(rng.choice(list("ACGT"), L)))
            for _ in range(B)
        ]
        s1b = np.stack(
            [Sequence("a", a).encoded(pad_to=64) for a, _ in seqs]
        )
        s2b = np.stack(
            [
                Sequence("b", b).encoded(pad_to=64, pad_value=PAD_S2)
                for _, b in seqs
            ]
        )
        mesh = make_mesh()
        for is_local in (False, True):
            out = batch_scores_sharded(
                mesh, s1b, s2b, ms, ms, KIM, is_local
            )
            for i, (a, b) in enumerate(seqs):
                assert int(out.score[i]) == _scan_score(
                    a, b, KIM, is_local
                ), i

    def test_msa_kimura(self):
        # The MSA pipeline plumbs Scores through batched fills and the
        # star stage; each row's projection must reproduce its
        # pairwise kimura alignment score.
        from genomics_rs_tpu.models.aligner import PairwiseAligner
        from genomics_rs_tpu.models.msa import center_star_msa

        rng = np.random.default_rng(73)
        seqs = [
            Sequence(f"s{i}", "".join(rng.choice(list("ACGT"), 60)))
            for i in range(3)
        ]
        from genomics_rs_tpu.sequence import SequenceContainer

        res = center_star_msa(
            SequenceContainer(sequences=list(seqs)), KIM
        )
        assert len(res.rows) == 3
        assert all(len(r) == res.width for r in res.rows)
        # Gap removal recovers inputs; the score matrix is the kimura
        # pairwise global score for every pair.
        for row, s in zip(res.rows, seqs):
            assert row.replace("-", "") == s.sequence
        ref = PairwiseAligner(KIM, engine="scan")
        for j in range(3):
            for i in range(j + 1):
                want = ref.score_only(seqs[i], seqs[j])
                assert res.score_matrix[j, i] == want, (i, j)

    def test_allpairs_scores_kimura(self):
        from genomics_rs_tpu.parallel.allpairs import allpairs_scores
        from genomics_rs_tpu.sequence import SequenceContainer

        rng = np.random.default_rng(72)
        seqs = [
            Sequence(f"s{i}", "".join(rng.choice(list("ACGT"), 40)))
            for i in range(4)
        ]
        res = allpairs_scores(
            SequenceContainer(sequences=list(seqs)), KIM, engine="scan"
        )
        for j in range(4):
            for i in range(j + 1):
                want = _scan_score(
                    seqs[i].sequence, seqs[j].sequence, KIM, False
                )
                assert res.matrix[j, i] == want, (i, j)


class TestMatrixEngine:
    """Matmul + sheared-subs wavefront batch engine vs the scan oracle."""

    @pytest.mark.parametrize("is_local", [False, True])
    def test_blosum_batch_vs_scan(self, is_local):
        from genomics_rs_tpu.ops.gotoh_matrix import gotoh_scores_matrix

        m = blosum62()
        lut = jnp.asarray(m.byte_lut())
        rng = np.random.default_rng(61)
        aa = list("ARNDCQEGHILKMFPSTWYV")
        B, Lm, Ln = 4, 48, 40
        ms = rng.integers(20, Lm + 1, B).astype(np.int32)
        ns = rng.integers(15, Ln + 1, B).astype(np.int32)
        seqs1 = ["".join(rng.choice(aa, k)) for k in ms]
        seqs2 = ["".join(rng.choice(aa, k)) for k in ns]
        s1b = np.stack(
            [Sequence("a", s).encoded(pad_to=Lm) for s in seqs1]
        )
        s2b = np.stack(
            [
                Sequence("b", s).encoded(pad_to=Ln, pad_value=PAD_S2)
                for s in seqs2
            ]
        )
        sc, si, sj = gotoh_scores_matrix(
            s1b,
            s2b,
            ms,
            ns,
            m,
            g=-1,
            h=-5,
            is_local=is_local,
        )
        for i in range(B):
            res = _fill_traced(
                jnp.asarray(s1b[i]),
                jnp.asarray(s2b[i]),
                np.int32(ms[i]),
                np.int32(ns[i]),
                CLASSIC,
                is_local,
                subst_lut=lut,
            )
            assert int(sc[i]) == int(res.score), i
            if is_local:
                assert int(si[i]) == int(res.start_i), i
                assert int(sj[i]) == int(res.start_j), i

    @pytest.mark.parametrize("is_local", [False, True])
    def test_mixed_lengths_vs_lut_scan(self, is_local):
        # Mixed true lengths (down to 3) and wildcard letters in one
        # batch vs the per-pair LUT-gather scan.
        from genomics_rs_tpu.ops.gotoh_matrix import gotoh_scores_matrix

        m = blosum62()
        lut = jnp.asarray(m.byte_lut())
        rng = np.random.default_rng(63)
        aa = list("ARNDCQEGHILKMFPSTWYVBZX")
        B, Lm, Ln = 5, 40, 56
        ms = rng.integers(3, Lm + 1, B).astype(np.int32)
        ns = rng.integers(3, Ln + 1, B).astype(np.int32)
        s1b = np.stack(
            [
                Sequence("a", "".join(rng.choice(aa, k))).encoded(
                    pad_to=Lm
                )
                for k in ms
            ]
        )
        s2b = np.stack(
            [
                Sequence(
                    "b", "".join(rng.choice(aa, k))
                ).encoded(pad_to=Ln, pad_value=PAD_S2)
                for k in ns
            ]
        )
        sc, si, sj = gotoh_scores_matrix(
            s1b, s2b, ms, ns, m, g=-2, h=-7, is_local=is_local
        )
        gaps = Scores(0, 0, -2, -7)
        for i in range(B):
            res = _fill_traced(
                jnp.asarray(s1b[i]),
                jnp.asarray(s2b[i]),
                np.int32(ms[i]),
                np.int32(ns[i]),
                gaps,
                is_local,
                subst_lut=lut,
            )
            got = (int(sc[i]), int(si[i]), int(sj[i]))
            assert got == (
                int(res.score), int(res.start_i), int(res.start_j)
            ), i

    @pytest.mark.parametrize("name", ["BLOSUM62", "dna-kimura"])
    def test_subst_planes_equal_lut_gather(self, name):
        # The bf16 one-hot matmul planes (float32 accumulation) hold
        # exactly the byte-LUT entries: each output has one nonzero
        # product of small integers.
        from genomics_rs_tpu.ops.gotoh_matrix import (
            _alpha_code,
            _ext_matrix,
            _sheared_subs,
        )

        m = blosum62() if name == "BLOSUM62" else dna_matrix(KIM)
        rng = np.random.default_rng(64)
        letters = list(m.alphabet) + ["J", "a"]
        B, Lm, Ln = 2, 24, 20
        s1b = np.stack(
            [
                np.frombuffer(
                    "".join(rng.choice(letters, Lm)).encode(), np.uint8
                )
                for _ in range(B)
            ]
        )
        s2b = np.stack(
            [
                np.frombuffer(
                    "".join(rng.choice(letters, Ln)).encode(), np.uint8
                )
                for _ in range(B)
            ]
        )
        ext = _ext_matrix(m)
        sheared = np.asarray(
            _sheared_subs(
                jnp.asarray(s1b),
                jnp.asarray(s2b),
                jnp.asarray(_alpha_code(m)),
                jnp.asarray(ext),
                int(ext.shape[0]),
            )
        )
        lut = m.byte_lut()
        for b in range(B):
            for i in range(1, Lm + 1):
                for j in range(1, Ln + 1):
                    assert sheared[i + j, b, i] == lut[
                        s1b[b, i - 1], s2b[b, j - 1]
                    ], (b, i, j)

    def test_unknown_bytes_match_byte_lut(self):
        # Bytes outside the alphabet (here 'J' and '*'-less alphabet
        # handling) must score exactly like SubstMatrix.byte_lut.
        from genomics_rs_tpu.ops.gotoh_matrix import gotoh_scores_matrix

        m = blosum62()
        lut = jnp.asarray(m.byte_lut())
        a, b = "WJHW", "WHJW"
        s1 = Sequence("a", a).encoded(pad_to=8)
        s2 = Sequence("b", b).encoded(pad_to=8, pad_value=PAD_S2)
        sc, _, _ = gotoh_scores_matrix(
            s1[None], s2[None], [4], [4], m, g=-1, h=-5
        )
        res = _fill_traced(
            jnp.asarray(s1),
            jnp.asarray(s2),
            np.int32(4),
            np.int32(4),
            CLASSIC,
            False,
            subst_lut=lut,
        )
        assert int(sc[0]) == int(res.score)

    def test_dna_matrix_matches_kimura_kernelwise(self):
        from genomics_rs_tpu.ops.gotoh_matrix import gotoh_scores_matrix

        rng = np.random.default_rng(62)
        B, L = 3, 32
        ms = np.full(B, L, np.int32)
        seqs = [
            ("".join(rng.choice(list("ACGT"), L)),
             "".join(rng.choice(list("ACGT"), L)))
            for _ in range(B)
        ]
        s1b = np.stack(
            [Sequence("a", a).encoded(pad_to=L) for a, _ in seqs]
        )
        s2b = np.stack(
            [
                Sequence("b", b).encoded(pad_to=L, pad_value=PAD_S2)
                for _, b in seqs
            ]
        )
        sc, _, _ = gotoh_scores_matrix(
            s1b, s2b, ms, ms, dna_matrix(KIM), g=KIM.g, h=KIM.h
        )
        for i, (a, b) in enumerate(seqs):
            assert int(sc[i]) == _scan_score(a, b, KIM, False), i


class TestProteinMSA:
    def test_center_star_blosum(self):
        from genomics_rs_tpu.models.aligner import PairwiseAligner
        from genomics_rs_tpu.models.msa import center_star_msa
        from genomics_rs_tpu.sequence import SequenceContainer

        m = blosum62()
        rng = np.random.default_rng(81)
        aa = list("ARNDCQEGHILKMFPSTWYV")
        base = rng.choice(aa, 50)
        seqs = []
        for i in range(3):
            mut = base.copy()
            for _ in range(5):
                mut[rng.integers(0, 50)] = rng.choice(aa)
            seqs.append(Sequence(f"p{i}", "".join(mut)))
        res = center_star_msa(
            SequenceContainer(sequences=list(seqs)),
            CLASSIC,
            matrix=m,
        )
        assert len(res.rows) == 3
        for row, s in zip(res.rows, seqs):
            assert row.replace("-", "") == s.sequence
        # Score matrix entries == matrix-mode pairwise scores.
        ref = PairwiseAligner(CLASSIC, matrix=m)
        for j in range(3):
            for i in range(j + 1):
                assert res.score_matrix[j, i] == ref.score_only(
                    seqs[i], seqs[j]
                ), (i, j)


class TestCppOracle:
    def _lib_or_skip(self):
        from genomics_rs_tpu.suffixtree import native

        if native._load_library() is None:
            pytest.skip("native library not built")
        return native

    @pytest.mark.parametrize("is_local", [False, True])
    def test_cpp_lut_vs_scan_kimura(self, is_local):
        from genomics_rs_tpu.ops.subst import kimura_byte_lut

        native = self._lib_or_skip()
        rng = np.random.default_rng(41)
        lut = kimura_byte_lut(KIM)
        for _ in range(4):
            a = "".join(rng.choice(list("ACGTN"), 50))
            b = "".join(rng.choice(list("ACGTN"), 45))
            got = native.gotoh_score_cpu_subst(
                a.encode(), b.encode(), lut, KIM.g, KIM.h, is_local
            )
            want = _scan_score(a, b, KIM, is_local)
            assert got[0] == want

    @pytest.mark.parametrize("is_local", [False, True])
    def test_cpp_lut_vs_scan_blosum(self, is_local):
        native = self._lib_or_skip()
        m = blosum62()
        lut = m.byte_lut()
        rng = np.random.default_rng(42)
        aa = list("ARNDCQEGHILKMFPSTWYV")
        for _ in range(4):
            a = "".join(rng.choice(aa, 40))
            b = "".join(rng.choice(aa, 35))
            got = native.gotoh_score_cpu_subst(
                a.encode(), b.encode(), lut, CLASSIC.g, CLASSIC.h, is_local
            )
            want = _scan_score(
                a, b, CLASSIC, is_local, subst_lut=lut
            )
            assert got[0] == want

    def test_cpp_lut_matches_classic_oracle(self):
        # A classic-equivalent LUT reproduces gotoh_score_cpu exactly.
        native = self._lib_or_skip()
        from genomics_rs_tpu.ops.subst import sub_score_np

        b = np.arange(256, dtype=np.uint8)
        lut = sub_score_np(b[:, None], b[None, :], 1, -2).astype(np.int32)
        rng = np.random.default_rng(43)
        for _ in range(3):
            a = "".join(rng.choice(list("ACGT"), 60))
            c = "".join(rng.choice(list("ACGT"), 55))
            for loc in (False, True):
                assert native.gotoh_score_cpu_subst(
                    a.encode(), c.encode(), lut, -1, -5, loc
                ) == native.gotoh_score_cpu(
                    a.encode(), c.encode(), 1, -2, -1, -5, loc
                )


class TestMatrixIO:
    def test_ncbi_round_trip(self, tmp_path):
        m = blosum62()
        p = tmp_path / "b62.mat"
        lines = ["# test matrix", "   " + "  ".join(m.alphabet)]
        for i, ch in enumerate(m.alphabet):
            lines.append(
                ch + " " + " ".join(str(v) for v in m.matrix[i])
            )
        p.write_text("\n".join(lines) + "\n")
        m2 = load_matrix_file(str(p))
        assert m2.alphabet == m.alphabet
        assert np.array_equal(m2.matrix, m.matrix)

    def test_get_matrix_builtin(self):
        assert get_matrix("blosum62").name == "BLOSUM62"

    def test_bad_header(self, tmp_path):
        p = tmp_path / "bad.mat"
        p.write_text("AB CD\nA 1 2\n")
        with pytest.raises(ValueError):
            load_matrix_file(str(p))

    def test_row_mismatch(self, tmp_path):
        p = tmp_path / "bad2.mat"
        p.write_text("A B\nA 1 2\nC 3 4\n")
        with pytest.raises(ValueError):
            load_matrix_file(str(p))


class TestCli:
    """CLI surface: --matrix and the s_transition config key."""

    def _run(self, args, cwd, config):
        import os
        import subprocess
        import sys

        from conftest import REPO_ROOT

        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            PYTHONPATH=REPO_ROOT
            + os.pathsep
            + os.environ.get("PYTHONPATH", ""),
        )
        return subprocess.run(
            [
                sys.executable,
                "-m",
                "genomics_rs_tpu.cli",
                "-c",
                str(config),
                *args,
            ],
            capture_output=True,
            text=True,
            timeout=240,
            cwd=str(cwd),
            env=env,
        )

    @pytest.fixture
    def classic_toml(self, tmp_path):
        p = tmp_path / "c.toml"
        p.write_text(
            "[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n"
        )
        return p

    @pytest.fixture
    def kimura_toml(self, tmp_path):
        p = tmp_path / "k.toml"
        p.write_text(
            "[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n"
            "s_transition = -1\n"
        )
        return p

    def test_align_kimura_config(self, tmp_path, kimura_toml, classic_toml):
        fa = tmp_path / "pair.fasta"
        fa.write_text(">a\nACGT\n>b\nACAT\n")  # G vs A = transition
        r = self._run(
            ["align", "-a", "global", "-f", str(fa), "--engine", "scan"],
            tmp_path,
            kimura_toml,
        )
        assert r.returncode == 0, r.stderr
        assert "Alignment Score: 2" in r.stdout
        r2 = self._run(
            ["align", "-a", "global", "-f", str(fa), "--engine", "scan"],
            tmp_path,
            classic_toml,
        )
        assert "Alignment Score: 1" in r2.stdout

    def test_align_matrix_blosum(self, tmp_path, classic_toml):
        fa = tmp_path / "pep.fasta"
        fa.write_text(">a\nWHW\n>b\nWHW\n")
        r = self._run(
            [
                "align",
                "-a",
                "global",
                "-f",
                str(fa),
                "--matrix",
                "BLOSUM62",
            ],
            tmp_path,
            classic_toml,
        )
        assert r.returncode == 0, r.stderr
        assert "Alignment Score: 30" in r.stdout  # 11 + 8 + 11

    def test_align_matrix_blosum_dir(self, tmp_path, classic_toml):
        d = tmp_path / "prots"
        d.mkdir()
        (d / "a.fasta").write_text(">p1\nWHWHW\n")
        (d / "b.fasta").write_text(">p2\nWHWHW\n")
        r = self._run(
            [
                "align-matrix",
                "-f",
                str(d),
                "--matrix",
                "BLOSUM62",
                "-o",
                str(tmp_path / "out.tsv"),
            ],
            tmp_path,
            classic_toml,
        )
        assert r.returncode == 0, r.stderr
        # Self-pair: 3*11 + 2*8 = 49 on the diagonal of the TSV.
        assert "49" in r.stdout

    def test_msa_matrix_blosum(self, tmp_path, classic_toml):
        fa = tmp_path / "peps.fasta"
        fa.write_text(">p1\nWHWHWKL\n>p2\nWHWHWKL\n>p3\nWHAHWKL\n")
        r = self._run(
            ["msa", "-f", str(fa), "--matrix", "BLOSUM62"],
            tmp_path,
            classic_toml,
        )
        assert r.returncode == 0, r.stderr
        assert "WHWHWKL" in r.stdout  # identical rows, no gaps needed
        assert "Substitution matrix: BLOSUM62" in (r.stdout + r.stderr)

    def test_matrix_align_writes_fasta(self, tmp_path, classic_toml):
        # align --output writes the gapped pair; removing the gaps
        # gives back the inputs.
        fa = tmp_path / "pair.fasta"
        fa.write_text(">a\nWHWHWKL\n>b\nWHWKL\n")
        out = tmp_path / "aln.fasta"
        r = self._run(
            [
                "align",
                "-a",
                "global",
                "-f",
                str(fa),
                "--matrix",
                "BLOSUM62",
                "-o",
                str(out),
            ],
            tmp_path,
            classic_toml,
        )
        assert r.returncode == 0, r.stderr
        recs = out.read_text().split(">")[1:]
        rows = ["".join(rec.splitlines()[1:]) for rec in recs]
        assert [row.replace("-", "") for row in rows] == [
            "WHWHWKL",
            "WHWKL",
        ]
        assert len(rows[0]) == len(rows[1])


class TestConfig:
    def test_toml_transition_key(self, tmp_path):
        p = tmp_path / "c.toml"
        p.write_text(
            "[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n"
            "s_transition = -1\n"
        )
        from genomics_rs_tpu.config import get_config

        cfg = get_config(str(p))
        assert cfg.scores.s_transition == -1
        assert kimura_active(cfg.scores)

    def test_toml_without_transition(self, tmp_path):
        p = tmp_path / "c.toml"
        p.write_text("[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n")
        from genomics_rs_tpu.config import get_config

        assert get_config(str(p)).scores.s_transition is None

    def test_as_tuple_roundtrip(self):
        assert Scores(*KIM.as_tuple()) == KIM
        assert Scores(*CLASSIC.as_tuple()) == CLASSIC
        assert len(CLASSIC.as_tuple()) == 4
