"""Native C++ components vs the JAX/Python oracles.

The C++ Gotoh (bench baseline + large-scale oracle) must agree with
the lax.scan fill on scores and local retrace start cells; the C++
suffix tree is covered by the parametrized golden tests in
test_suffixtree.py.
"""

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, Sequence
from genomics_rs_tpu.suffixtree import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library not built"
)

SCORES = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)


@pytest.mark.parametrize("is_local", [False, True])
def test_gotoh_cpu_matches_scan(is_local):
    from genomics_rs_tpu.suffixtree.native import gotoh_score_cpu

    rng = np.random.default_rng(11)
    for trial in range(8):
        m = int(rng.integers(1, 120))
        n = int(rng.integers(1, 120))
        a = "".join(rng.choice(list("ACGT"), m))
        b = "".join(rng.choice(list("ACGT"), n))
        Lm = max(-(-m // 128) * 128, 128)
        Ln = max(-(-n // 128) * 128, 128)
        s1e = Sequence("a", a).encoded(pad_to=Lm, pad_value=PAD_S1)
        s2e = Sequence("b", b).encoded(pad_to=Ln, pad_value=PAD_S2)
        ref = gotoh_fill_scan(
            s1e, s2e, np.int32(m), np.int32(n), SCORES, is_local
        )
        score, bi, bj = gotoh_score_cpu(
            a.encode(),
            b.encode(),
            SCORES.s_match,
            SCORES.s_mismatch,
            SCORES.g,
            SCORES.h,
            is_local,
        )
        assert score == int(ref.score), (trial, a, b)
        assert bi == int(ref.start_i), (trial, a, b)
        assert bj == int(ref.start_j), (trial, a, b)


def test_native_tree_matches_python_compare():
    """Recursive-LCS similarity agrees between tree implementations."""
    import os

    from genomics_rs_tpu.comparison.driver import recursive_lcs_similarity

    from conftest import data_path

    alpha = data_path("alphabets", "dna.txt")
    rng = np.random.default_rng(2)
    a = "".join(rng.choice(list("ACGT"), 300))
    b = "".join(rng.choice(list("ACGT"), 250))

    native = recursive_lcs_similarity(a, b, alpha)
    os.environ["GENOMICS_TPU_NO_NATIVE"] = "1"
    try:
        import genomics_rs_tpu.suffixtree.native as nat

        saved = (nat._lib, nat._lib_failed)
        nat._lib, nat._lib_failed = None, True
        python = recursive_lcs_similarity(a, b, alpha)
        nat._lib, nat._lib_failed = saved
    finally:
        del os.environ["GENOMICS_TPU_NO_NATIVE"]
    assert native == python
