"""Real multi-process (2-rank) distributed all-pairs over Gloo/DCN.

Spawns two JAX processes with ``jax.distributed.initialize`` on
localhost CPU devices, each scoring its strided pair share, merged
with ``process_allgather`` — and asserts the replicated matrix equals
the single-process driver's.
"""

import os
import subprocess
import sys

import numpy as np

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.parallel.allpairs import allpairs_scores
from genomics_rs_tpu.sequence import Sequence, SequenceContainer

from conftest import REPO_ROOT

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:%PORT%"
os.environ["JAX_NUM_PROCESSES"] = "2"
os.environ["JAX_PROCESS_ID"] = sys.argv[1]
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
sys.path.insert(0, %ROOT%)
import numpy as np
from genomics_rs_tpu.sequence import Sequence, SequenceContainer
from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.parallel.distributed import (
    allpairs_multihost,
    init_distributed,
)

# Exercises the env-driven init (must run before any backend use).
assert init_distributed() == (pid, 2)

rng = np.random.default_rng(1)
c = SequenceContainer(
    sequences=[
        Sequence(f"s{k}", "".join(rng.choice(list("ACGT"), 60)))
        for k in range(5)
    ]
)
r = allpairs_multihost(c, Scores(1, -2, -1, -5), engine="scan")
np.save(f"%OUT%/matrix_{pid}.npy", r.matrix)
"""


def _container():
    rng = np.random.default_rng(1)
    return SequenceContainer(
        sequences=[
            Sequence(f"s{k}", "".join(rng.choice(list("ACGT"), 60)))
            for k in range(5)
        ]
    )


def test_two_process_allpairs(tmp_path):
    src = (
        WORKER.replace("%PORT%", "29517")
        .replace("%ROOT%", repr(REPO_ROOT))
        .replace("%OUT%", str(tmp_path))
    )
    script = tmp_path / "worker.py"
    script.write_text(src)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-2000:]

    m0 = np.load(tmp_path / "matrix_0.npy")
    m1 = np.load(tmp_path / "matrix_1.npy")
    want = allpairs_scores(_container(), Scores(1, -2, -1, -5), engine="scan")
    np.testing.assert_array_equal(m0, m1)
    np.testing.assert_array_equal(m0, want.matrix)


class TestHybridDeal:
    """hybrid_deal: oversized items split across host groups
    (round 5 — closes the indivisible-item bound at 8 hosts)."""

    def test_no_split_when_balanced(self):
        from genomics_rs_tpu.parallel.distributed import hybrid_deal

        costs = [100.0] * 8
        shares = hybrid_deal(costs, 4)
        assert all(len(s) == 2 for s in shares)
        assert all(u.nparts == 1 for s in shares for u in s)
        # every item dealt exactly once
        seen = sorted(u.index for s in shares for u in s)
        assert seen == list(range(8))

    def test_oversized_item_splits(self):
        from genomics_rs_tpu.parallel.distributed import (
            hybrid_deal,
            split_cost,
        )

        # one item is 50% of all work at 8 shares -> must split
        costs = [700.0] + [100.0] * 7
        shares = hybrid_deal(costs, 8)
        units = [u for s in shares for u in s if u.index == 0]
        assert len(units) >= 2
        groups = {u.group for u in units}
        assert len(groups) == 1 and len(units[0].group) == len(units)
        # the split improves the bottleneck vs whole-item LPT (whose
        # eff here is 700/(1400/8) = 0.25); the residual gap is the
        # 100-unit lumpiness, not the split.
        loads = [0.0] * 8
        for h, s in enumerate(shares):
            for u in s:
                loads[h] += (
                    split_cost(costs[u.index], u.nparts)
                    if u.nparts > 1
                    else costs[u.index]
                )
        total = sum(costs)
        eff = total / 8 / max(loads)
        assert eff >= 0.85, (eff, loads)

    def test_mixed_155kb_corpus_shape(self):
        # The round-4 verdict's done criterion: the 10 x 30 kb + 155 kb
        # corpus at 8 hosts must report bottleneck efficiency >= 0.90
        # (balanced_deal's indivisible-item bound there was 0.62).
        from genomics_rs_tpu.parallel.distributed import (
            hybrid_deal,
            split_cost,
        )

        lens = [29900] * 10 + [155462]
        pairs = [
            (i, j) for j in range(11) for i in range(11) if i <= j
        ]
        costs = [(lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs]
        for hosts in (2, 4, 8):
            shares = hybrid_deal(costs, hosts)
            loads = [
                sum(
                    split_cost(costs[u.index], u.nparts)
                    if u.nparts > 1
                    else costs[u.index]
                    for u in s
                )
                for s in shares
            ]
            eff = sum(costs) / hosts / max(loads)
            assert eff >= 0.90, (hosts, eff)

    def test_deterministic(self):
        from genomics_rs_tpu.parallel.distributed import hybrid_deal

        costs = [7.0, 3.0, 900.0, 11.0, 5.0, 5.0]
        assert hybrid_deal(costs, 4) == hybrid_deal(costs, 4)


class TestAllpairsHybrid:
    def test_matches_local_driver(self):
        """Scores identical to allpairs_scores; the oversized pair
        actually routes through the seq-parallel sub-mesh."""
        import numpy as np

        from genomics_rs_tpu.parallel.allpairs import allpairs_scores
        from genomics_rs_tpu.parallel.distributed import allpairs_hybrid
        from genomics_rs_tpu.sequence import Sequence, SequenceContainer

        rng = np.random.default_rng(41)
        cont = SequenceContainer()
        # 5 small sequences + one long one: the (big, big) self pair
        # exceeds total/8 and must split.
        for k in range(5):
            cont.sequences.append(
                Sequence(
                    f"s{k}", "".join(rng.choice(list("ACGT"), 60))
                )
            )
        cont.sequences.append(
            Sequence("big", "".join(rng.choice(list("ACGT"), 700)))
        )
        from genomics_rs_tpu.config import Scores

        sc = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)
        ref = allpairs_scores(cont, sc, is_local=False, engine="scan")
        got = allpairs_hybrid(
            cont, sc, n_shares=8, is_local=False, engine="scan"
        )
        np.testing.assert_array_equal(got.matrix, ref.matrix)

    def test_local_mode(self):
        import numpy as np

        from genomics_rs_tpu.parallel.allpairs import allpairs_scores
        from genomics_rs_tpu.parallel.distributed import allpairs_hybrid
        from genomics_rs_tpu.sequence import Sequence, SequenceContainer
        from genomics_rs_tpu.config import Scores

        rng = np.random.default_rng(43)
        cont = SequenceContainer()
        for k in range(4):
            cont.sequences.append(
                Sequence(
                    f"s{k}", "".join(rng.choice(list("ACGT"), 50))
                )
            )
        cont.sequences.append(
            Sequence("big", "".join(rng.choice(list("ACGT"), 500)))
        )
        sc = Scores(s_match=1, s_mismatch=-2, g=-1, h=-5)
        ref = allpairs_scores(cont, sc, is_local=True, engine="scan")
        got = allpairs_hybrid(
            cont, sc, n_shares=8, is_local=True, engine="scan"
        )
        np.testing.assert_array_equal(got.matrix, ref.matrix)
