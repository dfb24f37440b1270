"""Multi-host execution: process init + host-sharded all-pairs.

The reference's only fan-out is a rayon thread pool on one machine
(``/root/reference/src/main.rs:245-261``). The multi-host equivalent:

* :func:`init_distributed` — ``jax.distributed.initialize`` driven by
  the standard env (JAX_COORDINATOR_ADDRESS / num_processes /
  process_id). No-op when single-process.
* :func:`allpairs_multihost` — the pair list is dealt round-robin
  across processes (pairs are embarrassingly parallel, so the network
  only carries the final merge); each host scores its share on its
  local devices and results are merged with
  ``multihost_utils.process_allgather``.

Single-process degrades to the local all-pairs driver, which is what
the tests exercise; the multi-process path follows the standard JAX
multi-controller model and needs no further per-host state (every
process computes a disjoint pair set and the gather is a pure concat).
"""

from __future__ import annotations

import logging
import os

import numpy as np

import jax

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.sequence import SequenceContainer

log = logging.getLogger(__name__)


_initialized = False


def init_distributed() -> tuple[int, int]:
    """Initialize multi-process JAX if configured; returns
    (process_index, process_count).

    ``jax.distributed.initialize`` must run BEFORE any backend use, so
    initialization is tracked with a module flag rather than by
    querying ``jax.process_count()`` (which would itself initialize
    the local backend and break the multi-host setup)."""
    global _initialized
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord and not _initialized:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        try:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=num_processes,
                process_id=int(os.environ["JAX_PROCESS_ID"]),
            )
            _initialized = True
        except Exception as e:  # noqa: BLE001
            if num_processes > 1:
                # On a genuinely multi-process launch, proceeding with
                # process_count()==1 would make every host silently
                # compute the full workload; fail loudly instead.
                raise RuntimeError(
                    "jax.distributed.initialize failed for a "
                    f"{num_processes}-process launch (coordinator "
                    f"{coord}): {e}"
                ) from e
            log.warning("jax.distributed.initialize failed: %s", e)
    return jax.process_index(), jax.process_count()


def balanced_deal(costs, n_shares: int) -> list[list[int]]:
    """Deal item indices into ``n_shares`` balanced shares (LPT).

    Longest-processing-time greedy: items sorted by descending cost,
    each placed on the currently least-loaded share. Guarantees the
    bottleneck share is within 4/3 of optimal (Graham), and measured
    on the mixed 30 kb + 155 kb corpus it reaches the indivisible-
    item bound exactly — round 3's boustrophedon ("snake") deal lost
    35 efficiency points there because a snake assigns by POSITION,
    not accumulated load, so the share holding the one giant pair
    keeps receiving its positional quota (BENCH work_balance row).
    Ties break on share index: deterministic across hosts.
    """
    import heapq

    order = sorted(range(len(costs)), key=lambda k: -costs[k])
    heap = [(0.0, h) for h in range(n_shares)]
    heapq.heapify(heap)
    shares: list[list[int]] = [[] for _ in range(n_shares)]
    for k in order:
        load, h = heapq.heappop(heap)
        shares[h].append(k)
        heapq.heappush(heap, (load + float(costs[k]), h))
    return shares


#: Backwards-compatible name (round-3 API).
snake_deal = balanced_deal


#: column blocks per seq-shard in the hybrid split's pipeline model:
#: a k-shard tile pipeline with C column blocks keeps each shard busy
#: C of (C + k - 1) steps, so C = PIPELINE_BLOCKS*k bounds the bubble
#: at (k-1)/(C+k-1) < 1/PIPELINE_BLOCKS (~11% at 8). A model only:
#: it charges no collective or per-step cost.
PIPELINE_BLOCKS = 8


class WorkUnit:
    """One share entry from :func:`hybrid_deal`.

    ``nparts == 1``: this share scores pair ``index`` alone.
    ``nparts > 1``: pair ``index`` is seq-parallel across the hosts in
    ``group`` (this share is one of them) — rows sharded over a
    ``group``-sized sub-mesh, the alignment-capable pipeline of
    ``parallel/longseq`` (``sharded_gotoh_score`` / ``align_sharded``).
    """

    __slots__ = ("index", "nparts", "group")

    def __init__(self, index: int, nparts: int, group: tuple):
        self.index = index
        self.nparts = nparts
        self.group = group

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"WorkUnit({self.index}, {self.nparts}, {self.group})"

    def __eq__(self, other):
        return (
            isinstance(other, WorkUnit)
            and (self.index, self.nparts, self.group)
            == (other.index, other.nparts, other.group)
        )


def split_cost(cost: float, nparts: int) -> float:
    """Per-host cost model of a ``nparts``-way seq-parallel fill:
    ``cost/nparts`` of cells plus the tile-pipeline bubble at
    ``C = PIPELINE_BLOCKS * nparts`` column blocks (each shard is
    active C of C + nparts - 1 steps)."""
    if nparts <= 1:
        return float(cost)
    C = PIPELINE_BLOCKS * nparts
    return float(cost) / nparts * (C + nparts - 1) / C


def hybrid_deal(costs, n_shares: int) -> list[list[WorkUnit]]:
    """LPT dealing that SPLITS oversized items across host groups.

    ``balanced_deal`` is optimal-at-the-bound for indivisible items,
    but a single pair costing more than ``total/n_shares`` caps the
    bottleneck efficiency at ``total/(n_shares * max_item)`` no matter
    the deal (round 4 measured 0.62 on the mixed 30 kb + 155 kb corpus
    at 8 hosts). This deal makes the item divisible: any item whose
    cost exceeds the fair share is assigned to the ``k`` currently
    least-loaded hosts as one seq-parallel group
    (``parallel/longseq`` — rows sharded, boundary rows ride the
    pipeline), each charged :func:`split_cost`. Remaining items follow
    plain LPT. The group size trades split overhead (the pipeline
    bubble grows with k) against residual lumpiness, so a small
    deterministic policy sweep (k = ceil(cost/fair) + 0..3) keeps the
    best measured bottleneck. Deterministic (ties break on host
    index).
    """
    import heapq
    import math

    total = float(sum(costs))
    fair = total / max(n_shares, 1)
    order = sorted(range(len(costs)), key=lambda k: -costs[k])

    def deal(extra: int):
        heap = [(0.0, h) for h in range(n_shares)]
        heapq.heapify(heap)
        shares: list[list[WorkUnit]] = [[] for _ in range(n_shares)]
        loads = [0.0] * n_shares
        for k in order:
            c = float(costs[k])
            if c > fair and n_shares > 1:
                parts = min(n_shares, math.ceil(c / fair) + extra)
                popped = [heapq.heappop(heap) for _ in range(parts)]
                group = tuple(sorted(h for _, h in popped))
                sub = split_cost(c, parts)
                for load, h in popped:
                    shares[h].append(WorkUnit(k, parts, group))
                    heapq.heappush(heap, (load + sub, h))
                    loads[h] = load + sub
            else:
                load, h = heapq.heappop(heap)
                shares[h].append(WorkUnit(k, 1, (h,)))
                heapq.heappush(heap, (load + c, h))
                loads[h] = load + c
        return max(loads), shares

    best = None
    for extra in range(4):
        bottleneck, shares = deal(extra)
        if best is None or bottleneck < best[0]:
            best = (bottleneck, shares)
    return best[1]


def allpairs_hybrid(
    container: SequenceContainer,
    scores: Scores,
    n_shares: int | None = None,
    is_local: bool = False,
    engine: str = "auto",
):
    """All-pairs scores under the HYBRID deal: oversized pairs run
    seq-parallel over device sub-meshes instead of capping one share.

    Single-process form (devices stand in for hosts — the same
    ``WorkUnit`` plan drives a multi-host launch, where each group
    forms its sub-mesh across hosts): plain pairs go through the bucketed
    batch engines; each split pair's rows are sharded over a
    ``nparts``-device sub-mesh and filled by the collective tile
    pipeline (``parallel/longseq.sharded_gotoh_score``). Scores are
    bit-identical to the local driver (pinned by tests on the CPU
    mesh). Closes the gap where ``balanced_deal`` dealt whole pairs
    only and one 155 kb outlier capped the 8-host bottleneck
    efficiency of the mixed corpus at 0.62 (cost accounting).
    """
    import time

    from genomics_rs_tpu.parallel.allpairs import (
        AllPairsResult,
        _score_pairs_bucketed,
    )
    from genomics_rs_tpu.parallel.longseq import sharded_gotoh_score
    from genomics_rs_tpu.parallel.mesh import SEQ_AXIS
    from genomics_rs_tpu.sequence import PAD_S1, PAD_S2, round_up

    devices = jax.devices()
    H = n_shares or len(devices)
    seqs = container.sequences
    names = [s.name for s in seqs]
    num = len(names)
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    costs = [(lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs]
    shares = hybrid_deal(costs, H)

    split_jobs: dict[int, tuple] = {}
    plain: list[int] = []
    for units in shares:
        for u in units:
            if u.nparts > 1:
                split_jobs[u.index] = u.group
            else:
                plain.append(u.index)

    t0 = time.perf_counter()
    matrix = np.zeros((num, num), dtype=np.int64)
    padded = 0.0
    if plain:
        sc, padded = _score_pairs_bucketed(
            container,
            [pairs[k] for k in plain],
            lens,
            scores,
            is_local,
            engine,
            mesh=None,
        )
        for k, v in zip(plain, sc):
            i, j = pairs[k]
            matrix[j, i] = int(v)

    for k, group in split_jobs.items():
        i, j = pairs[k]
        parts = len(group)
        sub_devs = np.array([devices[h % len(devices)] for h in group])
        sub_mesh = jax.sharding.Mesh(sub_devs, (SEQ_AXIS,))
        m, n = int(lens[i]), int(lens[j])
        C = PIPELINE_BLOCKS * parts
        Lm = max(round_up(m, 128 * parts), 128 * parts)
        Ln = max(round_up(n, 128 * C), 128 * C)
        s1e = seqs[i].encoded(pad_to=Lm, pad_value=PAD_S1)
        s2e = seqs[j].encoded(pad_to=Ln, pad_value=PAD_S2)
        res = sharded_gotoh_score(
            sub_mesh,
            s1e,
            s2e,
            m,
            n,
            scores,
            is_local=is_local,
            n_blocks=C,
            engine=engine,
        )
        matrix[j, i] = int(
            res.best[0] if is_local else res.score
        )
        padded += (Lm + 1.0) * (Ln + 1.0)
        log.info(
            "[AllPairs/hybrid] pair (%d, %d) = %.3g cells split over "
            "%d shards (group %s)",
            i,
            j,
            costs[k],
            parts,
            group,
        )

    elapsed = time.perf_counter() - t0
    cells = float(sum(costs))
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=matrix,
        elapsed_s=elapsed,
        cells=cells,
        cells_per_s=cells / elapsed,
        padded_cells=padded,
    )


def allpairs_multihost(
    container: SequenceContainer,
    scores: Scores,
    is_local: bool = False,
    engine: str = "auto",
):
    """All-pairs DP score matrix with pairs dealt across hosts.

    Pairs are dealt *length-balanced*: sorted by descending DP cell
    count, then snake-dealt (host h takes sorted positions h,
    2P-1-h, 2P+h, ...) so no host accumulates all the long pairs —
    padding-free work balance the reference's rayon queue gets
    dynamically (``main.rs:253-261``) but a static deal must plan for.
    Each host scores its share on its local devices in length buckets,
    then the per-host (pair index, score) vectors are all-gathered and
    assembled into the full lower-triangle matrix on every host
    (replicated output, like the reference's shared matrix).
    """
    from genomics_rs_tpu.parallel.allpairs import (
        AllPairsResult,
        _score_pairs_bucketed,
        allpairs_scores,
    )

    pid, pcount = jax.process_index(), jax.process_count()
    if pcount == 1:
        return allpairs_scores(container, scores, is_local, engine)

    import time

    from jax.experimental import multihost_utils

    names = [s.name for s in container.sequences]
    num = len(names)
    lens = np.array([len(s) for s in container.sequences], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    share_idx = snake_deal(
        [(lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs], pcount
    )
    mine_idx = share_idx[pid]
    mine = [pairs[k] for k in mine_idx]

    t0 = time.perf_counter()
    share_cap = max(len(s) for s in share_idx)
    local_scores = np.zeros(share_cap, dtype=np.int32)
    local_pairs = np.full(share_cap, -1, dtype=np.int32)
    if mine:
        # mesh=None => host-local scoring (each process sees only its
        # own devices; a global mesh would yield non-addressable
        # outputs here).
        sc, _ = _score_pairs_bucketed(
            container, mine, lens, scores, is_local, engine, mesh=None
        )
        local_scores[: len(mine)] = sc
        local_pairs[: len(mine)] = mine_idx

    # Cross-host merge: every host contributes its (pair index, score) share.
    g_scores = multihost_utils.process_allgather(local_scores)
    g_pairs = multihost_utils.process_allgather(local_pairs)
    matrix = np.zeros((num, num), dtype=np.int64)
    for p in range(pcount):
        for k, s in zip(g_pairs[p], g_scores[p]):
            if k >= 0:
                i, j = pairs[int(k)]
                matrix[j, i] = int(s)
    elapsed = time.perf_counter() - t0

    cells = float(sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs))
    log.info(
        "[AllPairs/multihost] %d pairs over %d hosts in %.2fs (%.3g cells/s)",
        len(pairs),
        pcount,
        elapsed,
        cells / elapsed,
    )
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=matrix,
        elapsed_s=elapsed,
        cells=cells,
        cells_per_s=cells / elapsed,
    )
