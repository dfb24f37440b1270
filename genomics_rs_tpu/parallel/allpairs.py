"""All-pairs DP alignment-score matrix.

The DP-scored counterpart of the compare driver's suffix-tree
similarity (``comparison/driver.py``): every pair (i <= j) of a
sequence container is globally/locally aligned and the score matrix is
assembled, lower triangle like the reference's similarity matrix
(``/root/reference/src/main.rs:263-315``) — at 30 kb genome scale this
is ~4.9e10 DP cells for a 10-genome corpus, a workload the reference
cannot touch with DP at all.

Pairs are grouped into power-of-two length buckets; each bucket is one
fixed-shape batch of score-only fills (O(m+n) memory per pair),
``vmap``-ed on one device or sharded over the ``data`` axis of a
multi-device mesh via ``batch_scores_sharded``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np

import jax

from genomics_rs_tpu.config import Scores
from genomics_rs_tpu.ops.engine import resolve_engine
from genomics_rs_tpu.parallel.batch import batch_scores_sharded, pad_batch
from genomics_rs_tpu.parallel.mesh import make_mesh
from genomics_rs_tpu.sequence import (
    PAD_S1,
    PAD_S2,
    SequenceContainer,
    round_up,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class AllPairsResult:
    names: list[str]
    lengths: list[int]
    #: [j][i] = score for i <= j; zeros above the diagonal.
    matrix: np.ndarray
    elapsed_s: float
    cells: float
    cells_per_s: float
    #: total cells actually dispatched (incl. padding); close to
    #: ``cells`` when length bucketing is effective.
    padded_cells: float = 0.0




def _bucket_key(L: int) -> int:
    """Power-of-two length class (128 floor) for pair grouping."""
    b = 128
    while b < L:
        b *= 2
    return b


def bucketize_pairs(
    pairs: list[tuple[int, int]], lens
) -> dict[tuple[int, int], list[int]]:
    """Group pair indices by (pow2 class of len_i, pow2 class of
    len_j) so each group dispatches at its own padded shape.

    The reference pays zero padding (exact per-pair loops,
    ``/root/reference/src/main.rs:263-308``); global max-length
    padding would instead inflate every pair's cell count
    quadratically when one long outlier is present. Power-of-two
    classes bound the number of compiled shapes at ~log^2 while each
    group is then padded only to its own max length (round 128).
    """
    groups: dict[tuple[int, int], list[int]] = {}
    for k, (i, j) in enumerate(pairs):
        key = (_bucket_key(int(lens[i])), _bucket_key(int(lens[j])))
        groups.setdefault(key, []).append(k)
    return groups


def _score_pairs_bucketed(
    container: SequenceContainer,
    pairs: list[tuple[int, int]],
    lens,
    scores: Scores,
    is_local: bool,
    engine: str,
    mesh: jax.sharding.Mesh | None = None,
) -> tuple[np.ndarray, float]:
    """Score ``pairs`` in length buckets; returns (scores[k],
    padded_cells dispatched).

    With a multi-device ``mesh``, each bucket is sharded over the
    mesh's data axis; otherwise it runs as one batch on the default
    device.
    """
    from genomics_rs_tpu.parallel.batch import score_pairs
    from genomics_rs_tpu.utils.devcache import device_put_cached

    seqs = container.sequences
    out = np.zeros(len(pairs), dtype=np.int64)
    padded_cells = 0.0
    enc_cache: dict[tuple[int, int, int], np.ndarray] = {}

    def enc(idx: int, L: int, pad_value: int) -> np.ndarray:
        key = (idx, L, pad_value)
        if key not in enc_cache:
            enc_cache[key] = seqs[idx].encoded(pad_to=L, pad_value=pad_value)
        return enc_cache[key]

    groups = bucketize_pairs(pairs, lens)
    for key in sorted(groups):
        idxs = groups[key]
        Lm = max(
            round_up(max(int(lens[pairs[k][0]]) for k in idxs), 128), 128
        )
        Ln = max(
            round_up(max(int(lens[pairs[k][1]]) for k in idxs), 128), 128
        )
        s1b = np.stack([enc(pairs[k][0], Lm, PAD_S1) for k in idxs])
        s2b = np.stack([enc(pairs[k][1], Ln, PAD_S2) for k in idxs])
        ms = np.array([lens[pairs[k][0]] for k in idxs], dtype=np.int32)
        ns = np.array([lens[pairs[k][1]] for k in idxs], dtype=np.int32)
        if mesh is not None and mesh.devices.size > 1:
            n_dev = mesh.devices.size
            (s1p, s2p, mp, np_), _ = pad_batch(
                (s1b, s2b, ms, ns),
                len(idxs),
                n_dev,
                pad_values=[None, None, 0, 0],
            )
            sc = batch_scores_sharded(
                mesh, s1p, s2p, mp, np_, scores, is_local, engine=engine
            ).score
        else:
            # Steady-state callers (msa's score pass, repeated
            # align-matrix jobs) resubmit identical operand stacks:
            # hand the fill device-resident copies (utils/devcache).
            sc, _, _ = score_pairs(
                device_put_cached(s1b),
                device_put_cached(s2b),
                ms,
                ns,
                scores,
                is_local,
                engine=engine,
            )
        sc = np.asarray(sc)
        for pos, k in enumerate(idxs):
            out[k] = int(sc[pos])
        padded_cells += float(len(idxs)) * (Lm + 1.0) * (Ln + 1.0)
        log.debug(
            "[AllPairs] bucket %s: %d pairs at (%d, %d)",
            key,
            len(idxs),
            Lm,
            Ln,
        )
    return out, padded_cells


def allpairs_scores(
    container: SequenceContainer,
    scores: Scores,
    is_local: bool = False,
    engine: str = "auto",
    mesh: jax.sharding.Mesh | None = None,
) -> AllPairsResult:
    """Score matrix over all pairs (i <= j), lower-triangle layout.

    Single-process multi-device runs shard each length bucket over the
    local data mesh (psum/pmax stat merge); multi-host runs go through
    ``allpairs_multihost`` instead (pair dealing — each process's
    devices are not globally addressable).
    """
    engine = resolve_engine(engine)
    if mesh is None and jax.process_count() == 1 and len(jax.devices()) > 1:
        mesh = make_mesh()

    names = [s.name for s in container.sequences]
    num = len(names)
    lens = np.array([len(s) for s in container.sequences], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    total_cells = float(
        sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs)
    )
    matrix = np.zeros((num, num), dtype=np.int64)

    t0 = time.perf_counter()
    sc, padded_cells = _score_pairs_bucketed(
        container, pairs, lens, scores, is_local, engine, mesh
    )
    for k, (i, j) in enumerate(pairs):
        matrix[j, i] = int(sc[k])
    elapsed = time.perf_counter() - t0

    log.info(
        "[AllPairs] %d pairs, %.3g cells (%.3g padded) in %.2fs "
        "(%.3g cells/s, engine=%s)",
        len(pairs),
        total_cells,
        padded_cells,
        elapsed,
        total_cells / elapsed,
        engine,
    )
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=matrix,
        elapsed_s=elapsed,
        cells=total_cells,
        cells_per_s=total_cells / elapsed,
        padded_cells=padded_cells,
    )


def allpairs_matrix_scores(
    container: SequenceContainer,
    matrix,
    g: int,
    h: int,
    is_local: bool = False,
) -> AllPairsResult:
    """All-pairs scores under a full substitution matrix (protein).

    Same result layout as :func:`allpairs_scores`; each length bucket
    dispatches one batched matmul + wavefront fill
    (``ops/gotoh_matrix.gotoh_scores_matrix``). An extension — the
    reference has no substitution-matrix support.
    """
    from genomics_rs_tpu.ops.gotoh_matrix import gotoh_scores_matrix
    from genomics_rs_tpu.sequence import PAD_S1, PAD_S2

    names = [s.name for s in container.sequences]
    num = len(names)
    seqs = container.sequences
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    total_cells = float(
        sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs)
    )
    out = np.zeros((num, num), dtype=np.int64)

    t0 = time.perf_counter()
    groups = bucketize_pairs(pairs, lens)
    padded_cells = 0.0
    for key in sorted(groups):
        sub = [pairs[k] for k in groups[key]]
        Lm = max(int(lens[i]) for i, _ in sub)
        Ln = max(int(lens[j]) for _, j in sub)
        Lm = max(-(-Lm // 128) * 128, 128)
        Ln = max(-(-Ln // 128) * 128, 128)
        s1b = np.stack(
            [seqs[i].encoded(pad_to=Lm, pad_value=PAD_S1) for i, _ in sub]
        )
        s2b = np.stack(
            [seqs[j].encoded(pad_to=Ln, pad_value=PAD_S2) for _, j in sub]
        )
        ms = np.array([lens[i] for i, _ in sub], dtype=np.int32)
        ns = np.array([lens[j] for _, j in sub], dtype=np.int32)
        padded_cells += float(len(sub)) * (Lm + 1.0) * (Ln + 1.0)
        out3 = gotoh_scores_matrix(
            s1b, s2b, ms, ns, matrix, g=g, h=h, is_local=is_local
        )
        sc = np.asarray(out3[0])
        for (i, j), v in zip(sub, sc):
            out[j, i] = int(v)
    elapsed = time.perf_counter() - t0

    log.info(
        "[AllPairs/matrix] %d pairs, %.3g cells in %.2fs (%.3g cells/s)",
        len(pairs),
        total_cells,
        elapsed,
        total_cells / elapsed,
    )
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=out,
        elapsed_s=elapsed,
        cells=total_cells,
        cells_per_s=total_cells / elapsed,
        padded_cells=padded_cells,
    )


def allpairs_scores_resumable(
    container: SequenceContainer,
    scores: Scores,
    checkpoint_path: str,
    is_local: bool = False,
    engine: str = "auto",
    chunk_pairs: int = 64,
) -> AllPairsResult:
    """All-pairs scoring with crash-resumable per-chunk checkpoints.

    The all-pairs job is embarrassingly restartable (SURVEY §5):
    pair chunks are scored in order and appended to ``checkpoint_path``
    (a JSONL of {"k0": chunk start, "scores": [...]}); on restart,
    completed chunks are loaded instead of recomputed. The final
    matrix is identical to :func:`allpairs_scores`.
    """
    import json

    engine = resolve_engine(engine)

    names = [s.name for s in container.sequences]
    num = len(names)
    lens = np.array([len(s) for s in container.sequences], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    matrix = np.zeros((num, num), dtype=np.int64)
    mesh = None
    if jax.process_count() == 1 and len(jax.devices()) > 1:
        mesh = make_mesh()

    import hashlib

    # Names + content digest invalidate the checkpoint on ANY corpus
    # change — without them a length-preserving sequence edit would
    # silently reuse stale chunk scores.
    digest = hashlib.sha256()
    for s in container.sequences:
        digest.update(s.name.encode())
        digest.update(b"\0")
        digest.update(s.sequence.encode())
        digest.update(b"\1")
    meta = {
        "chunk_pairs": chunk_pairs,
        "n_pairs": len(pairs),
        "is_local": is_local,
        "scores": list(scores.as_tuple()),
        "lengths": [int(x) for x in lens],
        "names": names,
        "digest": digest.hexdigest(),
    }
    done: dict[int, list[int]] = {}
    if os.path.exists(checkpoint_path):
        try:
            with open(checkpoint_path) as f:
                lines = f.read().splitlines()
            if lines and json.loads(lines[0]).get("meta") == meta:
                for line in lines[1:]:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # truncated tail from a crash mid-write
                    if len(rec["scores"]) == len(
                        pairs[rec["k0"] : rec["k0"] + chunk_pairs]
                    ):
                        done[rec["k0"]] = rec["scores"]
            else:
                log.warning(
                    "[AllPairs/resume] checkpoint %s was written with "
                    "different inputs/params; starting fresh",
                    checkpoint_path,
                )
                os.remove(checkpoint_path)
        except (OSError, json.JSONDecodeError, KeyError) as e:
            log.warning(
                "[AllPairs/resume] unreadable checkpoint (%s); starting "
                "fresh",
                e,
            )
            os.remove(checkpoint_path)
        if done:
            log.info(
                "[AllPairs/resume] %d/%d chunks already done",
                len(done),
                -(-len(pairs) // chunk_pairs),
            )
    # Rewrite the file from validated records so a torn trailing line
    # from a crash mid-write can't corrupt subsequent appends.
    with open(checkpoint_path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for k0 in sorted(done):
            f.write(json.dumps({"k0": k0, "scores": done[k0]}) + "\n")

    t0 = time.perf_counter()
    with open(checkpoint_path, "a") as ckpt:
        for k0 in range(0, len(pairs), chunk_pairs):
            chunk = pairs[k0 : k0 + chunk_pairs]
            if k0 in done:
                sc = done[k0]
            else:
                out, _ = _score_pairs_bucketed(
                    container, chunk, lens, scores, is_local, engine, mesh
                )
                sc = [int(x) for x in out]
                ckpt.write(json.dumps({"k0": k0, "scores": sc}) + "\n")
                ckpt.flush()
            for (i, j), s in zip(chunk, sc):
                matrix[j, i] = s
    elapsed = time.perf_counter() - t0

    total_cells = float(
        sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs)
    )
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=matrix,
        elapsed_s=elapsed,
        cells=total_cells,
        cells_per_s=total_cells / max(elapsed, 1e-9),
    )


def write_scores_tsv(result: AllPairsResult, path: str) -> str:
    """Same TSV shape as the reference similarity matrix
    (``main.rs:330-360``): index header row, then one row per
    sequence."""
    num = len(result.names)
    lines = ["\t" + "\t".join(str(i) for i in range(num)) + "\t"]
    for j in range(num):
        cells = "\t".join(str(int(result.matrix[j, i])) for i in range(num))
        lines.append(f"{j}\t{cells}\t")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text
