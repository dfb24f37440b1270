"""Pileup + consensus variant calling over mapped reads.

No reference counterpart (``/root/reference`` stops at alignment);
this completes the read pipeline the framework opened with ``map``:
map -> pileup -> call.

The pileup is built from SAM-normalized records (``reads.sam_records``
— same POS/CIGAR edge folding as the SAM writer, so the two outputs
agree): each record's CIGAR is expanded run-by-run into (position,
base-code) arrays with numpy slices — no per-base Python — and the
whole read set lands in one scatter-add per contig, on device
(``counts.at[pos, code].add(1)`` under jit) or host (``np.add.at``),
bit-identical.

Codes: A/C/G/T = 0..3, deletion = 4 (a D run deposits code 4 on every
deleted reference position). Insertions consume read bases without a
reference position; each I run is recorded as an event (anchor
position, inserted string) in a side map, and the read-cursor advance
keeps every following M run's bases on the right positions. Non-ACGT
read bases are skipped.

Calling is per-position consensus: at depth >= ``min_depth``, the
most-voted non-reference code with fraction >= ``min_frac`` becomes a
call — a SNP (codes 0..3) or a deletion (code 4); adjacent deletion
calls merge into one VCF record with the standard anchor-base
representation. Insertions are called per anchor from the event map
under the same gates (``call_insertions``).

QUALITY-AWARE EVIDENCE (round-4): the pipeline already carries FASTQ
Phred strings (``sequence.py`` FASTQ loader; reverse-complement
reverses them in step) and real MAPQ (``models/mapper``), so the
pileup can weigh votes instead of counting heads:

* reads below ``min_mapq`` are excluded entirely; M/X/= bases below
  ``min_baseq`` are excluded (no vote, no depth);
* each surviving base votes ``(1 - 10^(-baseq/10)) *
  (1 - 10^(-mapq/10))`` — its probability of being a correct
  observation; deletion marks and insertion events carry the MAPQ
  factor only (a deleted base has no base quality);
* ``call_pileup``/``call_insertions`` then gate the **weighted**
  alt fraction while the depth gate stays on integer coverage.

Counting mode (all weights 1, no gates) remains the default for the
plain ``pileup``/``call_pileup`` API. One documented deviation from
round 3 in BOTH modes: an I run at the LEADING edge of an alignment
(no reference-consuming op before it) is dropped rather than anchored
at a reference base the read does not cover (ADVICE r3 — the old
anchor gave the event a depth made entirely of other reads).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

log = logging.getLogger(__name__)

_BASES = "ACGT"
_CODE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(_BASES):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i
DEL_CODE = 4


@dataclasses.dataclass
class VariantCall:
    contig: str
    #: 1-based position of the variant base itself (VCF POS differs
    #: for deletions: anchor base, pos - 1).
    pos: int
    ref: str  # reference base(s): one base for SNPs, run for dels
    alt: str  # alt base for SNPs, "" for deletions
    depth: int
    alt_count: int

    @property
    def frac(self) -> float:
        return self.alt_count / self.depth if self.depth else 0.0

    @property
    def is_deletion(self) -> bool:
        return self.alt == ""

    @property
    def is_insertion(self) -> bool:
        return len(self.alt) > 1


def _phred_probs(qual: str) -> np.ndarray:
    """Phred+33 string -> per-base correctness probability
    ``1 - 10^(-q/10)`` (float32)."""
    q = (
        np.frombuffer(qual.encode("latin-1"), dtype=np.uint8).astype(
            np.float32
        )
        - 33.0
    )
    return 1.0 - np.power(10.0, -q / 10.0, dtype=np.float32)


def _mapq_factor(mapq: int) -> float:
    """MAPQ -> probability the mapping is correct. 255 means
    'unavailable' in SAM — treated as certain.

    Floored at 0.5: the Phred identity 1-10^(-q/10) reads MAPQ 0 as
    "certainly misplaced" (weight 0), but a low/zero seed-margin
    mapping is at worst a COIN FLIP between a couple of candidate
    loci — variants inside repeats would otherwise be structurally
    uncallable because every covering read weighs 0 (the identity
    crosses 0.5 at q=3, so the floor also keeps the curve monotone).
    """
    if mapq >= 255:
        return 1.0
    return float(max(1.0 - 10.0 ** (-mapq / 10.0), 0.5))


def _expand_records(
    records: list[dict],
    min_baseq: int = 0,
    min_mapq: int = 0,
    collect_weights: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None, dict, dict | None]:
    """(positions, codes, weights, insertions, ins_w): pileup inputs.

    ``insertions`` maps a 0-based anchor position (the reference base
    the inserted run follows) to a Counter of inserted strings — an I
    run between reference positions ``r-1`` and ``r`` anchors at
    ``r-1``. An I run at the leading edge of a read (before any
    reference-consuming op) is dropped: its anchor would be a
    reference base the read itself does not cover, so the event's
    depth gate would be judged against evidence from other reads only
    (ADVICE r3) — and a leading-edge insert is an alignment artifact
    anyway (the aligner could equally have placed it as a clip).

    With ``collect_weights`` each vote also gets a correctness weight
    (see the module docstring); ``min_baseq`` drops individual M/X/=
    bases, ``min_mapq`` drops whole reads. ``weights``/``ins_w`` are
    None when ``collect_weights`` is False.
    """
    import re

    pos_chunks: list[np.ndarray] = []
    code_chunks: list[np.ndarray] = []
    w_chunks: list[np.ndarray] = []
    insertions: dict = {}
    ins_w: dict | None = {} if collect_weights else None
    for rec in records:
        if not rec["mapped"]:
            continue
        mapq = int(rec.get("mapq", 255))
        if mapq < min_mapq:
            continue
        wm = np.float32(_mapq_factor(mapq)) if collect_weights else None
        seq_codes = _CODE[
            np.frombuffer(rec["seq"].encode("latin-1"), dtype=np.uint8)
        ]
        qual = rec.get("qual") or "*"
        probs = None
        if qual != "*" and (min_baseq > 0 or collect_weights):
            probs = _phred_probs(qual)
            if len(probs) != len(seq_codes):
                raise ValueError(
                    f"quality length {len(probs)} != read length "
                    f"{len(seq_codes)}"
                )
        q = 0  # read cursor
        r = rec["pos"] - 1  # 0-based reference cursor
        covered = False  # any reference-consuming op seen yet?
        runs = re.findall(r"(\d+)([A-Z=])", rec["cigar"])
        if "".join(n + op for n, op in runs) != rec["cigar"]:
            raise ValueError(f"malformed CIGAR {rec['cigar']!r}")
        for n_str, op in runs:
            n = int(n_str)
            if op in ("M", "=", "X"):
                codes = seq_codes[q : q + n].astype(np.int32)
                keep = codes >= 0  # skip non-ACGT read bases
                if probs is not None and min_baseq > 0:
                    # Phred+33 threshold on the raw quality chars.
                    qv = (
                        np.frombuffer(
                            qual[q : q + n].encode("latin-1"),
                            dtype=np.uint8,
                        ).astype(np.int32)
                        - 33
                    )
                    keep = keep & (qv >= min_baseq)
                pos_chunks.append(
                    (r + np.arange(n, dtype=np.int64))[keep]
                )
                code_chunks.append(codes[keep])
                if collect_weights:
                    wb = (
                        probs[q : q + n][keep]
                        if probs is not None
                        else np.ones(
                            int(keep.sum()), dtype=np.float32
                        )
                    )
                    w_chunks.append(wb * wm)
                q += n
                r += n
                covered = True
            elif op == "D":
                pos_chunks.append(r + np.arange(n, dtype=np.int64))
                code_chunks.append(
                    np.full(n, DEL_CODE, dtype=np.int32)
                )
                if collect_weights:
                    # No base quality exists for a deleted base; the
                    # MAPQ factor is the whole weight.
                    w_chunks.append(np.full(n, wm, dtype=np.float32))
                r += n
                covered = True
            elif op == "N":
                # Skipped reference region (splice): consumes ref
                # positions but is NOT deletion evidence.
                r += n
                covered = True
            elif op == "I":
                anchor = r - 1
                ins = rec["seq"][q : q + n].upper()
                # Pure-ACGT inserts only: N/IUPAC bases would flow
                # into VCF ALT (invalid) and split consensus votes —
                # same skip contract as the per-base pileup.
                if covered and anchor >= 0 and all(
                    _CODE[ord(ch)] >= 0 for ch in ins
                ):
                    bucket = insertions.setdefault(anchor, {})
                    bucket[ins] = bucket.get(ins, 0) + 1
                    if collect_weights:
                        # Weight the event like the per-base votes it
                        # competes against (baseq x MAPQ): the anchor
                        # depth sums base-quality products, so a
                        # MAPQ-only event weight would let LOW base
                        # qualities inflate the insertion fraction
                        # past min_frac (inverted evidence).
                        wi = wm
                        if probs is not None and n:
                            wi = wm * float(
                                np.mean(probs[q : q + n])
                            )
                        wbucket = ins_w.setdefault(anchor, {})
                        wbucket[ins] = wbucket.get(ins, 0.0) + float(wi)
                q += n
            elif op == "S":  # read-only
                q += n
            elif op in ("H", "P"):
                pass  # consume neither cursor
            else:
                # A silently skipped op would desync every following
                # M run's positions — fail loudly instead.
                raise ValueError(
                    f"unsupported CIGAR op {op!r} in {rec['cigar']!r}"
                )
    if not pos_chunks:
        return (
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.float32) if collect_weights else None,
            insertions,
            ins_w,
        )
    return (
        np.concatenate(pos_chunks),
        np.concatenate(code_chunks),
        np.concatenate(w_chunks) if collect_weights else None,
        insertions,
        ins_w,
    )


_SCATTER_JIT = None
_SCATTER_W_JIT = None


def _scatter_device(p, c, *, ref_len: int):
    """One compiled scatter per (contig length, update count): the
    jitted callable is created once and cached at module level, so
    repeated pileups reuse the compiled kernel instead of retracing."""
    global _SCATTER_JIT
    if _SCATTER_JIT is None:
        import functools

        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("L",))
        def _scatter(p, c, L):
            counts = jnp.zeros((L + 1, 5), dtype=jnp.int32)
            # Clip out-of-range positions onto a spill row instead of
            # dropping silently (asserted by the caller).
            p = jnp.where((p >= 0) & (p < L), p, L)
            return counts.at[p, c].add(1)

        _SCATTER_JIT = _scatter
    return _SCATTER_JIT(p, c, L=ref_len)


def _scatter_device_w(p, c, w, *, ref_len: int):
    """Counts + weight sums in one fused device dispatch.

    Counts are int32 and exact. Weight sums are float32 scatter-adds
    whose summation order on the GPU varies from run to run, so they
    match a host sum to float32 rounding (relative ~1e-6), not bit for
    bit."""
    global _SCATTER_W_JIT
    if _SCATTER_W_JIT is None:
        import functools

        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("L",))
        def _scatter_w(p, c, w, L):
            counts = jnp.zeros((L + 1, 5), dtype=jnp.int32)
            wsum = jnp.zeros((L + 1, 5), dtype=jnp.float32)
            p = jnp.where((p >= 0) & (p < L), p, L)
            return counts.at[p, c].add(1), wsum.at[p, c].add(w)

        _SCATTER_W_JIT = _scatter_w
    return _SCATTER_W_JIT(p, c, w, L=ref_len)


def pileup(
    records: list[dict], ref_len: int, device: bool = True
) -> np.ndarray:
    """(ref_len, 5) base/deletion counts from SAM-normalized records.

    All records must target the same contig (group by ``rname``
    upstream; :func:`call_reads` does). Use :func:`pileup_full` to
    also get the insertion-evidence map.
    """
    return pileup_full(records, ref_len, device=device)[0]


def pileup_full(
    records: list[dict], ref_len: int, device: bool = True
) -> tuple[np.ndarray, dict]:
    """(counts, insertions) — see :func:`pileup` / `_expand_records`."""
    positions, codes, _, insertions, _ = _expand_records(records)
    if device:
        import jax.numpy as jnp

        counts = np.asarray(
            _scatter_device(
                jnp.asarray(positions, jnp.int32),
                jnp.asarray(codes, jnp.int32),
                ref_len=ref_len,
            )
        )
        if counts[ref_len].any():
            raise AssertionError(
                "pileup positions outside the reference "
                f"({int(counts[ref_len].sum())} bases)"
            )
        return counts[:ref_len], insertions
    counts = np.zeros((ref_len, 5), dtype=np.int32)
    if len(positions):
        if positions.min() < 0 or positions.max() >= ref_len:
            raise AssertionError(
                "pileup positions outside the reference"
            )
        np.add.at(counts, (positions, codes), 1)
    return counts, insertions


def pileup_q(
    records: list[dict],
    ref_len: int,
    device: bool = True,
    min_baseq: int = 0,
    min_mapq: int = 0,
) -> tuple[np.ndarray, np.ndarray, dict, dict]:
    """Quality-aware pileup: (counts, weights, insertions, ins_w).

    ``counts`` is the integer coverage surviving the gates; ``weights``
    sums each vote's correctness probability (module docstring);
    ``ins_w`` mirrors ``insertions`` with weighted support.
    """
    positions, codes, w, insertions, ins_w = _expand_records(
        records,
        min_baseq=min_baseq,
        min_mapq=min_mapq,
        collect_weights=True,
    )
    if device:
        import jax.numpy as jnp

        counts, wsum = _scatter_device_w(
            jnp.asarray(positions, jnp.int32),
            jnp.asarray(codes, jnp.int32),
            jnp.asarray(w, jnp.float32),
            ref_len=ref_len,
        )
        counts, wsum = np.asarray(counts), np.asarray(wsum)
        if counts[ref_len].any():
            raise AssertionError(
                "pileup positions outside the reference "
                f"({int(counts[ref_len].sum())} bases)"
            )
        return counts[:ref_len], wsum[:ref_len], insertions, ins_w
    counts = np.zeros((ref_len, 5), dtype=np.int32)
    wsum = np.zeros((ref_len, 5), dtype=np.float32)
    if len(positions):
        if positions.min() < 0 or positions.max() >= ref_len:
            raise AssertionError(
                "pileup positions outside the reference"
            )
        np.add.at(counts, (positions, codes), 1)
        np.add.at(wsum, (positions, codes), w)
    return counts, wsum, insertions, ins_w


def call_pileup(
    counts: np.ndarray,
    ref_seq: str,
    contig: str,
    min_depth: int = 8,
    min_frac: float = 0.7,
    weights: np.ndarray | None = None,
    min_alt_conf: float = 0.0,
) -> list[VariantCall]:
    """Consensus calls from a pileup (vectorized scan, then merge).

    With ``weights`` (a :func:`pileup_q` weight matrix) the alt
    selection and the ``min_frac`` gate run on weighted evidence; the
    ``min_depth`` gate and the reported DP/AC stay integer coverage.

    ``min_alt_conf`` (weighted mode): minimum MEAN weight of the
    alt-supporting bases (weighted support / head count). A site whose
    alt evidence comes entirely from ambiguously-placed reads (MAPQ
    ties weigh 0.5) averages ~0.5-0.65; confidently-mapped high-
    quality support averages ~1.0 — the gate separates repeat-shadow
    artifacts from real variants without hard-dropping ambiguous
    reads from the depth.
    """
    L = len(ref_seq)
    ref_codes = _CODE[
        np.frombuffer(ref_seq.encode("latin-1"), dtype=np.uint8)
    ].astype(np.int32)
    depth = counts.sum(axis=1)
    # Mask the reference code's own votes, then take the best alt.
    evidence = counts if weights is None else weights
    masked = evidence.copy()
    rows = np.arange(L)
    valid_ref = ref_codes >= 0
    masked[rows[valid_ref], ref_codes[valid_ref]] = -1
    alt_code = masked.argmax(axis=1)
    alt_evidence = masked[rows, alt_code]
    alt_count = counts[rows, alt_code]
    ev_depth = evidence.sum(axis=1)
    callable_ = (
        (depth >= min_depth)
        & (alt_evidence.astype(np.float64) >= min_frac * ev_depth)
        & (alt_count > 0)
        & valid_ref
    )
    if weights is not None and min_alt_conf > 0:
        callable_ &= alt_evidence >= min_alt_conf * np.maximum(
            alt_count, 1
        )
    calls: list[VariantCall] = []
    for p in np.flatnonzero(callable_):
        code = int(alt_code[p])
        if code == DEL_CODE:
            # Merge into an open adjacent deletion run.
            if (
                calls
                and calls[-1].is_deletion
                and calls[-1].pos + len(calls[-1].ref) - 1 == p
            ):
                prev = calls[-1]
                # DP/AC of a merged run report the WEAKEST position:
                # max() would overstate support for a base that barely
                # cleared min_frac (ADVICE r3).
                calls[-1] = VariantCall(
                    contig,
                    prev.pos,
                    prev.ref + ref_seq[p],
                    "",
                    min(prev.depth, int(depth[p])),
                    min(prev.alt_count, int(alt_count[p])),
                )
            else:
                calls.append(
                    VariantCall(
                        contig,
                        int(p) + 1,
                        ref_seq[p],
                        "",
                        int(depth[p]),
                        int(alt_count[p]),
                    )
                )
        else:
            calls.append(
                VariantCall(
                    contig,
                    int(p) + 1,
                    ref_seq[p],
                    _BASES[code],
                    int(depth[p]),
                    int(alt_count[p]),
                )
            )
    return calls


def call_insertions(
    insertions: dict,
    counts: np.ndarray,
    ref_seq: str,
    contig: str,
    min_depth: int = 8,
    min_frac: float = 0.7,
    ins_w: dict | None = None,
    weights: np.ndarray | None = None,
) -> list[VariantCall]:
    """Consensus insertion calls from the pileup's insertion map.

    An insertion anchors on the reference base it follows; its local
    depth is that anchor's pileup depth (reads spanning the junction
    without the insert vote against it implicitly by being counted in
    the depth but not in the event). The majority inserted string at
    an anchor is called when it clears the same depth/fraction gates
    as SNPs. ``VariantCall.ref`` is the anchor base and ``alt`` the
    anchor + inserted run — already in VCF shape.
    """
    if (ins_w is None) != (weights is None):
        # The weighted support (ins_w) only makes sense against the
        # weighted depth (weights) — one without the other would
        # either crash or silently mix evidence scales.
        raise ValueError(
            "call_insertions needs ins_w and weights together "
            "(both from pileup_q) or neither"
        )
    calls: list[VariantCall] = []
    for anchor in sorted(insertions):
        bucket = insertions[anchor]
        # With weighted evidence the majority string and the fraction
        # gate use weighted support vs the anchor's weighted depth;
        # min_depth and the reported DP/AC stay integer coverage.
        wbucket = ins_w.get(anchor, {}) if ins_w is not None else None
        if wbucket:
            ins, ev_support = max(
                wbucket.items(), key=lambda kv: (kv[1], kv[0])
            )
            ev_depth = float(weights[anchor].sum())
        else:
            ins, ev_support = max(
                bucket.items(), key=lambda kv: (kv[1], kv[0])
            )
            ev_depth = float(counts[anchor].sum())
        support = bucket[ins]
        depth = int(counts[anchor].sum())
        if depth < min_depth or ev_support < min_frac * ev_depth:
            continue
        calls.append(
            VariantCall(
                contig,
                anchor + 1,
                ref_seq[anchor],
                ref_seq[anchor] + ins,
                depth,
                int(support),
            )
        )
    return calls


def call_reads(
    queries,
    refs,
    scores,
    min_depth: int = 8,
    min_frac: float = 0.7,
    device_pileup: bool = True,
    min_baseq: int = 0,
    min_mapq: int = 0,
    weighted: bool = False,
    min_alt_conf: float = 0.0,
    **map_kw,
) -> tuple[list[VariantCall], dict[str, np.ndarray]]:
    """map -> pileup -> call. Returns (calls, per-contig pileups).

    ``map_kw`` flows to :func:`models.mapper.map_reads` (band,
    min_seeds, engine, ...). ``weighted`` (or a nonzero
    ``min_baseq``/``min_mapq``/``min_alt_conf`` — the confidence gate
    is defined on weighted evidence, so asking for it implies the
    quality pileup) switches to the quality-aware path:
    per-base/mapping gates, then Phred*MAPQ-weighted consensus
    (:func:`pileup_q`).
    """
    from genomics_rs_tpu.models.mapper import map_reads
    from genomics_rs_tpu.models.reads import _sam_token, sam_records

    results = map_reads(queries, refs, scores, **map_kw)
    records = sam_records(
        [r.contig for r in results],
        [r.aligned for r in results],
        [r.cigar for r in results],
        [r.mapinfo for r in results],
        [r.strand for r in results],
        mapqs=[r.mapq for r in results],
    )
    by_contig: dict[str, list[dict]] = {}
    # Keyed by the same SAM token the records carry (handles empty /
    # whitespace-only names the way the SAM writer does).
    contig_seq = {_sam_token(r.name): r.sequence for r in refs}
    for rec in records:
        if rec["mapped"]:
            by_contig.setdefault(rec["rname"], []).append(rec)
    calls: list[VariantCall] = []
    pileups: dict[str, np.ndarray] = {}
    # min_alt_conf gates on the weighted evidence, so asking for it
    # must turn the quality pileup on — otherwise the flag would be a
    # silent no-op (counting mode has no weights to gate).
    use_q = (
        weighted or min_baseq > 0 or min_mapq > 0 or min_alt_conf > 0
    )
    for rname in sorted(by_contig):
        seq = contig_seq[rname]
        if use_q:
            counts, wsum, insertions, ins_w = pileup_q(
                by_contig[rname], len(seq), device=device_pileup,
                min_baseq=min_baseq, min_mapq=min_mapq,
            )
        else:
            counts, insertions = pileup_full(
                by_contig[rname], len(seq), device=device_pileup
            )
            wsum = ins_w = None
        pileups[rname] = counts
        contig_calls = call_pileup(
            counts, seq, rname,
            min_depth=min_depth, min_frac=min_frac, weights=wsum,
            min_alt_conf=min_alt_conf,
        ) + call_insertions(
            insertions, counts, seq, rname,
            min_depth=min_depth, min_frac=min_frac,
            ins_w=ins_w, weights=wsum,
        )
        contig_calls.sort(key=lambda c: c.pos)
        calls.extend(contig_calls)
    log.info(
        "called %d variants from %d mapped reads",
        len(calls),
        sum(len(v) for v in by_contig.values()),
    )
    return calls, pileups


def write_vcf(path: str, calls: list[VariantCall], refs) -> None:
    """Minimal VCF 4.2: SNPs as REF/ALT bases, deletions anchored.

    Deletions normally anchor on the base BEFORE the event
    (POS = pos - 1, REF = anchor + deleted run, ALT = anchor); a
    deletion starting at reference position 1 has no preceding base,
    so per the VCF spec it anchors on the base AFTER the run instead.
    """
    from genomics_rs_tpu.models.reads import _sam_token

    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(
            '##INFO=<ID=DP,Number=1,Type=Integer,'
            'Description="Pileup depth">\n'
        )
        f.write(
            '##INFO=<ID=AC,Number=1,Type=Integer,'
            'Description="Alt-supporting bases">\n'
        )
        for r in refs:
            f.write(
                f"##contig=<ID={_sam_token(r.name)},length={len(r)}>\n"
            )
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        contig_seq = {_sam_token(r.name): r.sequence for r in refs}
        for c in calls:
            if c.is_deletion:
                seq = contig_seq[c.contig]
                if c.pos >= 2:
                    anchor = seq[c.pos - 2]
                    pos, ref, alt = c.pos - 1, anchor + c.ref, anchor
                elif c.pos + len(c.ref) - 1 < len(seq):
                    # Whole-prefix deletion: anchor on the base after.
                    anchor = seq[c.pos + len(c.ref) - 1]
                    pos, ref, alt = c.pos, c.ref + anchor, anchor
                else:
                    log.warning(
                        "deletion of the entire contig %s is not "
                        "representable in VCF; skipped", c.contig,
                    )
                    continue
            else:
                pos, ref, alt = c.pos, c.ref, c.alt
            f.write(
                f"{c.contig}\t{pos}\t.\t{ref}\t{alt}\t.\tPASS\t"
                f"DP={c.depth};AC={c.alt_count}\n"
            )
