"""Command-line interface.

Subcommand parity with the reference CLI
(``/root/reference/src/main.rs:27-84``):

  align       --alignment-type {local,global,1,0} --fasta-path FILE
  suffixtree  --alphabet-file FILE --suffix-links --stats --fasta-path FILE
  compare     --alphabet-file FILE --fasta-dir DIR --suffix-links --threads N

plus the global ``--config-path`` (default ``config.toml``) and
extensions (``--engine``, more subcommands). ``is_local`` is
true iff the flag is exactly "local" or "1" (``main.rs:142``).

Deviations (documented): the BWT output directory is created if
missing (the reference requires a pre-existing ``BWT_out/`` —
``main.rs:199-204``); compare loads FASTA files in sorted order (the
reference uses OS directory order).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from genomics_rs_tpu.ops.engine import ENGINE_CHOICES

BANNER = r"""
        GENOMICS-RS-TPU
        -. .-.   .-. .-.   .-. .-.   .
        ||\|||\ /|||\|||\ /|||\|||\ /|
        |/ \|||\|||/ \|||\|||/ \|||\||
        ~   `-~ `-`   `-~ `-`   `-~ `-
"""


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genomics-rs-tpu",
        description="Accelerated FASTA alignment (Smith-Waterman / Needleman-Wunsch), "
        "suffix trees + BWT, and all-pairs genome comparison",
    )
    p.add_argument("-c", "--config-path", default="config.toml")
    sub = p.add_subparsers(dest="mode", required=True)

    a = sub.add_parser("align", help="pairwise alignment of two FASTA sequences")
    a.add_argument("-a", "--alignment-type", default="local")
    a.add_argument("-f", "--fasta-path", required=True)
    a.add_argument("--engine", default="auto", choices=ENGINE_CHOICES)
    a.add_argument(
        "--matrix",
        default=None,
        help="full substitution matrix: a built-in name (BLOSUM62) or "
        "an NCBI-format file — protein alignment; gap costs still "
        "come from the config's g/h",
    )
    a.add_argument(
        "-o",
        "--output",
        default=None,
        help="also write the alignment as a 2-sequence gapped FASTA "
        "(local mode: the aligned region, its span in the headers)",
    )

    s = sub.add_parser("suffixtree", help="suffix tree stats + BWT")
    s.add_argument("-a", "--alphabet-file", required=True)
    s.add_argument("--suffix-links", action="store_true")
    s.add_argument("--stats", action="store_true")
    s.add_argument("-f", "--fasta-path", required=True)

    c = sub.add_parser("compare", help="all-pairs similarity matrix over a FASTA dir")
    c.add_argument("-a", "--alphabet-file", required=True)
    c.add_argument("-f", "--fasta-dir", required=True)
    c.add_argument("--suffix-links", action="store_true")
    c.add_argument("--threads", type=int, default=1)

    rd = sub.add_parser(
        "reads",
        help="batch-score read pairs: query[i] vs ref[i] from two "
        "FASTA/FASTQ files, auto-detected (extension: batched device "
        "fills)",
    )
    rd.add_argument("-q", "--queries", required=True)
    rd.add_argument("-r", "--refs", required=True)
    rd.add_argument("-a", "--alignment-type", default="local")
    rd.add_argument("--engine", default="auto", choices=ENGINE_CHOICES)
    rd.add_argument(
        "--align",
        action="store_true",
        help="full per-read alignments (stats + CIGAR columns) instead "
        "of score-only",
    )
    rd.add_argument(
        "--both-strands",
        action="store_true",
        help="also align each query's reverse complement and keep the "
        "better orientation (adds a strand column; forward wins ties; "
        "a '-' row's query coordinates — end_i, paths, CIGARs — are "
        "those of the reverse-complemented read, read-mapper style)",
    )
    rd.add_argument(
        "--format",
        choices=["tsv", "sam"],
        default="tsv",
        help="output format for --align: per-read TSV (default) or "
        "SAM 1.6 with soft-clipped CIGARs",
    )
    rd.add_argument("-o", "--output", default="read_scores.tsv")

    mp = sub.add_parser(
        "map",
        help="seed-and-extend read mapping against one reference "
        "(extension: host k-mer index + diagonal voting, batched "
        "device extension)",
    )
    mp.add_argument("-q", "--queries", required=True)
    mp.add_argument(
        "-2", "--queries2", default=None,
        help="mate file for paired-end mapping (record i pairs with "
        "record i of -q); SAM gains pair flags, RNEXT/PNEXT/TLEN",
    )
    mp.add_argument(
        "--max-insert", type=int, default=1000,
        help="max outer distance for a proper pair (paired-end only)",
    )
    mp.add_argument("-r", "--ref", required=True)
    mp.add_argument("-k", type=int, default=21, help="seed k-mer size")
    mp.add_argument(
        "--band", type=int, default=32,
        help="diagonal vote band / extension window slack (bases); "
        "windows are read_len + 4*band wide",
    )
    mp.add_argument(
        "--stride", type=int, default=None,
        help="sample every stride-th read k-mer as a seed (default k//2)",
    )
    mp.add_argument(
        "--max-hits", type=int, default=64,
        help="skip seeds with more reference hits than this (repeats)",
    )
    mp.add_argument(
        "--min-seeds", type=int, default=2,
        help="vote threshold below which a read is unmapped",
    )
    mp.add_argument(
        "--single-strand", action="store_true",
        help="map the forward orientation only",
    )
    mp.add_argument("--engine", default="auto", choices=ENGINE_CHOICES)
    mp.add_argument(
        "--seed-engine", default="host", choices=["host", "device"],
        help="where diagonal voting runs; device needs -k <= 15 "
        "(int32 packed keys) and is bit-identical to host",
    )
    mp.add_argument("--format", choices=["sam", "tsv"], default="sam")
    mp.add_argument("-o", "--output", default="mapped.sam")

    cl = sub.add_parser(
        "call",
        help="variant calling: map reads, pile up on device, call "
        "consensus SNPs/deletions (extension: map -> pileup -> "
        "call)",
    )
    cl.add_argument("-q", "--queries", required=True)
    cl.add_argument("-r", "--ref", required=True)
    cl.add_argument("-k", type=int, default=21, help="seed k-mer size")
    cl.add_argument("--band", type=int, default=32)
    cl.add_argument("--min-seeds", type=int, default=2)
    cl.add_argument(
        "--min-depth", type=int, default=8,
        help="minimum pileup depth to consider a position",
    )
    cl.add_argument(
        "--min-frac", type=float, default=0.7,
        help="minimum alt-supporting fraction of the depth",
    )
    cl.add_argument(
        "--min-baseq", type=int, default=0,
        help="drop M/X/= bases below this Phred quality (FASTQ "
        "inputs; implies quality-weighted consensus)",
    )
    cl.add_argument(
        "--min-mapq", type=int, default=0,
        help="drop reads below this mapping quality (implies "
        "quality-weighted consensus)",
    )
    cl.add_argument(
        "--min-alt-conf", type=float, default=0.0,
        help="minimum mean weight of alt-supporting bases: filters "
        "calls supported only by ambiguously-mapped reads (implies "
        "the quality-weighted pileup)",
    )
    cl.add_argument(
        "--weighted", action="store_true",
        help="weight votes by Phred*MAPQ correctness probability "
        "instead of counting heads",
    )
    cl.add_argument(
        "--single-strand", action="store_true",
        help="map the forward orientation only",
    )
    cl.add_argument("--engine", default="auto", choices=ENGINE_CHOICES)
    cl.add_argument("-o", "--output", default="calls.vcf")

    se = sub.add_parser(
        "search",
        help="FM-index substring search: count/locate every query in "
        "a reference (extension: device suffix array build + "
        "batched backward search)",
    )
    se.add_argument("-r", "--ref", required=True, help="reference FASTA")
    se.add_argument(
        "-q", "--queries", required=True,
        help="query patterns, FASTA or FASTQ (auto-detected)",
    )
    se.add_argument(
        "--locate", action="store_true",
        help="also report every match position (comma-separated)",
    )
    se.add_argument(
        "--engine", default="device", choices=["device", "host"],
        help="where the batched backward search runs",
    )
    se.add_argument("-o", "--output", default="search_hits.tsv")

    ms = sub.add_parser(
        "msa",
        help="multiple sequence alignment (extension: center-star "
        "over the device aligner)",
    )
    ms.add_argument(
        "-f",
        "--fasta-path",
        required=True,
        nargs="+",
        help="FASTA file(s) or a directory of .fasta files; all "
        "sequences found are aligned together",
    )
    ms.add_argument("--engine", default="auto", choices=ENGINE_CHOICES)
    ms.add_argument(
        "--matrix",
        default=None,
        help="full substitution matrix (BLOSUM62 or an NCBI-format "
        "file): protein MSA; gap costs from the config's g/h",
    )
    ms.add_argument(
        "--format", choices=["clustal", "fasta"], default="clustal"
    )
    ms.add_argument(
        "-o",
        "--output",
        default=None,
        help="write the alignment here as well (format follows "
        "--format); stdout always gets the clustal rendering",
    )

    am = sub.add_parser(
        "align-matrix",
        help="all-pairs DP alignment-score matrix over a FASTA dir "
        "(extension: the DP-scored counterpart of compare)",
    )
    am.add_argument("-f", "--fasta-dir", required=True)
    am.add_argument("-a", "--alignment-type", default="global")
    am.add_argument("--engine", default="auto", choices=ENGINE_CHOICES)
    am.add_argument("-o", "--output", default="alignment_scores.tsv")
    am.add_argument(
        "--alignments-out",
        default=None,
        help="also write every pair's FULL alignment (i < j) as a "
        "2-sequence gapped FASTA in this directory (align_batch)",
    )
    am.add_argument(
        "--matrix",
        default=None,
        help="score under a full substitution matrix (built-in name "
        "like BLOSUM62 or an NCBI-format file): protein all-vs-all; "
        "gap costs still come from the config's g/h",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    """CLI entry. Each invocation is one job: the device-operand cache
    is dropped on the way out so in-process callers (tests, notebooks)
    that run many subcommands over unrelated corpora don't accumulate
    stale device residents (``utils/devcache``)."""
    from genomics_rs_tpu.utils import devcache

    try:
        return _main(argv)
    finally:
        devcache.clear()


def _main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)

    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("genomics_rs_tpu")
    print(f"\x1b[94m{BANNER}\x1b[0m")

    from genomics_rs_tpu.config import get_config
    from genomics_rs_tpu.sequence import SequenceContainer
    from genomics_rs_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    config = get_config(args.config_path)

    if args.mode == "align":
        log.info("MODE: Alignment")
        container = SequenceContainer().from_fasta(args.fasta_path)
        sc = config.scores
        log.info("Using the following values for scoring:")
        log.info("Match: %d", sc.s_match)
        log.info("Mismatch: %d", sc.s_mismatch)
        log.info("Gap: %d", sc.g)
        log.info("Opening Gap: %d", sc.h)
        if sc.s_transition is not None:
            log.info("Transition: %d", sc.s_transition)
        is_local = args.alignment_type in ("local", "1")
        log.info("Alignment Type: %s", args.alignment_type)

        from genomics_rs_tpu.display.alignment import (
            format_aligned_sequences,
            print_alignment_tables,
        )
        from genomics_rs_tpu.models.aligner import align_pair

        from genomics_rs_tpu.utils.profiling import trace

        matrix = None
        if args.matrix:
            from genomics_rs_tpu.ops.subst import get_matrix

            matrix = get_matrix(args.matrix)
            log.info(
                "Substitution matrix: %s (%d chars)",
                matrix.name or args.matrix,
                len(matrix.alphabet),
            )

        with trace("align"):
            aligned = align_pair(
                container,
                sc,
                is_local=is_local,
                engine=args.engine,
                matrix=matrix,
            )
        print_alignment_tables(aligned, sc, is_local, matrix=matrix)
        print(format_aligned_sequences(aligned))
        if args.output:
            from genomics_rs_tpu.models.msa import write_pair_fasta

            write_pair_fasta(args.output, aligned, is_local)
            print(f"wrote {args.output}")
        return 0

    if args.mode == "suffixtree":
        log.info("MODE: Suffix Tree")
        log.info("Suffix links: %s", args.suffix_links)
        container = SequenceContainer().from_fasta(args.fasta_path)
        seq = container.sequences[0].sequence

        from genomics_rs_tpu.suffixtree import make_tree
        from genomics_rs_tpu.suffixtree.tree import SuffixTree

        if len(seq) < 64:
            # Small trees use the Python implementation so the full
            # Display (Graphviz DOT for <100 nodes, main.rs:211 /
            # display.rs:43-48) is available.
            tree = SuffixTree(args.alphabet_file, len(seq))
        else:
            tree = make_tree(args.alphabet_file, len(seq))
        tree.insert_string(seq, args.suffix_links, True)

        if args.stats:
            tree.compute_stats(0)
            stem = os.path.basename(args.fasta_path).replace(".fasta", "")
            bwt_path = os.path.join("BWT_out", f"{stem}_bwt.txt")
            log.info("BWT Path: %s", bwt_path)
            os.makedirs("BWT_out", exist_ok=True)
            with open(bwt_path, "w") as f:
                for ch in tree.stats.bwt:
                    f.write(ch + "\n")

            from genomics_rs_tpu.display.tree import (
                format_tree,
                format_tree_stats,
            )

            if isinstance(tree, SuffixTree):
                # Full Display: Graphviz for <100 nodes + stats
                # (reference main.rs:211); LOG_LEVEL=DEBUG appends the
                # string-depth dump like RUST_LOG=debug
                # (display.rs:50-52).
                debug = (
                    os.environ.get("LOG_LEVEL", "INFO").upper() == "DEBUG"
                )
                print(format_tree(tree, debug=debug))
            else:
                print(format_tree_stats(tree.stats))
        return 0

    if args.mode == "compare":
        log.info("MODE: Compare")
        log.info("Alphabet file: %s", args.alphabet_file)
        log.info("Suffix links: %s", args.suffix_links)
        log.info("FASTA directory: %s", args.fasta_dir)

        from genomics_rs_tpu.comparison.display import print_similarity_matrix
        from genomics_rs_tpu.comparison.driver import (
            compare_all_pairs,
            load_fasta_dir,
            write_similarity_tsv,
        )

        container = load_fasta_dir(args.fasta_dir)
        log.info("Number of sequences: %d", len(container.sequences))
        result = compare_all_pairs(container, args.alphabet_file, threads=args.threads)
        print_similarity_matrix(result.matrix)
        tsv = write_similarity_tsv(result)
        print("Similarity TSV:")
        print(tsv)
        print("\nLCS Length TSV:")
        num = len(result.names)
        print(" \t" + "\t".join(str(i) for i in range(num)) + "\t")
        for j in range(num):
            print(
                f"{j}\t"
                + "\t".join(str(int(result.matrix[j, i, 3])) for i in range(num))
                + "\t"
            )
        return 0

    if args.mode == "reads":
        log.info("MODE: Reads (batch pair scoring)")
        import numpy as np

        from genomics_rs_tpu.parallel.batch import score_pairs
        from genomics_rs_tpu.sequence import PAD_S1, PAD_S2

        queries = SequenceContainer().from_reads(args.queries).sequences
        refs = SequenceContainer().from_reads(args.refs).sequences
        if len(refs) == 1 and len(queries) > 1:
            # Mapper convention: every read against the one reference.
            log.info(
                "one reference for %d reads: broadcasting", len(queries)
            )
            refs = refs * len(queries)
        if len(queries) != len(refs):
            log.error(
                "query/ref count mismatch: %d vs %d", len(queries), len(refs)
            )
            return 1
        is_local = args.alignment_type in ("local", "1")
        B = len(queries)
        if args.format == "sam" and not args.align:
            log.error("--format sam requires --align (per-read CIGARs)")
            return 1
        if args.align:
            import time

            from genomics_rs_tpu.models.reads import align_reads

            want_sam = args.format == "sam"
            t0 = time.perf_counter()
            res = align_reads(
                queries, refs, config.scores, is_local=is_local,
                engine=args.engine, with_paths=False, with_cigars=True,
                both_strands=args.both_strands, with_mapinfo=want_sam,
            )
            aligned, cigars = res[0], res[1]
            strands = res[2] if args.both_strands else None
            mapinfo = res[-1] if want_sam else None
            dt = time.perf_counter() - t0
            print(f"{B} reads aligned in {dt:.3f}s")
            if want_sam:
                from genomics_rs_tpu.models.reads import write_sam

                write_sam(
                    args.output, refs, aligned, cigars, mapinfo, strands
                )
                print(f"wrote {args.output}")
                return 0
            with open(args.output, "w") as f:
                strand_col = "\tstrand" if strands is not None else ""
                f.write(
                    "query\tref\tscore\tmatches\tmismatches\t"
                    f"gap_extensions\topening_gaps\tcigar{strand_col}\n"
                )
                for k, (q, r, a, cg) in enumerate(
                    zip(queries, refs, aligned, cigars)
                ):
                    tail = f"\t{strands[k]}" if strands is not None else ""
                    f.write(
                        f"{q.name}\t{r.name}\t{a.score}\t{a.matches}\t"
                        f"{a.mismatches}\t{a.gap_extensions}\t"
                        f"{a.opening_gaps}\t{cg}{tail}\n"
                    )
            print(f"wrote {args.output}")
            return 0
        sq = list(queries)
        if args.both_strands:
            # Forward rows then revcomp rows, ONE scoring dispatch.
            sq = sq + [q.reverse_complement() for q in sq]
        sr = refs * 2 if args.both_strands else refs
        L1 = max(max(len(s) for s in sq), 1)
        L2 = max(max(len(s) for s in sr), 1)
        L1 = -(-L1 // 128) * 128
        L2 = -(-L2 // 128) * 128
        from genomics_rs_tpu.models.reads import encode_batch

        s1b = encode_batch(sq, L1, PAD_S1)
        s2b = encode_batch(sr, L2, PAD_S2)
        ms = np.array([len(s) for s in sq], dtype=np.int32)
        ns = np.array([len(s) for s in sr], dtype=np.int32)

        import time

        t0 = time.perf_counter()
        sc, si, sj = score_pairs(
            s1b, s2b, ms, ns, config.scores, is_local, engine=args.engine
        )
        sc, si, sj = (np.asarray(x) for x in (sc, si, sj))
        dt = time.perf_counter() - t0
        cells = float(np.sum((ms + 1.0) * (ns + 1.0)))
        # len(ms), not B: with --both-strands the dispatch holds 2B
        # oriented pairs and the cell count/rate covers all of them.
        print(
            f"{len(ms)} pairs, {cells:.3g} DP cells in {dt:.3f}s "
            f"({cells / dt:.3g} cells/s)"
        )
        if args.both_strands:
            use_rc = sc[B:] > sc[:B]  # forward wins ties
            pick = np.where(use_rc, np.arange(B) + B, np.arange(B))
            sc, si, sj = sc[pick], si[pick], sj[pick]
        with open(args.output, "w") as f:
            strand_col = "\tstrand" if args.both_strands else ""
            f.write(f"query\tref\tscore\tend_i\tend_j{strand_col}\n")
            for k in range(B):
                tail = (
                    "\t" + ("-" if use_rc[k] else "+")
                    if args.both_strands
                    else ""
                )
                f.write(
                    f"{queries[k].name}\t{refs[k].name}\t{int(sc[k])}\t"
                    f"{int(si[k])}\t{int(sj[k])}{tail}\n"
                )
        print(f"wrote {args.output}")
        return 0

    if args.mode == "map":
        import time

        log.info("MODE: Map (seed-and-extend read mapping)")
        from genomics_rs_tpu.models.mapper import KmerIndex, map_reads
        from genomics_rs_tpu.models.reads import write_sam

        queries = SequenceContainer().from_reads(args.queries).sequences
        refs = SequenceContainer().from_reads(args.ref).sequences
        if not queries or not refs:
            log.error("no reads or no reference loaded")
            return 1
        t0 = time.perf_counter()
        try:
            index = KmerIndex(refs, args.k)
            if args.seed_engine == "device":
                index.device_arrays()  # validate k/size up front
        except ValueError as e:
            log.error("%s", e)
            return 1
        t_index = time.perf_counter() - t0
        kw = dict(
            index=index,
            stride=args.stride,
            band=args.band,
            max_hits=args.max_hits,
            min_seeds=args.min_seeds,
            both_strands=not args.single_strand,
            engine=args.engine,
            seed_engine=args.seed_engine,
        )
        if args.queries2 is not None:
            from genomics_rs_tpu.models.mapper import (
                map_pairs,
                write_sam_paired,
            )

            mates = SequenceContainer().from_reads(args.queries2).sequences
            if len(mates) != len(queries):
                log.error(
                    "mate count mismatch: %d vs %d",
                    len(queries), len(mates),
                )
                return 1
            if args.format != "sam":
                log.error("paired-end mapping writes SAM (--format sam)")
                return 1
            t0 = time.perf_counter()
            try:
                res1, res2 = map_pairs(
                    queries, mates, refs, config.scores, **kw
                )
            except ValueError as e:
                log.error("%s", e)
                return 1
            t_map = time.perf_counter() - t0
            n_mapped = sum(r.mapped for r in res1 + res2)
            proper = write_sam_paired(
                args.output, res1, res2, header_refs=refs,
                max_insert=args.max_insert,
            )
            print(
                f"{n_mapped}/{2 * len(res1)} ends mapped, "
                f"{proper}/{len(res1)} proper pairs in {t_map:.3f}s "
                f"(index {len(index)} {args.k}-mers in {t_index:.3f}s)"
            )
            print(f"wrote {args.output}")
            return 0
        t0 = time.perf_counter()
        try:
            results = map_reads(queries, refs, config.scores, **kw)
        except ValueError as e:
            log.error("%s", e)
            return 1
        t_map = time.perf_counter() - t0
        n_mapped = sum(r.mapped for r in results)
        print(
            f"{n_mapped}/{len(results)} reads mapped in {t_map:.3f}s "
            f"(index {len(index)} {args.k}-mers in {t_index:.3f}s)"
        )
        if args.format == "sam":
            write_sam(
                args.output,
                [r.contig for r in results],
                [r.aligned for r in results],
                [r.cigar for r in results],
                [r.mapinfo for r in results],
                [r.strand for r in results],
                header_refs=refs,
                mapqs=[r.mapq for r in results],
            )
        else:
            from genomics_rs_tpu.models.reads import sam_records

            # Fold edge zero-plateau runs exactly like the SAM writer
            # so both output formats report the same position.
            recs = sam_records(
                [r.contig for r in results],
                [r.aligned for r in results],
                [r.cigar for r in results],
                [r.mapinfo for r in results],
                [r.strand for r in results],
            )
            with open(args.output, "w") as f:
                f.write(
                    "query\tref\tstrand\tmapped\tpos\tscore\tmapq\t"
                    "seeds\tcigar\n"
                )
                for r, rec in zip(results, recs):
                    rname = r.contig.name if r.mapped else "*"
                    f.write(
                        f"{r.read.name}\t{rname}\t{r.strand}\t"
                        f"{int(r.mapped)}\t{rec['pos']}\t{r.score}\t"
                        f"{r.mapq}\t{r.seeds}\t{r.cigar}\n"
                    )
        print(f"wrote {args.output}")
        return 0

    if args.mode == "call":
        import time

        log.info("MODE: Call (map -> pileup -> consensus variants)")
        from genomics_rs_tpu.models.caller import call_reads, write_vcf

        queries = SequenceContainer().from_reads(args.queries).sequences
        refs = SequenceContainer().from_reads(args.ref).sequences
        if not queries or not refs:
            log.error("no reads or no reference loaded")
            return 1
        t0 = time.perf_counter()
        try:
            calls, pileups = call_reads(
                queries, refs, config.scores,
                min_depth=args.min_depth, min_frac=args.min_frac,
                min_baseq=args.min_baseq, min_mapq=args.min_mapq,
                weighted=args.weighted, min_alt_conf=args.min_alt_conf,
                k=args.k, band=args.band, min_seeds=args.min_seeds,
                both_strands=not args.single_strand,
                engine=args.engine,
            )
        except ValueError as e:
            log.error("%s", e)
            return 1
        dt = time.perf_counter() - t0
        write_vcf(args.output, calls, refs)
        covered = sum(
            int((p.sum(axis=1) > 0).sum()) for p in pileups.values()
        )
        print(
            f"{len(calls)} variants from {len(queries)} reads "
            f"({covered} reference positions covered) in {dt:.3f}s"
        )
        print(f"wrote {args.output}")
        return 0

    if args.mode == "search":
        import time

        log.info("MODE: Search (FM-index substring queries)")
        from genomics_rs_tpu.suffixtree.fmindex import MultiFMIndex

        refs = SequenceContainer().from_fasta(args.ref).sequences
        queries = SequenceContainer().from_reads(args.queries).sequences
        if not refs or not queries:
            log.error("no reference or no queries loaded")
            return 1
        t0 = time.perf_counter()
        index = MultiFMIndex.build(refs)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        counts, ranges = index.search_batch(
            [q.sequence for q in queries],
            device=args.engine == "device",
        )
        t_search = time.perf_counter() - t0
        multi = len(refs) > 1
        from genomics_rs_tpu.models.reads import _sam_token

        with open(args.output, "w") as f:
            pos_col = "\tpositions" if args.locate else ""
            f.write(f"query\tcount{pos_col}\n")
            for q, c, rng in zip(queries, counts, ranges):
                tail = ""
                if args.locate:
                    # The batch search already produced the SA range;
                    # locating is a pure slice + offset mapping.
                    hits = index.locate_range(rng)
                    tail = "\t" + ",".join(
                        f"{_sam_token(name)}:{off}" if multi else str(off)
                        for name, off in hits
                    )
                f.write(f"{q.name}\t{int(c)}{tail}\n")
        print(
            f"indexed {int(index.lengths.sum())} bases "
            f"({len(refs)} contigs) in {t_build:.3f}s; "
            f"{len(queries)} queries in {t_search:.3f}s "
            f"({sum(int(c) for c in counts)} total hits)"
        )
        print(f"wrote {args.output}")
        return 0

    if args.mode == "msa":
        log.info("MODE: MSA (center-star multiple alignment)")
        from genomics_rs_tpu.comparison.driver import load_fasta_dir
        from genomics_rs_tpu.models.msa import (
            center_star_msa,
            format_msa_clustal,
            write_msa_fasta,
        )

        container = SequenceContainer()
        for path in args.fasta_path:
            if os.path.isdir(path):
                for s in load_fasta_dir(path).sequences:
                    container.sequences.append(s)
            else:
                container.from_fasta(path)
        log.info("Number of sequences: %d", len(container.sequences))
        if len(container.sequences) < 2:
            log.error("msa needs at least two sequences")
            return 1
        msa_matrix = None
        if args.matrix:
            from genomics_rs_tpu.ops.subst import get_matrix

            msa_matrix = get_matrix(args.matrix)
            log.info(
                "Substitution matrix: %s (%d chars)",
                msa_matrix.name or args.matrix,
                len(msa_matrix.alphabet),
            )
        result = center_star_msa(
            container,
            config.scores,
            engine=args.engine,
            matrix=msa_matrix,
        )
        log.info(
            "center: %s, alignment width %d",
            result.names[result.center_index],
            result.width,
        )
        print(format_msa_clustal(result))
        if args.output:
            if args.format == "fasta":
                write_msa_fasta(result, args.output)
            else:
                with open(args.output, "w") as f:
                    f.write(format_msa_clustal(result) + "\n")
            print(f"wrote {args.output}")
        return 0

    if args.mode == "align-matrix":
        log.info("MODE: Align-Matrix (all-pairs DP scores)")
        from genomics_rs_tpu.comparison.driver import load_fasta_dir
        from genomics_rs_tpu.parallel.allpairs import (
            allpairs_scores,
            write_scores_tsv,
        )

        container = load_fasta_dir(args.fasta_dir)
        log.info("Number of sequences: %d", len(container.sequences))
        is_local = args.alignment_type in ("local", "1")
        mx = None
        if args.matrix:
            from genomics_rs_tpu.ops.subst import get_matrix
            from genomics_rs_tpu.parallel.allpairs import (
                allpairs_matrix_scores,
            )

            mx = get_matrix(args.matrix)
            log.info(
                "Substitution matrix: %s (%d chars)",
                mx.name or args.matrix,
                len(mx.alphabet),
            )
            result = allpairs_matrix_scores(
                container,
                mx,
                g=config.scores.g,
                h=config.scores.h,
                is_local=is_local,
            )
        else:
            result = allpairs_scores(
                container,
                config.scores,
                is_local=is_local,
                engine=args.engine,
            )
        print(
            f"{len(result.names)} sequences, {result.cells:.3g} DP cells "
            f"in {result.elapsed_s:.2f}s ({result.cells_per_s:.3g} cells/s)"
        )
        tsv = write_scores_tsv(result, args.output)
        print("Alignment score TSV:")
        print(tsv)
        if args.alignments_out:
            import re

            from genomics_rs_tpu.models.aligner import align_batch
            from genomics_rs_tpu.models.msa import write_pair_fasta

            os.makedirs(args.alignments_out, exist_ok=True)
            seqs = container.sequences
            idx = [
                (i, j)
                for j in range(len(seqs))
                for i in range(len(seqs))
                if i < j
            ]
            alns = dict(
                zip(
                    idx,
                    align_batch(
                        [(seqs[i], seqs[j]) for i, j in idx],
                        config.scores,
                        is_local=is_local,
                        engine=args.engine,
                        matrix=mx,
                    ),
                )
            )
            for i, j in idx:
                tag = re.sub(r"[^A-Za-z0-9._-]+", "_", seqs[i].name[:24])
                tag2 = re.sub(r"[^A-Za-z0-9._-]+", "_", seqs[j].name[:24])
                write_pair_fasta(
                    os.path.join(
                        args.alignments_out,
                        f"pair_{i}_{j}_{tag}_{tag2}.fasta",
                    ),
                    alns[(i, j)],
                    is_local,
                )
            print(
                f"wrote {len(alns)} pair alignments to "
                f"{args.alignments_out}"
            )
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
