"""Engine-name resolution: the one place a fill engine is chosen."""

import pytest

from genomics_rs_tpu.ops.engine import ENGINE_CHOICES, resolve_engine


@pytest.mark.parametrize("name,want", [("auto", "scan"), ("scan", "scan")])
def test_resolve_known(name, want):
    assert resolve_engine(name) == want


@pytest.mark.parametrize(
    "name", ["pallas", "shortread", "segmented", "stream", "stream8", ""]
)
def test_resolve_unknown_raises(name):
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine(name)


@pytest.mark.parametrize(
    "subcommand",
    [
        ["align", "-f", "x.fasta"],
        ["reads", "-q", "q.fa", "-r", "r.fa"],
        ["map", "-q", "q.fa", "-r", "r.fa"],
        ["call", "-q", "q.fa", "-r", "r.fa"],
        ["msa", "-f", "x.fasta"],
        ["align-matrix", "-f", "dir"],
    ],
    ids=lambda a: a[0],
)
def test_cli_engine_choices(subcommand):
    """Every --engine flag offers exactly the resolver's names and
    rejects a removed kernel name at parse time."""
    from genomics_rs_tpu.cli import _build_parser

    parser = _build_parser()
    for name in ENGINE_CHOICES:
        args = parser.parse_args(subcommand + ["--engine", name])
        assert resolve_engine(args.engine) == "scan"
    with pytest.raises(SystemExit):
        parser.parse_args(subcommand + ["--engine", "pallas"])


@pytest.mark.parametrize(
    "call",
    ["aligner", "align_batch", "score_pairs", "allpairs", "align_reads"],
)
def test_drivers_reject_unknown_engine(call):
    """Drivers resolve through the same function: an unknown name is
    an error, never a silent fallback."""
    import numpy as np

    from genomics_rs_tpu.config import Scores
    from genomics_rs_tpu.sequence import Sequence, SequenceContainer

    sc = Scores()
    a, b = Sequence("a", "ACGT"), Sequence("b", "ACGA")
    with pytest.raises(ValueError, match="unknown engine"):
        if call == "aligner":
            from genomics_rs_tpu.models.aligner import PairwiseAligner

            PairwiseAligner(sc, engine="pallas")
        elif call == "align_batch":
            from genomics_rs_tpu.models.aligner import align_batch

            align_batch([(a, b)], sc, engine="pallas")
        elif call == "score_pairs":
            from genomics_rs_tpu.parallel.batch import score_pairs

            z = np.zeros((1, 128), np.uint8)
            one = np.ones(1, np.int32)
            score_pairs(z, z, one, one, sc, engine="stream")
        elif call == "allpairs":
            from genomics_rs_tpu.parallel.allpairs import allpairs_scores

            allpairs_scores(
                SequenceContainer(sequences=[a, b]), sc, engine="pallas"
            )
        else:
            from genomics_rs_tpu.models.reads import align_reads

            align_reads([a], [b], sc, engine="shortread")
