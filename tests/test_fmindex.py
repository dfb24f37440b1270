"""FM-index tests (extension — the reference only prints the BWT).

The index must agree with brute force on counts and positions
(overlapping occurrences), the batch device search must be
bit-identical to the scalar host search, and the underlying BWT must
match the suffix-tree DFS BWT goldens.
"""

import numpy as np
import pytest

from conftest import reference_file
from genomics_rs_tpu.suffixtree.fmindex import FMIndex


def _naive_positions(text: str, pat: str) -> list[int]:
    if not pat:
        return list(range(len(text) + 1))
    out, start = [], 0
    while True:
        i = text.find(pat, start)
        if i < 0:
            return out
        out.append(i)
        start = i + 1


def test_banana_counts_and_positions():
    idx = FMIndex.build("BANANA")
    for pat in ["ANA", "NA", "BAN", "A", "BANANA", "Z", "NAB", ""]:
        want = _naive_positions("BANANA", pat)
        assert idx.count(pat) == len(want), pat
        got = idx.locate(pat)
        # '$' row: the empty pattern matches position 6 (terminator)
        # too — naive counts len+1 slots including past-the-end.
        assert sorted(got.tolist()) == want, pat


def test_bwt_matches_golden():
    idx = FMIndex.build("BANANA")
    assert idx.bwt.decode() == "ANNB$AA"


def test_fuzz_vs_naive():
    rng = np.random.default_rng(7)
    for _ in range(5):
        n = int(rng.integers(20, 200))
        text = "".join(rng.choice(list("ACGT"), n))
        idx = FMIndex.build(text)
        pats = []
        for _ in range(20):
            L = int(rng.integers(1, 8))
            if rng.random() < 0.7 and L <= n:
                start = int(rng.integers(0, n - L + 1))
                pats.append(text[start : start + L])
            else:
                pats.append("".join(rng.choice(list("ACGTN"), L)))
        for p in pats:
            want = _naive_positions(text, p)
            assert idx.count(p) == len(want), (text, p)
            assert idx.locate(p).tolist() == want, (text, p)
        # Batch device search == scalar host search.
        got_dev = idx.count_batch(pats, device=True)
        got_host = idx.count_batch(pats, device=False)
        want_all = [len(_naive_positions(text, p)) for p in pats]
        assert got_dev.tolist() == want_all
        assert got_host.tolist() == want_all


def test_batch_mixed_lengths_and_absent_chars():
    idx = FMIndex.build("ACGTACGTACGT")
    pats = ["ACGT", "", "T", "NNN", "GTA", "ACGTACGTACGT", "X"]
    counts = idx.count_batch(pats)
    assert counts.tolist() == [3, 13, 3, 0, 2, 1, 0]


def test_terminator_byte_rejected():
    with pytest.raises(ValueError):
        FMIndex.build("AC$GT")


def test_covid_kmers():
    """30 kb genome: index counts must match numpy brute force."""
    from genomics_rs_tpu.sequence import SequenceContainer

    path = reference_file("test_data", "Covid_Wuhan.fasta")
    seq = SequenceContainer().from_fasta(path).sequences[0].sequence
    _check_kmer_counts(seq)


def test_seeded_genome_kmers():
    """Seeded twin of ``test_covid_kmers``: a random genome of the
    same length."""
    rng = np.random.default_rng(29903)
    seq = (
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 29903)]
        .tobytes()
        .decode()
    )
    _check_kmer_counts(seq)


def _check_kmer_counts(seq: str):
    idx = FMIndex.build(seq)
    rng = np.random.default_rng(3)
    pats = []
    for _ in range(32):
        L = int(rng.integers(8, 40))
        start = int(rng.integers(0, len(seq) - L))
        pats.append(seq[start : start + L])
    pats += ["ACGTACGTACGTAATTT", "TTTTTTTTTT"]
    counts = idx.count_batch(pats)
    for p, c in zip(pats, counts):
        assert c == len(_naive_positions(seq, p)), p
        locs = idx.locate(p)
        assert len(locs) == c
        for pos in locs[:3]:
            assert seq[pos : pos + len(p)] == p


def test_search_cli(tmp_path):
    from genomics_rs_tpu.cli import main

    ref = tmp_path / "ref.fasta"
    ref.write_text(">r\nACGTACGTACGT\n")
    q = tmp_path / "q.fasta"
    q.write_text(">p1\nACGT\n>p2\nGTAC\n>p3\nTTTT\n")
    cfg = tmp_path / "config.toml"
    cfg.write_text(
        "[scores]\ns_match = 1\ns_mismatch = -2\ng = -2\nh = -5\n"
    )
    out = tmp_path / "hits.tsv"
    rc = main(
        [
            "-c", str(cfg), "search",
            "-r", str(ref), "-q", str(q),
            "--locate", "-o", str(out),
        ]
    )
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "query\tcount\tpositions"
    rows = {l.split("\t")[0]: l.split("\t") for l in lines[1:]}
    assert rows["p1"][1] == "3" and rows["p1"][2] == "0,4,8"
    assert rows["p2"][1] == "2" and rows["p2"][2] == "2,6"
    assert rows["p3"][1] == "0" and rows["p3"][2] == ""


def test_terminator_pattern_counts_zero():
    idx = FMIndex.build("ACGT")
    assert idx.count("$") == 0
    assert idx.locate("$").tolist() == []
    assert idx.count("T$") == 0
    counts = idx.count_batch(["$", "T$", "T"])
    assert counts.tolist() == [0, 0, 1]


def test_search_batch_ranges_locate():
    text = "ACGTACGTACGT"
    idx = FMIndex.build(text)
    pats = ["ACGT", "", "ZZ", "GTAC"]
    for device in (True, False):
        counts, ranges = idx.search_batch(pats, device=device)
        assert counts.tolist() == [3, 13, 0, 2]
        assert idx.locate_range(ranges[0]).tolist() == [0, 4, 8]
        assert idx.locate_range(ranges[2]).tolist() == []
        assert idx.locate_range(ranges[3]).tolist() == [2, 6]
        # Range-based locate == pattern locate.
        for p, r in zip(pats, ranges):
            assert idx.locate_range(r).tolist() == idx.locate(p).tolist()


def test_multi_contig_index():
    from genomics_rs_tpu.suffixtree.fmindex import MultiFMIndex

    from genomics_rs_tpu.sequence import Sequence

    refs = [
        Sequence("c1 desc", "ACGTACGT"),
        Sequence("c2", "TTACGTT"),
        Sequence("c3", "GGGG"),
    ]
    idx = MultiFMIndex.build(refs)
    for device in (True, False):
        counts, ranges = idx.search_batch(
            ["ACGT", "TT", "GGGG", "T#A", "ZZ"], device=device
        )
        assert counts.tolist() == [3, 2, 1, 0, 0]
        hits = idx.locate_range(ranges[0])
        assert sorted(hits) == [("c1 desc", 0), ("c1 desc", 4), ("c2", 2)]
        assert sorted(idx.locate_range(ranges[1])) == [
            ("c2", 0),
            ("c2", 5),
        ]
        assert idx.locate_range(ranges[2]) == [("c3", 0)]
    # A pattern equal to one contig's suffix + next contig's prefix
    # must NOT match across the boundary.
    assert idx.count_batch(["CGTTT"]).tolist() == [0]
    # Separator positions never surface, even for the empty pattern.
    counts, ranges = idx.search_batch([""])
    hits = idx.locate_range(ranges[0])
    assert len(hits) == sum(len(r) for r in refs)


def test_search_cli_multi_contig(tmp_path):
    from genomics_rs_tpu.cli import main

    ref = tmp_path / "ref.fasta"
    ref.write_text(">c1\nACGTACGT\n>c2\nTTACGTT\n")
    q = tmp_path / "q.fasta"
    q.write_text(">p1\nACGT\n")
    cfg = tmp_path / "config.toml"
    cfg.write_text(
        "[scores]\ns_match = 1\ns_mismatch = -2\ng = -2\nh = -5\n"
    )
    out = tmp_path / "hits.tsv"
    rc = main(
        ["-c", str(cfg), "search", "-r", str(ref), "-q", str(q),
         "--locate", "-o", str(out)]
    )
    assert rc == 0
    row = out.read_text().splitlines()[1].split("\t")
    assert row[1] == "3"
    assert sorted(row[2].split(",")) == ["c1:0", "c1:4", "c2:2"]


def test_multi_empty_pattern_count_matches_locate():
    from genomics_rs_tpu.sequence import Sequence
    from genomics_rs_tpu.suffixtree.fmindex import MultiFMIndex

    idx = MultiFMIndex.build(
        [Sequence("a", "ACGT"), Sequence("b", "GGA")]
    )
    counts, ranges = idx.search_batch(["", "G"])
    assert counts[0] == 7  # real contig positions only
    assert len(idx.locate_range(ranges[0])) == 7
    assert counts[1] == len(idx.locate_range(ranges[1])) == 3


def test_suffixtree_facade_lazy_fmindex():
    import genomics_rs_tpu.suffixtree as st

    assert st.FMIndex.build("AC").count("A") == 1
    import pytest as _pytest

    with _pytest.raises(AttributeError):
        st.NoSuchThing


def test_multi_contig_fuzz_vs_naive():
    from genomics_rs_tpu.sequence import Sequence
    from genomics_rs_tpu.suffixtree.fmindex import MultiFMIndex

    rng = np.random.default_rng(17)
    for _ in range(3):
        contigs = [
            "".join(rng.choice(list("ACGT"), int(rng.integers(15, 80))))
            for _ in range(int(rng.integers(2, 5)))
        ]
        refs = [Sequence(f"c{i}", s) for i, s in enumerate(contigs)]
        idx = MultiFMIndex.build(refs)
        pats = []
        for _ in range(15):
            src = contigs[int(rng.integers(0, len(contigs)))]
            L = int(rng.integers(1, min(9, len(src) + 1)))
            st = int(rng.integers(0, len(src) - L + 1))
            pats.append(src[st : st + L])
        counts, ranges = idx.search_batch(pats)
        for p, c, rng_ in zip(pats, counts, ranges):
            want = {
                (f"c{i}", pos)
                for i, s in enumerate(contigs)
                for pos in _naive_positions(s, p)
            }
            got = set(idx.locate_range(rng_))
            assert got == want, (p, contigs)
            assert c == len(want)


def test_index_equality_is_identity():
    """ndarray fields would make a generated __eq__ raise; the
    dataclasses opt out (eq=False, ADVICE r3)."""
    idx = FMIndex.build("ACGTACGT")
    idx2 = FMIndex.build("ACGTACGT")
    assert idx == idx and idx != idx2  # identity, no ValueError


def test_wide_gather_matches_narrow():
    """The wide (2-D Occ gather) search path is bit-identical to the
    flat-index path on the same index (guards the (n+1)*A >= 2**31
    overflow fix, ADVICE r3)."""
    import jax.numpy as jnp

    from genomics_rs_tpu.suffixtree.fmindex import _search_batch_device

    idx = FMIndex.build("GATTACAGATTACACATTAG")
    A = len(idx.alphabet)
    occ_flat = jnp.asarray(idx.occ.reshape(-1))
    cvec = jnp.asarray(idx.cvec)
    pats = np.full((3, 4), -1, dtype=np.int32)
    for row, p in enumerate([b"TTA", b"GATT", b"CA"]):
        codes = idx.code[np.frombuffer(p, np.uint8)]
        pats[row, 4 - len(p):] = codes
    args = (occ_flat, cvec, jnp.asarray(pats), jnp.int32(idx.n))
    lo_n, hi_n = _search_batch_device(*args, A=A, wide=False)
    lo_w, hi_w = _search_batch_device(*args, A=A, wide=True)
    assert (np.asarray(lo_n) == np.asarray(lo_w)).all()
    assert (np.asarray(hi_n) == np.asarray(hi_w)).all()
    # Ground truth by direct scan of the text.
    text = "GATTACAGATTACACATTAG"
    want = [
        sum(
            text[s : s + len(p)] == p
            for s in range(len(text) - len(p) + 1)
        )
        for p in ("TTA", "GATT", "CA")
    ]
    assert (np.asarray(hi_n) - np.asarray(lo_n)).tolist() == want


def test_native_sais_matches_device_sa():
    """native/sais.cpp orders suffixes bit-identically to the device
    prefix-doubling SA (ops/bwt_device.suffix_array) — including on a
    multi-contig join whose separator byte sorts below the
    terminator."""
    from genomics_rs_tpu.ops.bwt_device import suffix_array
    from genomics_rs_tpu.suffixtree.native import native_suffix_array

    rng = np.random.default_rng(7)
    texts = [
        "GATTACA",
        "A",
        "AAAAAAAA",
        "ACGT" * 50,
        "".join(rng.choice(list("ACGT"), 997)),
        # multi-contig shape: '#' (0x23) below '$' (0x24)
        "ACGTT" + chr(0x23) + "GGTAC" + chr(0x23) + "ACG",
    ]
    for text in texts:
        host = native_suffix_array(text.encode("latin-1") + b"$")
        if host is None:
            pytest.skip("native library unavailable")
        dev = suffix_array(text)
        assert host.tolist() == dev.tolist(), text


def test_fmindex_host_and_device_builds_identical():
    from genomics_rs_tpu.suffixtree.native import native_available

    if not native_available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    text = "".join(rng.choice(list("ACGT"), 1500))
    a = FMIndex.build(text, host=True)
    b = FMIndex.build(text, host=False)
    assert a.sa.tolist() == b.sa.tolist()
    assert a.bwt == b.bwt
    assert (a.occ == b.occ).all() and (a.cvec == b.cvec).all()
