"""FASTA sequences and device encoding.

Parsing semantics mirror the reference loader
(``/root/reference/src/sequence.rs:45-95``): ``>`` headers start a new
sequence (name = rest of line, trimmed), body lines are trimmed and
appended, empty lines are skipped, body data before any header is
dropped with a warning, and multiple files accumulate into one
container.

On top of that the container provides device-side encoding: sequences are
turned into uint8 ASCII arrays padded to a lane-friendly multiple, with
lengths carried separately (static shapes + masking is the XLA-friendly
way to handle ragged genomic data).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

log = logging.getLogger(__name__)

#: Padding bytes guaranteed never to match each other or any ASCII base.
PAD_S1 = 0xFE
PAD_S2 = 0xFF

#: IUPAC DNA complement (upper + lower); unlisted characters pass
#: through unchanged — alignment treats bytes as opaque equality, so a
#: non-IUPAC byte simply keeps (mis)matching the same way either way.
_COMPLEMENT = str.maketrans(
    "ACGTUacgtuRYKMrykmBVDHbvdhNn",
    "TGCAAtgcaaYRMKyrmkVBHDvbhdNn",
)


@dataclasses.dataclass
class Sequence:
    name: str
    sequence: str
    #: Phred quality string (FASTQ inputs only); same length as
    #: ``sequence`` when present. Alignment ignores it — carried so
    #: read pipelines can surface qualities alongside results.
    quality: str | None = None

    def __str__(self) -> str:  # parity: `Display for Sequence` (sequence.rs:14-18)
        return f"{self.name}: {self.sequence}"

    def __len__(self) -> int:
        return len(self.sequence)

    def reverse_complement(self) -> "Sequence":
        """Reverse-complemented copy (IUPAC map, quality reversed).

        Extension for read mapping: reads align against
        both strands and the better orientation wins. The reference's
        only nod to direction is the dead ``reverse_sequences`` flag
        (``sequence.rs:102-115``), which reverses indices, not bases.
        """
        return Sequence(
            name=self.name,
            sequence=self.sequence.translate(_COMPLEMENT)[::-1],
            quality=(
                self.quality[::-1] if self.quality is not None else None
            ),
        )

    def encoded(self, pad_to: int | None = None, pad_value: int = PAD_S1) -> np.ndarray:
        """ASCII bytes as uint8, optionally right-padded to ``pad_to``."""
        arr = np.frombuffer(self.sequence.encode("ascii"), dtype=np.uint8)
        if pad_to is not None:
            if pad_to < arr.size:
                raise ValueError(f"pad_to={pad_to} < sequence length {arr.size}")
            arr = np.concatenate(
                [arr, np.full(pad_to - arr.size, pad_value, dtype=np.uint8)]
            )
        return arr


@dataclasses.dataclass
class SequenceContainer:
    sequences: list[Sequence] = dataclasses.field(default_factory=list)

    def from_fasta(self, filepath: str) -> "SequenceContainer":
        """Append all sequences found in ``filepath`` (reference parity)."""
        loaded: list[Sequence] = []
        seen_header = False
        try:
            with open(filepath, "r") as f:
                for line in f:
                    line = line.rstrip("\n").rstrip("\r")
                    if not line:
                        continue
                    if line.startswith(">"):
                        name = line[1:].strip()
                        log.info(
                            "Sequence Found (ID: %d): %s",
                            len(self.sequences) + len(loaded),
                            filepath,
                        )
                        loaded.append(Sequence(name=name, sequence=""))
                        seen_header = True
                    elif seen_header:
                        loaded[-1].sequence += line.strip()
                    else:
                        log.warning("Sequence data found without a header")
        except OSError:
            log.error("Could not open file: %s", filepath)

        log.debug("Loaded %d sequences", len(loaded))
        self.sequences.extend(loaded)
        return self

    def from_fastq(self, filepath: str) -> "SequenceContainer":
        """Append all reads from a FASTQ file (strict 4-line records).

        Extension (the reference is FASTA-only,
        ``sequence.rs:45-95``): real read sets arrive as FASTQ. Records
        are ``@name`` / bases / ``+[name]`` / qualities; blank lines
        between records are tolerated, multi-line sequences are not
        (per the de-facto 4-line convention). A malformed record raises
        ``ValueError`` with the offending line number — unlike FASTA
        parity parsing there is no reference behavior to mirror, so
        errors are loud. A missing file only logs, matching
        ``from_fasta``.
        """
        loaded: list[Sequence] = []
        try:
            with open(filepath, "r") as f:
                lines = f.read().splitlines()
        except OSError:
            log.error("Could not open file: %s", filepath)
            return self

        k = 0
        n_lines = len(lines)
        while k < n_lines:
            if not lines[k].strip():
                k += 1
                continue
            header = lines[k].rstrip("\r")
            if not header.startswith("@"):
                raise ValueError(
                    f"{filepath}:{k + 1}: expected '@' record header, "
                    f"got {header[:32]!r}"
                )
            if k + 3 >= n_lines:
                raise ValueError(
                    f"{filepath}:{k + 1}: truncated FASTQ record "
                    f"(need 4 lines, file ends after {n_lines - k})"
                )
            seq = lines[k + 1].rstrip("\r").strip()
            plus = lines[k + 2].rstrip("\r")
            qual = lines[k + 3].rstrip("\r").strip()
            if not plus.startswith("+"):
                raise ValueError(
                    f"{filepath}:{k + 3}: expected '+' separator, "
                    f"got {plus[:32]!r}"
                )
            if len(qual) != len(seq):
                raise ValueError(
                    f"{filepath}:{k + 4}: quality length {len(qual)} "
                    f"!= sequence length {len(seq)}"
                )
            name = header[1:].strip()
            loaded.append(Sequence(name=name, sequence=seq, quality=qual))
            k += 4

        # ONE summary line per file — unlike from_fasta's per-record
        # parity log, real read sets have millions of records and a
        # per-read info line would dominate both stderr and runtime.
        log.info(
            "Reads Found: %d (IDs %d..%d): %s",
            len(loaded),
            len(self.sequences),
            len(self.sequences) + max(len(loaded) - 1, 0),
            filepath,
        )
        self.sequences.extend(loaded)
        return self

    def from_reads(self, filepath: str) -> "SequenceContainer":
        """Append sequences, auto-detecting FASTA vs FASTQ.

        Detection is by the first non-blank character (``>`` → FASTA,
        ``@`` → FASTQ) rather than extension — read sets in the wild
        use ``.fq``/``.fastq``/``.fasta``/``.fa`` interchangeably. An
        unreadable or empty file falls through to the FASTA parser,
        which preserves ``from_fasta``'s log-only error behavior.
        """
        first = ""
        try:
            with open(filepath, "r") as f:
                for line in f:
                    if line.strip():
                        first = line.lstrip()[0]
                        break
        except OSError:
            pass
        if first == "@":
            return self.from_fastq(filepath)
        return self.from_fasta(filepath)

    def is_match(self, i: int, j: int, reverse_sequences: bool = False) -> bool:
        """Byte equality of ``s1[i]`` vs ``s2[j]``.

        Replicates ``is_match`` (``sequence.rs:102-115``) including its
        out-of-range semantics: Rust's ``bytes().nth()`` yields ``None``
        past the end and ``None == None`` counts as a match — this is
        load-bearing for the reference's retrace stats (SURVEY §2.4-5).
        """
        s1 = self.sequences[0].sequence
        s2 = self.sequences[1].sequence
        ip = len(s2) - i if reverse_sequences else i
        jp = len(s1) - j if reverse_sequences else j
        c1 = s1[ip] if 0 <= ip < len(s1) else None
        c2 = s2[jp] if 0 <= jp < len(s2) else None
        return c1 == c2


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple
