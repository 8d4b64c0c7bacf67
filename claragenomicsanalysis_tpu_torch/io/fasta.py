"""FASTA/FASTQ parsing (copy of the pure-Python parser of
``claragenomicsanalysis_tpu/io/fasta.py``, without its native fast path and
the options the port does not use).

FASTA and FASTQ, plain or gzipped, auto-detected; read ids are the order of
the records in the file.
"""

import gzip
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class FastaSequence:
    name: str
    seq: str


def _open_maybe_gzip(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def _parse_records(path: str):
    """Yield (name, seq) from FASTA or FASTQ (kseq-style tolerant parser)."""
    with _open_maybe_gzip(path) as f:
        name = None
        seq_parts: list[str] = []
        mode = None  # 'fasta' | 'fastq'
        it = iter(f)
        for line in it:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if mode is None:
                if line.startswith(">"):
                    mode = "fasta"
                elif line.startswith("@"):
                    mode = "fastq"
                else:
                    raise ValueError(f"{path}: not FASTA/FASTQ")
            if mode == "fasta":
                if line.startswith(">"):
                    if name is not None:
                        yield name, "".join(seq_parts)
                    name = line[1:].split()[0] if len(line) > 1 else ""
                    seq_parts = []
                else:
                    seq_parts.append(line)
            else:  # fastq: 4-line records
                if not line.startswith("@"):
                    raise ValueError(f"{path}: malformed FASTQ header: {line!r}")
                name = line[1:].split()[0] if len(line) > 1 else ""
                seq = next(it).strip()
                plus = next(it)
                if not plus.startswith("+"):
                    raise ValueError(f"{path}: malformed FASTQ separator")
                next(it)  # quality
                yield name, seq
                name = None
        if mode == "fasta" and name is not None:
            yield name, "".join(seq_parts)


class FastaParser:
    """In-memory random-access view over the reads of one file."""

    def __init__(self, path: str):
        self._path = path
        self._records = [FastaSequence(n, s) for n, s in _parse_records(path)]

    def get_num_sequences(self) -> int:
        return len(self._records)

    def get_sequence_by_id(self, read_id: int) -> FastaSequence:
        return self._records[read_id]


def create_fasta_parser(path: str | Path) -> FastaParser:
    """Parse ``path`` into a :class:`FastaParser`."""
    return FastaParser(str(path))
