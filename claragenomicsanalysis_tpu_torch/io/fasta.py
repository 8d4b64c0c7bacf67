"""FASTA/FASTQ parsing (copy of the pure-Python parser of
``claragenomicsanalysis_tpu/io/fasta.py``, without its native fast path).

- FASTA and FASTQ, plain or gzipped, auto-detected;
- sequences shorter than ``min_seq_len`` are dropped;
- optional deterministic shuffle of read order (fixed seed) -- read ids
  refer to the post-filter, post-shuffle order;
- ``get_chunks`` splits the read range into groups whose total base count
  fits a budget (the mapper's index batcher).
"""

import gzip
from dataclasses import dataclass
from pathlib import Path

import numpy as np


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
    """In-memory random-access view over the reads of one file, or over
    ``records`` given in memory."""

    def __init__(self, path: str, min_seq_len: int = 0, shuffle: bool = False,
                 records: list[FastaSequence] | None = None):
        self._path = path
        if records is None:
            records = [FastaSequence(n, s) for n, s in _parse_records(path)
                       if len(s) >= min_seq_len]
        else:
            records = [r for r in records if len(r.seq) >= min_seq_len]
        if shuffle:
            # Deterministic shuffle -- fixed seed so runs are reproducible.
            rng = np.random.default_rng(0xD5)
            order = rng.permutation(len(records))
            records = [records[i] for i in order]
        self._records = records

    def get_num_seqences(self) -> int:  # reference-compatible spelling
        return len(self._records)

    def get_num_sequences(self) -> int:
        return len(self._records)

    def get_sequence_by_id(self, read_id: int) -> FastaSequence:
        return self._records[read_id]

    def get_chunks(self, max_chunk_bases: int,
                   first: int = 0, past_last: int | None = None
                   ) -> list[tuple[int, int]]:
        """Split [first, past_last) into contiguous read ranges whose summed
        base count is <= max_chunk_bases (each range holds >= 1 read)."""
        if past_last is None:
            past_last = len(self._records)
        chunks = []
        start = first
        bases = 0
        for i in range(first, past_last):
            n = len(self._records[i].seq)
            if bases and bases + n > max_chunk_bases:
                chunks.append((start, i))
                start, bases = i, 0
            bases += n
        if start < past_last:
            chunks.append((start, past_last))
        return chunks


def create_fasta_parser(path: str | Path, min_seq_len: int = 0,
                        shuffle: bool = False) -> FastaParser:
    """Parse ``path`` into a :class:`FastaParser`."""
    return FastaParser(str(path), min_seq_len, shuffle)
