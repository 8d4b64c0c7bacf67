"""Noisy long-read simulator (copy of
``claragenomicsanalysis_tpu/simulators/readsim.py``)."""

from dataclasses import dataclass

import numpy as np

from ..utils.genomeutils import BASES, reverse_complement


@dataclass
class SimulatedRead:
    name: str
    seq: str
    reference_start: int
    reference_end: int
    strand: str  # '+' or '-'


class NoisyReadSimulator:
    """Extract substrings of a reference and inject indel/substitution noise."""

    def __init__(self, seed: int = 0, error_rate: float = 0.05,
                 insertion_frac: float = 0.25, deletion_frac: float = 0.25):
        self._rng = np.random.default_rng(seed)
        self._error_rate = error_rate
        self._ins = insertion_frac
        self._del = deletion_frac

    def generate_read(self, reference: str, median_length: int,
                      name: str = "read", allow_reverse: bool = True
                      ) -> SimulatedRead:
        rng = self._rng
        length = int(np.clip(rng.normal(median_length, median_length / 10),
                             32, len(reference)))
        start = int(rng.integers(0, len(reference) - length + 1))
        frag = reference[start:start + length]
        strand = "+"
        if allow_reverse and rng.random() < 0.5:
            frag = reverse_complement(frag)
            strand = "-"
        noisy = self._add_noise(frag)
        return SimulatedRead(name, noisy, start, start + length, strand)

    def generate_reads(self, reference: str, num_reads: int,
                       median_length: int, prefix: str = "read"
                       ) -> list[SimulatedRead]:
        return [self.generate_read(reference, median_length, f"{prefix}_{i}")
                for i in range(num_reads)]

    def _add_noise(self, seq: str) -> str:
        rng = self._rng
        out = []
        for ch in seq:
            r = rng.random()
            if r >= self._error_rate:
                out.append(ch)
                continue
            kind = rng.random()
            if kind < self._ins:
                out.append(ch)
                out.append(BASES[int(rng.integers(0, 4))])
            elif kind < self._ins + self._del:
                continue
            else:
                choices = [b for b in BASES if b != ch]
                out.append(choices[int(rng.integers(0, 3))])
        return "".join(out)
