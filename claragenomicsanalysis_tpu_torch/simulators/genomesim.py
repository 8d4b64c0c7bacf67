"""Synthetic genome generators (copy of
``claragenomicsanalysis_tpu/simulators/genomesim.py``)."""

import numpy as np

from ..utils.genomeutils import BASES


class PoissonGenomeSimulator:
    """IID uniform base sampling (the reference's 'Poisson' generator)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def build_reference(self, reference_length: int) -> str:
        idx = self._rng.integers(0, 4, size=reference_length)
        return "".join(BASES[i] for i in idx)


class MarkovGenomeSimulator:
    """First-order Markov chain over bases, for GC-bias-like structure."""

    def __init__(self, seed: int = 0,
                 transitions: dict[str, dict[str, float]] | None = None):
        self._rng = np.random.default_rng(seed)
        if transitions is None:
            transitions = {b: {c: (0.4 if b == c else 0.2) for c in BASES}
                           for b in BASES}
        self._t = np.zeros((4, 4))
        for i, b in enumerate(BASES):
            row = np.array([transitions[b][c] for c in BASES], dtype=float)
            self._t[i] = row / row.sum()

    def build_reference(self, reference_length: int) -> str:
        out = np.empty(reference_length, dtype=np.int64)
        out[0] = self._rng.integers(0, 4)
        for i in range(1, reference_length):
            out[i] = self._rng.choice(4, p=self._t[out[i - 1]])
        return "".join(BASES[i] for i in out)
