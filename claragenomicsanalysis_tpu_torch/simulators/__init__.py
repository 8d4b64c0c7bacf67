"""Synthetic genomes and noisy reads (copy of
``claragenomicsanalysis_tpu/simulators``): the same seed gives the same
sequences as the JAX package's simulators."""

from .genomesim import MarkovGenomeSimulator, PoissonGenomeSimulator
from .readsim import NoisyReadSimulator

__all__ = ["PoissonGenomeSimulator", "MarkovGenomeSimulator",
           "NoisyReadSimulator"]
