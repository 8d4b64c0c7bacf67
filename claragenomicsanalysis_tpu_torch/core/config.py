"""The aligner's configuration (copy of ``AlignerConfig`` from
``claragenomicsanalysis_tpu/core/config.py``)."""

from dataclasses import dataclass

from ..utils.mathutils import round_up


@dataclass(frozen=True)
class AlignerConfig:
    """Limits of one aligner batch: (max_query_length, max_target_length,
    max_alignments) as the reference's create_aligner takes them, and the
    padded array shapes they give."""

    max_query_length: int
    max_target_length: int
    max_alignments: int
    # Band radius for banded ("Ukkonen") NW: cells with |i - j| > band_radius
    # are outside the band.
    band_radius: int = 64

    @property
    def padded_query_length(self) -> int:
        return round_up(self.max_query_length, 8)

    @property
    def padded_target_length(self) -> int:
        return round_up(self.max_target_length, 8)
