"""The aligner's and the POA batch's configurations (copies of
``AlignerConfig``, ``PoaScores`` and ``BatchSize`` from
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


@dataclass(frozen=True)
class PoaScores:
    """POA alignment scores (reference defaults: gap -8, mismatch -6,
    match 8)."""

    match_score: int = 8
    mismatch_score: int = -6
    gap_score: int = -8


@dataclass(frozen=True)
class BatchSize:
    """Capacity of one POA batch: the per-window limits and the padded
    shapes they give (N = padded_nodes, L = padded_seq)."""

    max_sequence_size: int = 1024
    max_consensus_size: int = 0          # 0 -> 2 * max_sequence_size
    max_nodes_per_window: int = 0        # 0 -> 3 * max_sequence_size
    max_sequences_per_poa: int = 16
    band_width: int = 256                # static band for banded graph NW
    max_pred_per_node: int = 4           # CUDAPOA_MAX_NODE_EDGES analog
    max_aligned_per_node: int = 4        # CUDAPOA_MAX_NODE_ALIGNMENTS analog

    def __post_init__(self):
        if self.max_consensus_size == 0:
            object.__setattr__(self, "max_consensus_size", 2 * self.max_sequence_size)
        if self.max_nodes_per_window == 0:
            object.__setattr__(self, "max_nodes_per_window", 3 * self.max_sequence_size)

    @property
    def padded_nodes(self) -> int:
        return round_up(self.max_nodes_per_window, 8)

    @property
    def padded_seq(self) -> int:
        return round_up(self.max_sequence_size, 128)
