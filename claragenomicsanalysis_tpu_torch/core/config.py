"""The configurations of the aligner, the POA batch, the mapper and the two
compositions (copies of ``AlignerConfig``, ``PoaScores``, ``BatchSize``,
``MapperConfig``, ``PipelineConfig`` and ``CorrectConfig`` from
``claragenomicsanalysis_tpu/core/config.py``)."""

from dataclasses import dataclass, field

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


@dataclass(frozen=True)
class MapperConfig:
    """Overlapper parameters (the cudamapper CLI flags).  The CLI's
    ``--min-overlap-fraction`` defaults to 0.8, this config's to 0.95, as
    in the JAX package."""

    kmer_size: int = 15                # -k
    window_size: int = 15              # -w
    hash_representations: bool = True
    filtering_parameter: float = 1.0   # -F: drop reps with freq > F (1.0 = off)
    min_residues: int = 4              # min anchors per overlap
    min_overlap_len: int = 50
    min_bases_per_residue: int = 100
    min_overlap_fraction: float = 0.95
    max_anchor_gap: int = 5000         # chain trigger: max (qpos,tpos) step
    index_size_mb: int = 30            # -i/-t batching budget (MB of bases)
    skip_self_mappings: bool = True

    def __post_init__(self):
        # hashed mode packs 2k bits into one 64-bit word then mixes to a
        # 32-bit representation (ops/sketch.py) -> k up to 31; unhashed mode
        # stores the packed k-mer itself as a 32-bit value -> k <= 15.
        if self.hash_representations:
            if not (1 <= self.kmer_size <= 31):
                raise ValueError("kmer_size must be in [1, 31]")
        elif not (1 <= self.kmer_size <= 15):
            raise ValueError(
                "kmer_size must be in [1, 15] when hash_representations "
                "is off (32-bit unhashed representations)")


@dataclass(frozen=True)
class PipelineConfig:
    """Overlap -> alignment pipeline (``cli pipeline``)."""

    mapper: MapperConfig = field(default_factory=MapperConfig)
    aligner_band_radius: int = 256
    max_alignment_length: int = 16384


@dataclass(frozen=True)
class CorrectConfig:
    """Read correction (``cli correct``): all-vs-all map -> per-overlap
    base-exact alignment -> per-read pileup windows -> batched POA
    consensus -> corrected reads.  ``max_support`` defaults to 7 here and
    to 15 on ``cli correct --max-support``, as in the JAX package."""

    mapper: MapperConfig = field(default_factory=MapperConfig)
    window_length: int = 128          # backbone window (bases)
    max_support: int = 7              # supporting segments per window
    min_matched_bases: int = 8        # matched pairs a support must place
    aligner_band_radius: int = 256    # per-overlap re-alignment band
    max_alignment_length: int = 16384 # overlaps longer than this are skipped
    # windows with fewer supports keep the backbone
    min_supports_for_poa: int = 2
    # POA kernels of the polish stage, the JAX package's four names:
    # "pallas" runs models.poa's kernel="window" (B10), "auto", "xla" and
    # "pallas2" its kernel="lockstep" (B5-B8); every choice gives the same
    # result
    poa_backend: str = "auto"
