"""Plain-data record types of the mapper (copy of
``claragenomicsanalysis_tpu/core/types.py``).  On the card these live as
tensors; these dataclasses are the host-side view used by I/O, tests and the
CLI."""

from dataclasses import dataclass


@dataclass(frozen=True)
class SketchElement:
    """One minimizer occurrence."""

    representation: int     # hashed canonical k-mer value
    read_id: int
    position_in_read: int   # first base of the k-mer
    direction: int          # 0 = forward strand was canonical, 1 = reverse


@dataclass(frozen=True)
class Anchor:
    """A (query minimizer, target minimizer) match pair."""

    query_read_id: int
    target_read_id: int
    query_position_in_read: int
    target_position_in_read: int
    direction: int = 0      # relative strand: 0 = same, 1 = opposite


@dataclass
class Overlap:
    """A chained overlap candidate; serializes to one PAF row."""

    query_read_id: int
    target_read_id: int
    query_start_position_in_read: int
    query_end_position_in_read: int
    target_start_position_in_read: int
    target_end_position_in_read: int
    num_residues: int          # number of anchors in the chain
    relative_strand: str = "+"  # '+' or '-'
    cigar: str = ""

    def key(self):
        """Canonical sort key: the deterministic merge order that keeps PAF
        output identical for any batching."""
        return (
            self.query_read_id,
            self.target_read_id,
            0 if self.relative_strand == "+" else 1,
            self.query_start_position_in_read,
            self.target_start_position_in_read,
            self.query_end_position_in_read,
            self.target_end_position_in_read,
        )
