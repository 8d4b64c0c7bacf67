"""Overlap -> alignment pipeline on PyTorch (port of
``claragenomicsanalysis_tpu/models/pipeline.py``).

Candidate overlaps from the mapper are re-aligned base-exactly with the
batched aligner (``myers``), and their PAF rows gain ``cg:Z`` CIGARs.  The
mapper and every aligner run on the entry point's device.

The pipeline keeps its paths on the device: it asks each aligner for
CIGARs (``Aligner.get_cigars``), so the banded launches' packed paths and
Hirschberg's leaves stay where the decoder wrote them, and the CIGAR kernel
(``ops/cigar.py``) sends back their text alone.  No path is unpacked on the
host, as ``cli correct`` and ``cli align`` still do (``get_alignments``).
"""

from dataclasses import dataclass

from ..core.config import PipelineConfig
from ..core.status import StatusType
from ..core.types import Overlap
from ..io.fasta import FastaParser
from ..io.paf import format_paf_row
from ..models.aligner import create_aligner
from ..models.mapper import map_all_vs_all, resolve_device
from ..utils.genomeutils import reverse_complement
from ..utils.profiling import trace_range


@dataclass
class PipelineResult:
    overlaps: list[Overlap]
    paf_rows: list[str]
    n_aligned: int
    n_align_failed: int


def span_bucket(q_len: int, t_len: int) -> int:
    """The padded length a span pair aligns at: the next power of two of
    its longer side, at least 64.  It is part of the result, not padding
    alone: the aligner routes to Hirschberg by its padded query length,
    and the two routes break ties differently."""
    return max(64, 1 << (max(q_len, t_len, 1) - 1).bit_length())


def overlap_spans(overlaps: list[Overlap], parser: FastaParser):
    """(query span, target span) of each overlap, the target span
    reverse-complemented on the ``-`` strand."""
    spans = []
    with trace_range("overlaps.spans"):
        for o in overlaps:
            q = parser.get_sequence_by_id(o.query_read_id).seq[
                o.query_start_position_in_read:o.query_end_position_in_read]
            t = parser.get_sequence_by_id(o.target_read_id).seq[
                o.target_start_position_in_read:o.target_end_position_in_read]
            if o.relative_strand == "-":
                t = reverse_complement(t)
            spans.append((q, t))
    return spans


def span_buckets(spans) -> dict[int, list[int]]:
    """Span indices grouped by :func:`span_bucket`, in input order."""
    buckets: dict[int, list[int]] = {}
    with trace_range("overlaps.buckets"):
        for i, (q, t) in enumerate(spans):
            buckets.setdefault(span_bucket(len(q), len(t)), []).append(i)
    return buckets


def within_length(o: Overlap, max_alignment_length: int) -> bool:
    return max(o.query_end_position_in_read - o.query_start_position_in_read,
               o.target_end_position_in_read
               - o.target_start_position_in_read) <= max_alignment_length


def run_pipeline(parser: FastaParser, cfg: PipelineConfig,
                 batch_size: int = 2048, device="cuda",
                 mesh=None) -> PipelineResult:
    """Map all-vs-all on ``device``, then globally align each overlap's
    spans there (``myers``), a launch batch per span bucket and chunk of
    ``batch_size``.  ``mesh``: matching shards over its 'rep' view
    (parallel.mesh.axis_meshes)."""
    from ..parallel.mesh import axis_meshes
    device = resolve_device(device)
    _, mesh_rep = axis_meshes(mesh)
    with trace_range("pipeline.map"):
        res = map_all_vs_all(parser, cfg.mapper, device=device,
                             mesh=mesh_rep)
    with trace_range("overlaps.filter"):
        overlaps = [o for o in res.overlaps
                    if within_length(o, cfg.max_alignment_length)]
    spans = overlap_spans(overlaps, parser)

    n_fail = 0
    with trace_range("pipeline.align"):
        for blen, idxs in sorted(span_buckets(spans).items()):
            for start in range(0, len(idxs), batch_size):
                chunk_ids = idxs[start:start + batch_size]
                with trace_range("aligner.add"):
                    aligner = create_aligner(
                        blen, blen, len(chunk_ids),
                        band_radius=min(cfg.aligner_band_radius, blen),
                        algorithm="myers", device=device)
                    for i in chunk_ids:
                        aligner.add_alignment(*spans[i])
                aligner.sync_cigars()
                with trace_range("pipeline.cigar"):
                    for i, (status, cigar) in zip(chunk_ids,
                                                  aligner.get_cigars()):
                        if status == StatusType.SUCCESS:
                            overlaps[i].cigar = cigar
                        else:
                            n_fail += 1

    rows = []
    with trace_range("pipeline.paf"):
        for o in overlaps:
            q = parser.get_sequence_by_id(o.query_read_id)
            t = parser.get_sequence_by_id(o.target_read_id)
            rows.append(format_paf_row(o, q.name, len(q.seq), t.name,
                                       len(t.seq)))
    return PipelineResult(overlaps, rows, len(overlaps) - n_fail, n_fail)
