"""cigar_strings_ms_per_mbp.overlap: host ms in `pipeline.cigar` a read Mbp
(the CIGAR string of every aligned overlap)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("pipeline.cigar",), "pipeline.cigar")
