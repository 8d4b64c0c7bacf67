"""paf_ms_per_mbp.overlap: host ms in `pipeline.paf` a read Mbp (the PAF
row of every overlap)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("pipeline.paf",), "pipeline.paf")
