"""map_ms_per_mbp.overlap: host ms in `pipeline.map` a read Mbp (the mapper)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("pipeline.map",), "pipeline.map")
