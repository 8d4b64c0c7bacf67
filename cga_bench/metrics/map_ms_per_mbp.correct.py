"""map_ms_per_mbp.correct: host ms in `correct.map` a read Mbp (the mapper)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("correct.map",), "correct.map")
