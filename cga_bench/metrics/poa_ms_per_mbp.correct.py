"""poa_ms_per_mbp.correct: host ms in `correct.poa` a read Mbp (the POA
batches: packing, the kernels' launches, the read-back)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("correct.poa",), "correct.poa")
