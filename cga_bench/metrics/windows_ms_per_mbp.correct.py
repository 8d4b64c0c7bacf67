"""windows_ms_per_mbp.correct: host ms in `correct.windows` a read Mbp
(the pileup supports, host NumPy)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("correct.windows",), "correct.windows")
