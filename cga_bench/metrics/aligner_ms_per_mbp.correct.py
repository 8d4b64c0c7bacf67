"""aligner_ms_per_mbp.correct: host ms in `correct.align` a read Mbp
(banded-escalate alignment of every query-side overlap)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("correct.align",), "correct.align")
