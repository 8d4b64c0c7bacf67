"""rank_wait_ms_per_mbp.correct: rank 0's host ms in `ranks.wait`, the
barrier before the corrected reads are gathered (the wait for the slowest
rank), a read Mbp.  Nothing where no deal ran."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("ranks.wait",), "ranks.wait")
