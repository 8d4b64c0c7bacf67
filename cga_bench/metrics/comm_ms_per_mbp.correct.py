"""comm_ms_per_mbp.correct: rank 0's host ms in the exchanges between ranks
(the `comm.*` ranges of `parallel/comm.py`) a read Mbp; `comm.gather_reads`,
which holds two of them and the reads' packing, is left out so that no
time counts twice.  Nothing where no exchange ran."""

from cga_bench.readers import per_mbp


def read(rec):
    spans = rec.get("host_ms", {})
    ms = sum(v for k, v in spans.items()
             if k.startswith("comm.") and k != "comm.gather_reads")
    return per_mbp(rec, ms, "comm.all_gather")
