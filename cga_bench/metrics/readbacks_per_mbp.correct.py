"""readbacks_per_mbp.correct: blocking device-to-host read-backs a read Mbp
(the port's `readback` counter, one a `utils.profiling.to_host`);
nothing where the port keeps no counters."""

from cga_bench.counts import window_counts


def read(rec):
    counts = window_counts()
    if counts is None or "readback" not in counts:
        return None
    return counts["readback"] / rec["mbp"]
