"""launches_per_mbp.overlap: hand-written kernel launches a read Mbp (the sum
of the port's `launch.<kernel>` counters); nothing where the port keeps
no counters."""

from cga_bench.counts import window_counts


def read(rec):
    counts = window_counts()
    if counts is None:
        return None
    return sum(v for k, v in counts.items()
               if k.startswith("launch.")) / rec["mbp"]
