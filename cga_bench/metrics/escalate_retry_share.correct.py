"""escalate_retry_share.correct: banded-escalate's pairs sent again at a
doubled radius, as a share of the pairs that entered its loop (the port's
`escalate.retries` over `escalate.pairs`), in %: 0 where no pair entered
it; nothing where the port keeps no counters."""

from cga_bench.counts import window_counts


def read(rec):
    counts = window_counts()
    if counts is None:
        return None
    pairs = counts.get("escalate.pairs", 0)
    return 100.0 * counts.get("escalate.retries", 0) / pairs if pairs else 0.0
