"""shard_imbalance.correct: how far the deal's largest rank share of DP
area lies above an even share, in %: 100 x (ranks x `shard.area_max` /
`shard.area_total` - 1), the counters summed over the window's deals
(`shard.ranks` / `shard.deals` ranks a deal).  Nothing where the port
keeps no such counters or dealt nothing."""

from cga_bench.counts import window_counts


def read(rec):
    counts = window_counts()
    if not counts or not counts.get("shard.deals"):
        return None
    total = counts.get("shard.area_total", 0)
    if not total:
        return 0.0
    ranks = counts["shard.ranks"] / counts["shard.deals"]
    return 100.0 * (ranks * counts["shard.area_max"] / total - 1.0)
