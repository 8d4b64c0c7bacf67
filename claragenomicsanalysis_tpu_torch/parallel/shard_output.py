"""Sharded map output (counterpart of
``claragenomicsanalysis_tpu/parallel/shard_output.py``).

``map_all_vs_all(mesh=)`` gives every rank the whole overlap set, which is
right for small runs and wrong at scale.  Here each 'rep' rank compacts the
overlaps of its query range and writes them once, as a part file, and a
deterministic merge (parts in (pair, shard) order, then one stable
canonical sort) gives ``map_all_vs_all(mesh=)``'s rows exactly.  The part
files keep the JAX package's names and layout, ``part_p{pair:05d}_r{shard:03d}.npy``
holding (8, n) canonical int32 rows, so either package's merge reads the
other's parts.
"""

import os
import re

import numpy as np

_PART_RE = re.compile(r"part_p(\d+)_r(\d+)\.npy$")


def map_all_vs_all_sharded(parser, cfg, out_dir: str, mesh,
                           max_anchors: int = 1 << 24,
                           device="cuda") -> tuple:
    """All-vs-all mapping with sharded output: each rank writes
    ``part_p{pair}_r{shard}.npy`` for the rep shard it owns (data and sp
    coordinates 0), and no rank holds the whole overlap set.  -> (paths
    this rank wrote, n_pairs)."""
    from ..models.mapper import IndexCache, Overlapper, resolve_device
    from .shard import sharded_match_chain
    if mesh.shape.get("rep", 1) < 2:
        raise ValueError("sharded output needs a mesh with a rep axis >= 2")
    os.makedirs(out_dir, exist_ok=True)
    chunks = parser.get_chunks(cfg.index_size_mb * 1_000_000)
    cache = IndexCache(device=resolve_device(device))
    written: list[str] = []
    pairs = [(q, t) for q in chunks for t in chunks]
    for pi, ((qf, ql), (tf, tl)) in enumerate(pairs):
        qidx = cache.get_or_create(parser, qf, ql, cfg)
        tidx = cache.get_or_create(parser, tf, tl, cfg)
        out, _ = sharded_match_chain(
            qidx._arrays, tidx._arrays, cfg, mesh, cap=max_anchors,
            n_query_reads=len(qidx.read_lengths),
            first_read=qidx.first_read_id)
        for r, rows in Overlapper.compact_rows_local(out, mesh).items():
            path = os.path.join(out_dir, f"part_p{pi:05d}_r{r:03d}.npy")
            np.save(path, rows)
            written.append(path)
    return written, len(pairs)


def merge_sharded_rows(out_dir: str) -> np.ndarray:
    """Deterministic merge of the part files: (pair, shard) ascending, then
    one stable canonical sort; equal to map_all_vs_all's rows (equal keys
    repeat only across pairs, never across shards, since each shard owns a
    disjoint query-read range)."""
    from ..models.mapper import _canonical_order
    parts = []
    for name in os.listdir(out_dir):
        m = _PART_RE.match(name)
        if m:
            parts.append((int(m.group(1)), int(m.group(2)), name))
    parts.sort()
    arrs = [np.load(os.path.join(out_dir, name)) for _, _, name in parts]
    rows = (np.concatenate(arrs, axis=1) if arrs
            else np.zeros((8, 0), np.int32))
    return rows[:, _canonical_order(rows)]


def write_merged_paf(parser, out_dir: str, out_path: str) -> int:
    """Merge the part files into one PAF in canonical order; -> the row
    count.  Run after every rank has written its parts (behind a barrier)."""
    from ..models.mapper import Overlapper, overlaps_to_paf
    rows = merge_sharded_rows(out_dir)
    overlaps = Overlapper.rows_to_overlaps(rows)
    with open(out_path, "w") as f:
        for line in overlaps_to_paf(overlaps, parser):
            f.write(line + "\n")
    return len(overlaps)
