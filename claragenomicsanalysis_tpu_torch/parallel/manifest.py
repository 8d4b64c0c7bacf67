"""Checkpoint and resume for the all-vs-all loop (port of
``claragenomicsanalysis_tpu/parallel/manifest.py``, without its mesh).

The (query chunk x target chunk) loop writes one part file per completed
pair and a manifest entry; a killed run resumes by skipping the completed
pairs, and the final merge is in canonical ``Overlap.key()`` order, so a
resumed run's output equals an uninterrupted one's.  The on-disk layout is
the JAX package's (``manifest.json``, and ``part_q{qf}-{ql}_t{tf}-{tl}.jsonl``
with one ``json.dumps(Overlap.__dict__)`` a line), so a work directory
written by either package resumes in the other.
"""

import json
import os

from ..core.config import MapperConfig
from ..core.types import Overlap
from ..io.paf import format_paf_row
from ..models.mapper import IndexCache, Matcher, Overlapper, resolve_device


def _pair_name(qf, ql, tf, tl) -> str:
    return f"part_q{qf}-{ql}_t{tf}-{tl}"


def map_all_vs_all_resumable(parser, cfg: MapperConfig, work_dir: str,
                             max_anchors: int = 1 << 24,
                             fail_after_pairs: int | None = None,
                             device="cuda"):
    """Resumable all-vs-all mapping on ``device``.  ``fail_after_pairs``
    raises after that many newly computed pairs (the resume tests' fault
    injection).

    Returns (overlaps sorted canonically, n_pairs_computed,
    n_pairs_skipped)."""
    device = resolve_device(device)
    os.makedirs(work_dir, exist_ok=True)
    manifest_path = os.path.join(work_dir, "manifest.json")
    done: dict[str, bool] = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            done = json.load(f)

    chunks = parser.get_chunks(cfg.index_size_mb * 1_000_000)
    cache = IndexCache(device=device)
    computed = skipped = 0
    for (qf, ql) in chunks:
        for (tf, tl) in chunks:
            name = _pair_name(qf, ql, tf, tl)
            if done.get(name):
                skipped += 1
                continue
            qidx = cache.get_or_create(parser, qf, ql, cfg)
            tidx = cache.get_or_create(parser, tf, tl, cfg)
            matcher = Matcher.create_matcher(qidx, tidx, cfg, cap=max_anchors,
                                             device=device)
            # the index rows carry global read ids, so the overlaps do too
            overlaps = Overlapper.get_overlaps(matcher.anchors(), cfg)
            with open(os.path.join(work_dir, name + ".jsonl"), "w") as f:
                for o in overlaps:
                    f.write(json.dumps(o.__dict__) + "\n")
            done[name] = True
            with open(manifest_path, "w") as f:
                json.dump(done, f)
            computed += 1
            if fail_after_pairs is not None and computed >= fail_after_pairs:
                raise RuntimeError("injected failure for resume test")

    overlaps: list[Overlap] = []
    for (qf, ql) in chunks:
        for (tf, tl) in chunks:
            path = os.path.join(work_dir,
                                _pair_name(qf, ql, tf, tl) + ".jsonl")
            with open(path) as f:
                for line in f:
                    overlaps.append(Overlap(**json.loads(line)))
    overlaps.sort(key=lambda o: o.key())
    return overlaps, computed, skipped


def write_merged_paf(overlaps, parser, out_path: str) -> None:
    with open(out_path, "w") as f:
        for o in overlaps:
            q = parser.get_sequence_by_id(o.query_read_id)
            t = parser.get_sequence_by_id(o.target_read_id)
            f.write(format_paf_row(o, q.name, len(q.seq), t.name,
                                   len(t.seq)) + "\n")
