"""Checkpoint and resume for the all-vs-all loop (port of
``claragenomicsanalysis_tpu/parallel/manifest.py``).

The (query chunk x target chunk) loop writes one part file per completed
pair and a manifest entry; a killed run resumes by skipping the completed
pairs, and the final merge is in canonical ``Overlap.key()`` order, so a
resumed run's output equals an uninterrupted one's.  The on-disk layout is
the JAX package's (``manifest.json``, and ``part_q{qf}-{ql}_t{tf}-{tl}.jsonl``
with one ``json.dumps(Overlap.__dict__)`` a line), so a work directory
written by either package resumes in the other.  With a mesh every rank
runs the loop (matching shards over 'rep'), rank 0 alone reads the manifest
and hands its entries to the other ranks (:func:`read_done`), and rank 0
alone writes, each file aside and then renamed (:func:`write_aside`).
"""

import json
import os

import torch

from ..core.config import MapperConfig
from ..core.types import Overlap
from ..io.paf import format_paf_row
from ..models.mapper import (IndexCache, Overlapper, pair_rows,
                             resolve_device)
from . import comm
from .multihost import group_of, is_writer


def read_done(path: str, keys: list[str], mesh=None) -> dict[str, bool]:
    """The manifest at ``path``: on rank 0 the whole file (``{}`` where
    there is none), on the mesh's other ranks its true entries among
    ``keys``.  Rank 0 alone reads the file, since it rewrites it after
    every part and another rank could read it half written; every rank of
    ``mesh`` calls this."""
    done: dict[str, bool] = {}
    if is_writer() and os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    if mesh is None or mesh.size == 1:
        return done
    flags = torch.tensor([bool(done.get(k)) for k in keys],
                         dtype=torch.int64, device=mesh.device)
    flags = comm.all_reduce(flags, group_of(list(range(mesh.size))))
    if is_writer():
        return done
    return {k: True for k, f in zip(keys, flags.tolist()) if f}


def write_aside(path: str, text: str) -> None:
    """``text`` into ``path``, written aside and then renamed, so the file
    is never seen half written."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _pair_name(qf, ql, tf, tl) -> str:
    return f"part_q{qf}-{ql}_t{tf}-{tl}"


def map_all_vs_all_resumable(parser, cfg: MapperConfig, work_dir: str,
                             max_anchors: int = 1 << 24,
                             fail_after_pairs: int | None = None,
                             device="cuda", mesh=None):
    """Resumable all-vs-all mapping on ``device``.  ``fail_after_pairs``
    raises after that many newly computed pairs (the resume tests' fault
    injection).  ``mesh`` shards matching over its 'rep' axis (the same
    result for any mesh).

    Returns (overlaps sorted canonically, n_pairs_computed,
    n_pairs_skipped)."""
    device = resolve_device(device)
    writer = is_writer()
    if writer:
        os.makedirs(work_dir, exist_ok=True)
    manifest_path = os.path.join(work_dir, "manifest.json")
    chunks = parser.get_chunks(cfg.index_size_mb * 1_000_000)
    done = read_done(manifest_path, [_pair_name(qf, ql, tf, tl)
                                     for (qf, ql) in chunks
                                     for (tf, tl) in chunks], mesh)
    cache = IndexCache(device=device)
    computed = skipped = 0
    fresh: dict[str, list[Overlap]] = {}    # this run's pairs, by name
    for (qf, ql) in chunks:
        for (tf, tl) in chunks:
            name = _pair_name(qf, ql, tf, tl)
            if done.get(name):
                skipped += 1
                continue
            qidx = cache.get_or_create(parser, qf, ql, cfg)
            tidx = cache.get_or_create(parser, tf, tl, cfg)
            # the index rows carry global read ids, so the overlaps do
            rows, _ = pair_rows(qidx, tidx, cfg, max_anchors, device, mesh)
            overlaps = Overlapper.rows_to_overlaps(rows)
            done[name] = True
            fresh[name] = overlaps
            if writer:
                write_aside(os.path.join(work_dir, name + ".jsonl"), "".join(
                    json.dumps(o.__dict__) + "\n" for o in overlaps))
                write_aside(manifest_path, json.dumps(done))
            computed += 1
            if fail_after_pairs is not None and computed >= fail_after_pairs:
                raise RuntimeError("injected failure for resume test")

    # pairs of earlier runs from their files; this run's from memory, so a
    # rank never reads a file rank 0 may still be writing
    overlaps: list[Overlap] = []
    for (qf, ql) in chunks:
        for (tf, tl) in chunks:
            name = _pair_name(qf, ql, tf, tl)
            if name in fresh:
                overlaps += fresh[name]
                continue
            with open(os.path.join(work_dir, name + ".jsonl")) as f:
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
