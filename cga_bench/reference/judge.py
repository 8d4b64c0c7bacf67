"""The comparison that decides ``correct``: what the timed window's entry
produced, against the plain reference worked out again from the same
generated reads.

Every number compared counts answers that differ from the reference, and
every limit is 0: the port's results are exact and canonical (integer DP,
no tolerance).  Samples are drawn from the run's seed, the longest item
always among them.

- ``pipeline`` (``cli pipeline``):
  - ``overlap_rows_differing``: the PAF fields without the CIGAR of every
    overlap of every completed job (rows in one set and not in the other);
  - ``cigars_differing``: the CIGARs of every overlap of one completed job
    drawn from the seed, where that job's DP area (the sum of query span x
    target span) is within ``full_job_cells``, and of a sample stratified
    by span bucket and route over every completed job: up to
    ``per_stratum`` overlaps of each (bucket, route), so that each of B4's
    widths and each depth of Hirschberg's levels is held.
- ``correct`` (``cli correct``):
  - ``overlap_rows_differing``: the mapper's overlaps of every completed
    job, as ``correct_reads`` mapped them;
  - ``reads_differing``: whole corrected reads, every window of each,
    drawn from the seed over every completed job until ``windows`` windows
    are held; each crosses the mapper, the alignment of every overlap of
    the read as the query, the windows and POA;
  - ``reads_missing``: reads in and out of each job.

The control (``cga_bench/control.py``) puts the reference in the
program's place with one guarantee broken and is judged by these same
functions.
"""

import os
from collections import Counter

import numpy as np

from . import align, correct, mapper

LIMIT = 0


def sample_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), 7])


def seeded_order(sizes, rng) -> list[int]:
    """Every index, the largest size first, the rest in an order drawn
    from ``rng``."""
    if len(sizes) == 0:
        return []
    longest = int(np.argmax(sizes))
    return [longest] + [int(c) for c in rng.permutation(len(sizes))
                        if c != longest]


def job_maps(jobs, settings):
    """Per job: (sequences, every overlap row of the reference mapper,
    the rows within the alignment length), rows in canonical order."""
    out = []
    for reads in jobs:
        seqs = [s for _, s in reads]
        rows = mapper.map_all_vs_all(seqs, settings["mapper"])
        keep = correct.within_length(rows, settings["max_alignment_length"])
        out.append((seqs, rows, rows[keep]))
    return out


def row_diff(a, b) -> int:
    """Rows in one multiset and not in the other."""
    ca = Counter(map(tuple, np.asarray(a, np.int64).reshape(-1, 8).tolist()))
    cb = Counter(map(tuple, np.asarray(b, np.int64).reshape(-1, 8).tolist()))
    return sum(((ca - cb) + (cb - ca)).values())


def buckets(rows) -> np.ndarray:
    """Each overlap row's span bucket (``align.span_bucket``)."""
    size = np.maximum(np.maximum(rows[:, 3] - rows[:, 2],
                                 rows[:, 5] - rows[:, 4]), 1)
    return np.maximum(64, 1 << np.ceil(np.log2(size)).astype(np.int64))


def overlap_sample(maps, check, seed, algorithm, device) -> list:
    """(job, row) of every overlap whose CIGAR is compared, in a fixed
    order: one whole job where its DP area allows, then up to
    ``per_stratum`` of each (span bucket, route)."""
    rng = sample_rng(seed)
    picked: dict = {}
    area = [int(((r[:, 3] - r[:, 2]) * (r[:, 5] - r[:, 4])).sum())
            for _, _, r in maps]
    fits = [j for j, a in enumerate(area) if a <= check["full_job_cells"]]
    if fits:
        j0 = fits[int(rng.integers(len(fits)))]
        picked.update(((j0, i), None) for i in range(len(maps[j0][2])))
    per = check["per_stratum"]
    rows = np.concatenate([m[2] for m in maps]).reshape(-1, 8)
    job = np.concatenate([np.full(len(m[2]), j) for j, m in enumerate(maps)])
    idx = np.concatenate([np.arange(len(m[2])) for m in maps])
    bucket = buckets(rows)
    size = np.maximum(rows[:, 3] - rows[:, 2], rows[:, 5] - rows[:, 4])
    for b in np.unique(bucket).tolist():
        cands = np.flatnonzero(bucket == b)
        order = [(int(job[c]), int(idx[c])) for c in
                 cands[seeded_order(size[cands], rng)]]
        if b > 2048:
            picked.update((c, None) for c in order[:per])
            continue
        # the route depends on the distance: split a head of the order
        head = order[:8 * per]
        pairs = [correct.spans(maps[j][2][i:i + 1], maps[j][0])[0]
                 for j, i in head]
        dist = align.distances([p[0] for p in pairs], [p[1] for p in pairs],
                               device)
        taken = {False: 0, True: 0}
        for c, (q, t), d in zip(head, pairs, dist):
            r = align.route(algorithm, b, len(q), len(t), int(d))
            if taken[r] < per:
                picked[c] = None
                taken[r] += 1
    return list(picked)


def cigars_of(maps, sample, device, control=False) -> list[str]:
    """The reference's CIGAR (``myers``) of each sampled overlap."""
    pairs = [correct.spans(maps[j][2][i:i + 1], maps[j][0])[0]
             for j, i in sample]
    paths = align.align_pairs([p[0] for p in pairs], [p[1] for p in pairs],
                              "myers", device, control=control)
    return [align.cigar(p) for p in paths]


def judge_pipeline(jobs, outputs, settings, check, seed, device):
    """-> {name: (value, limit)}; limit None: a count, not compared.
    ``jobs``: the completed jobs' reads; ``outputs``: the entry's outputs,
    {"rows": (n, 8), "cigars": [str]}."""
    maps = job_maps(jobs, settings)
    differing = sum(row_diff(out["rows"], kept)
                    for out, (_, _, kept) in zip(outputs, maps))
    sample = overlap_sample(maps, check, seed, "myers", device)
    ref = cigars_of(maps, sample, device)
    where = [{tuple(r): k for k, r in reversed(list(enumerate(
        np.asarray(o["rows"], np.int64).reshape(-1, 8).tolist())))}
        for o in outputs]
    bad = 0
    for (j, i), want in zip(sample, ref):
        k = where[j].get(tuple(maps[j][2][i].tolist()))
        bad += k is None or outputs[j]["cigars"][k] != want
    held = {int(buckets(maps[j][2][i:i + 1])[0]) for j, i in sample}
    return {"overlap_rows_differing": (differing, LIMIT),
            "cigars_differing": (bad, LIMIT),
            "overlaps_compared": (sum(len(m[2]) for m in maps), None),
            "cigars_compared": (len(sample), None),
            "cigar_buckets": (len(held), None)}


def read_sample(jobs, settings, check, seed) -> list:
    """(job, read) of the reads compared whole: the longest first, then
    in an order drawn from the seed, until ``windows`` windows are held."""
    W = settings["window_length"]
    lens = [(j, r, len(s)) for j, reads in enumerate(jobs)
            for r, (_, s) in enumerate(reads)]
    picks, held = [], 0
    for c in seeded_order([x[2] for x in lens], sample_rng(seed)):
        if held >= check["windows"]:
            break
        picks.append(lens[c][:2])
        held += -(-lens[c][2] // W)
    return picks


def corrected_reads(maps, picks, settings, device, control=False) -> dict:
    """{(job, read): the reference's corrected read} of the picked reads
    (``control``: the consensus tie rule reversed)."""
    W = settings["window_length"]
    by_job: dict[int, list[int]] = {}
    for j, r in picks:
        by_job.setdefault(j, []).append(r)
    # every job's overlaps of the picked reads, aligned in one batch
    sel = {j: np.flatnonzero(np.isin(maps[j][2][:, 0], rids))
           for j, rids in by_job.items()}
    pairs = [p for j in sorted(sel)
             for p in correct.spans(maps[j][2][sel[j]], maps[j][0])]
    paths = iter(align.align_pairs([p[0] for p in pairs],
                                   [p[1] for p in pairs], "banded-escalate",
                                   device))
    path_of = {(j, int(i)): next(paths) for j in sorted(sel) for i in sel[j]}
    out = {}
    for j, rids in sorted(by_job.items()):
        seqs, _, rows = maps[j]
        for r in rids:
            mine = np.flatnonzero(rows[:, 0] == r)
            n_win = -(-len(seqs[r]) // W)
            sup = correct.supports(rows[mine],
                                   [path_of[(j, int(i))] for i in mine],
                                   seqs, settings, range(n_win))
            out[(j, r)] = [(seqs[r][w * W:(w + 1) * W], sup[w], settings,
                            control) for w in range(n_win)]
    keys = list(out)
    pieces = iter(pool_map(_piece, [t for k in keys for t in out[k]],
                           host_workers(device)))
    return {k: "".join(next(pieces) for _ in out[k]) for k in keys}


def _piece(task) -> str:
    return correct.piece(*task)


def host_workers(device) -> int:
    """Processes that the reference's POA windows run in: beside a card,
    the host's cores less one, at most 7; on the host alone (the tests),
    none."""
    if not str(device).startswith("cuda"):
        return 0
    return max(0, min(7, (os.cpu_count() or 1) - 1))


def pool_map(fn, tasks: list, workers: int) -> list:
    """``[fn(t) for t in tasks]``, in ``workers`` forked processes where
    there are two or more; every process has ended when it returns.  The
    workers run NumPy alone, never the card; a forked pool needs no
    resource tracker, so no helper process outlives it."""
    if workers < 2 or len(tasks) < 8 * workers:
        return [fn(t) for t in tasks]
    import multiprocessing as mp
    pool = mp.get_context("fork").Pool(workers)
    try:
        out = pool.map(fn, tasks,
                       chunksize=max(1, len(tasks) // (16 * workers)))
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    return out


def judge_correct(jobs, outputs, settings, check, seed, device):
    """-> {name: (value, limit)}; ``outputs``: {"seqs": corrected reads,
    "rows": (n, 8) the mapper's overlaps} of each job."""
    maps = job_maps(jobs, settings)
    differing = sum(row_diff(out["rows"], rows)
                    for out, (_, rows, _) in zip(outputs, maps))
    picks = read_sample(jobs, settings, check, seed)
    ref = corrected_reads(maps, picks, settings, device)
    bad = 0
    for (j, r), want in ref.items():
        seqs = outputs[j]["seqs"]
        bad += r >= len(seqs) or seqs[r] != want
    missing = sum(abs(len(reads) - len(out["seqs"]))
                  for reads, out in zip(jobs, outputs))
    W = settings["window_length"]
    return {"overlap_rows_differing": (differing, LIMIT),
            "reads_differing": (bad, LIMIT),
            "reads_missing": (missing, LIMIT),
            "overlaps_compared": (sum(len(m[1]) for m in maps), None),
            "reads_compared": (len(picks), None),
            "windows_compared": (sum(-(-len(jobs[j][r][1]) // W)
                                     for j, r in picks), None)}
