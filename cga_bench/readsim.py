"""Jobs of noisy reads from a random genome, made from ``(seed, job)``.

A frozen, vectorised copy of the law of the port's read simulator
(``claragenomicsanalysis_tpu_torch/simulators/readsim.py``,
``NoisyReadSimulator._add_noise``): every base of a read's fragment is, with
probability ``error_rate``, an error, and an error is an insertion (the base
and then a uniformly random base), a deletion (the base dropped) or a
substitution (one of the three other bases, uniformly), with the shares
``ins`` / ``del`` / the rest.  The fragment is the read's stretch of the
reference, reverse-complemented with probability ``reverse``.  The genome is
iid uniform over ACGT, as the port's ``PoissonGenomeSimulator`` makes it.

Where the port's simulator draws each read's length and start on its own,
this generator gives every job the same multiset of lengths (the length
law's quantiles at (i + 0.5) / n) in an order drawn from the seed, and
stratified starts, so that two seeds do the same amount of work in another
order.  A job is the reads of one circular segment of the genome: a read
may run over the segment's end and go on at its start.

A run's pool of jobs is written as FASTA by worker processes
(:func:`write_pool`), each this file run as a script on its share of the
jobs, while the caller reads the files in job order; a job depends on
``(seed, job)`` and its segment alone, so the files are the same at any
number of workers.
"""

import json
import os
import subprocess
import sys

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.array([3, 2, 1, 0], np.int8)


def job_rng(seed: int, job: int) -> np.random.Generator:
    """The generator of job ``job`` of a run with ``seed`` (job -1 is the
    warm-up job)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), 0, job + 1])


def genome(seed: int, length: int) -> np.ndarray:
    """(length,) int8 codes of the run's iid genome."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 1])
    return rng.integers(0, 4, size=length, dtype=np.int8)


def segment_starts(seed: int, genome_length: int, segment: int,
                   n_jobs: int) -> np.ndarray:
    """Start of each job's segment: distinct, non-overlapping slots of the
    genome in an order drawn from the seed (job -1, the warm-up, first)."""
    slots = genome_length // segment
    if n_jobs > slots:
        raise ValueError(f"{n_jobs} jobs of {segment} bases do not fit a "
                         f"genome of {genome_length}")
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 2])
    return rng.permutation(slots)[:n_jobs] * segment


def read_lengths(law: dict, n: int) -> np.ndarray:
    """The n quantiles of the length law at (i + 0.5) / n, ascending."""
    u = (np.arange(n) + 0.5) / n
    kind = law["kind"]
    if kind == "normal":
        from statistics import NormalDist
        nd = NormalDist(law["mean"], law["sd"])
        x = np.array([nd.inv_cdf(p) for p in u])
    elif kind == "uniform":
        x = law["lo"] + u * (law["hi"] - law["lo"])
    else:
        raise ValueError(f"unknown length law {kind!r}")
    return np.clip(np.rint(x), law.get("min", 32), None).astype(np.int64)


def n_reads(traffic: dict) -> int:
    """Reads a job: depth x segment over the mean length."""
    lengths = read_lengths(traffic["lengths"], 4096)
    return max(1, round(traffic["depth"] * traffic["segment"]
                        / float(lengths.mean())))


def add_noise(frag: np.ndarray, rng: np.random.Generator, error_rate: float,
              ins: float, dele: float) -> tuple[np.ndarray, np.ndarray]:
    """The simulator's error law over int8 codes: (noisy codes, the number
    of output bases each input base became)."""
    n = len(frag)
    err = np.flatnonzero(rng.random(n) < error_rate)
    kind = rng.random(len(err))
    is_ins = err[kind < ins]
    is_del = err[(kind >= ins) & (kind < ins + dele)]
    is_sub = err[kind >= ins + dele]
    base = frag.copy()
    # a substitution takes one of the three other bases uniformly
    base[is_sub] = (frag[is_sub] + rng.integers(1, 4, len(is_sub),
                                                dtype=np.int8)) % 4
    counts = np.ones(n, np.int64)
    counts[is_del] = 0
    counts[is_ins] = 2
    out = np.repeat(base, counts)
    # the inserted base follows its base: the second copy of each insertion
    ends = np.cumsum(counts)
    out[ends[is_ins] - 1] = rng.integers(0, 4, len(is_ins), dtype=np.int8)
    return out, counts


def make_job(seed: int, job: int, traffic: dict, genome_codes: np.ndarray,
             start: int) -> list[tuple[str, str]]:
    """(name, sequence) of every read of one job."""
    rng = job_rng(seed, job)
    seg_len = traffic["segment"]
    seg = genome_codes[start:start + seg_len]
    circ = np.concatenate([seg, seg])
    n = n_reads(traffic)
    lengths = np.minimum(rng.permutation(read_lengths(traffic["lengths"], n)),
                         seg_len)
    # stratified starts: one in each of n equal slices, in a random order
    starts = ((rng.permutation(n) + rng.random(n)) * seg_len / n).astype(
        np.int64)
    reverse = rng.random(n) < traffic["reverse"]
    # every read's fragment, one after another, then the noise over all
    frags = np.concatenate([
        COMPLEMENT[circ[s:s + L][::-1]] if r else circ[s:s + L]
        for s, L, r in zip(starts.tolist(), lengths.tolist(),
                           reverse.tolist())])
    codes, counts = add_noise(frags, rng, traffic["error_rate"],
                              traffic["ins"], traffic["del"])
    out_len = np.add.reduceat(counts, np.cumsum(lengths) - lengths)
    text = BASES[codes].tobytes().decode()
    ends = np.cumsum(out_len).tolist()
    return [(f"j{job}_r{i}_{start + s}_{L}{'-' if r else '+'}",
             text[e - k:e])
            for i, (s, L, r, e, k) in enumerate(zip(
                starts.tolist(), lengths.tolist(), reverse.tolist(), ends,
                out_len.tolist()))]


def write_fasta(reads: list[tuple[str, str]], path: str) -> None:
    with open(path, "w") as f:
        f.write("".join(f">{name}\n{seq}\n" for name, seq in reads))


def read_fasta(path: str) -> list[tuple[str, str]]:
    """(name, sequence) of every read of a file that :func:`write_fasta`
    wrote."""
    with open(path) as f:
        lines = f.read().split("\n")
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines) - 1, 2)]


def job_path(workdir: str, job: int) -> str:
    return os.path.join(workdir, f"job{job + 1}.fasta")


def write_jobs(seed: int, traffic: dict, genome_length: int, jobs, workdir: str
               ) -> None:
    """Make and write every ``(job, start)`` of ``jobs`` in order, and name
    each job on standard output once its file is written; job -1, the
    warm-up, is the mix's law on a segment of ``warmup_segment`` bases."""
    codes = genome(seed, genome_length)
    for job, start in jobs:
        law = (dict(traffic, segment=traffic["warmup_segment"]) if job < 0
               else traffic)
        write_fasta(make_job(seed, job, law, codes, start),
                    job_path(workdir, job))
        print(job, flush=True)


def write_pool(seed: int, traffic: dict, genome_length: int, workdir: str,
               workers: int, cores=None):
    """Yield the FASTA path of the warm-up job and then of each of the mix's
    ``pool_jobs`` jobs, in job order, each once it is written under
    ``workdir``.  ``workers`` processes write them, on the cores ``cores``
    (None: the caller's); every process has ended when the generator is
    exhausted or closed.

    A worker is this file run as a script, not a ``multiprocessing`` child:
    a spawned child runs the caller's main script again (the benchmark's
    pinning and imports), and a forked one copies a process that may hold
    a CUDA context.  A worker inherits its caller's affinity, one core in a
    benchmark run, so it takes ``cores`` back first."""
    n = int(traffic["pool_jobs"])
    starts = segment_starts(seed, genome_length, traffic["segment"], n + 1)
    jobs = [(j, int(starts[j + 1])) for j in range(-1, n)]
    workers = max(1, min(workers, len(jobs)))
    procs = []
    try:
        for w in range(workers):
            args = {"seed": int(seed), "traffic": traffic,
                    "genome_length": genome_length, "jobs": jobs[w::workers],
                    "workdir": workdir,
                    "cores": sorted(cores) if cores else None}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), json.dumps(args)],
                stdout=subprocess.PIPE, text=True))
        # worker w writes jobs w, w + workers, ... in order: the next line
        # of job i's worker names it once its file is whole
        for i, (job, _) in enumerate(jobs):
            if procs[i % workers].stdout.readline().strip() != str(job):
                raise RuntimeError(f"pool worker {i % workers} ended before "
                                   f"job {job} (exit code "
                                   f"{procs[i % workers].wait()})")
            yield job_path(workdir, job)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            p.wait()
            p.stdout.close()
    failed = [p.returncode for p in procs if p.returncode]
    if failed:
        raise RuntimeError(f"{len(failed)} of {workers} pool workers failed "
                           f"(exit codes {failed})")


if __name__ == "__main__":
    _args = json.loads(sys.argv[1])
    if _args["cores"] is not None:
        os.sched_setaffinity(0, _args["cores"])
    write_jobs(_args["seed"], _args["traffic"], _args["genome_length"],
               _args["jobs"], _args["workdir"])
