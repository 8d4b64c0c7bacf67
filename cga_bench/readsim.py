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
"""

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
    is_ins = np.zeros(n, bool)
    is_del = np.zeros(n, bool)
    is_sub = np.zeros(n, bool)
    is_ins[err[kind < ins]] = True
    is_del[err[(kind >= ins) & (kind < ins + dele)]] = True
    is_sub[err[kind >= ins + dele]] = True
    base = frag.copy()
    # a substitution takes one of the three other bases uniformly
    base[is_sub] = (frag[is_sub] + rng.integers(1, 4, int(is_sub.sum()),
                                                dtype=np.int8)) % 4
    counts = np.where(is_del, 0, np.where(is_ins, 2, 1))
    out = np.repeat(base, counts)
    # the inserted base follows its base: the second copy of each insertion
    ends = np.cumsum(counts)
    out[ends[is_ins] - 1] = rng.integers(0, 4, int(is_ins.sum()),
                                         dtype=np.int8)
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
    first = np.cumsum(lengths) - lengths
    pos = np.arange(int(lengths.sum())) - np.repeat(first, lengths)
    rev = np.repeat(reverse, lengths)
    idx = np.repeat(starts, lengths) + np.where(
        rev, np.repeat(lengths, lengths) - 1 - pos, pos)
    frags = np.where(rev, COMPLEMENT[circ[idx]], circ[idx])
    codes, counts = add_noise(frags, rng, traffic["error_rate"],
                              traffic["ins"], traffic["del"])
    out_len = np.add.reduceat(counts, first)
    text = BASES[codes].tobytes().decode()
    ends = np.cumsum(out_len)
    reads = []
    for i in range(n):
        name = (f"j{job}_r{i}_{start + starts[i]}_{int(lengths[i])}"
                f"{'-' if reverse[i] else '+'}")
        reads.append((name, text[ends[i] - out_len[i]:ends[i]]))
    return reads


def write_fasta(reads: list[tuple[str, str]], path: str) -> None:
    with open(path, "w") as f:
        f.write("".join(f">{name}\n{seq}\n" for name, seq in reads))
