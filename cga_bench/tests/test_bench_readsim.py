"""The job generator's law (cga_bench/readsim.py), its agreement with the
port's read simulator, and the pool its worker processes write."""

import hashlib
import json
import os

import numpy as np
import pytest

from cga_bench import harness, readsim, spec
from conftest import ROOT, TINY

LONG = json.load(open(os.path.join(ROOT, "cga_bench", "traffic",
                                   "long10k.json")))
SHORT = json.load(open(os.path.join(ROOT, "cga_bench", "traffic",
                                    "short500.json")))


@pytest.mark.parametrize("traffic", [LONG, SHORT], ids=["long", "short"])
def test_lengths_depth_and_determinism(traffic):
    g = readsim.genome(5, 200_000)
    a = readsim.make_job(5, 3, traffic, g, 64_000)
    b = readsim.make_job(5, 3, traffic, g, 64_000)
    c = readsim.make_job(5, 4, traffic, g, 64_000)
    assert a == b and a != c
    n = readsim.n_reads(traffic)
    assert len(a) == n
    lengths = np.array([int(name.split("_")[3][:-1]) for name, _ in a])
    # every job holds the same lengths, in another order
    other = np.array([int(name.split("_")[3][:-1]) for name, _ in c])
    assert sorted(lengths) == sorted(other)
    depth = lengths.sum() / traffic["segment"]
    assert abs(depth - traffic["depth"]) < 0.02 * traffic["depth"]
    law = traffic["lengths"]
    if law["kind"] == "normal":
        assert abs(lengths.mean() - law["mean"]) < 0.01 * law["mean"]
        assert abs(lengths.std() - law["sd"]) < 0.1 * law["sd"]
    else:
        assert lengths.min() >= law["lo"] and lengths.max() <= law["hi"]
    strands = [name[-1] for name, _ in a]
    assert 0.2 < strands.count("-") / n < 0.8


def test_seeds_past_32_bits_and_distinct_segments():
    starts = readsim.segment_starts(2**40 + 3, 4_641_652, 32_000, 41)
    assert len(set(starts.tolist())) == 41
    assert (starts % 32_000 == 0).all() and starts.max() + 32_000 <= 4_641_652
    assert not np.array_equal(readsim.genome(2**40 + 3, 1000),
                              readsim.genome(2**40 + 4, 1000))


def test_error_split_and_rate():
    rng = np.random.default_rng(0)
    frag = rng.integers(0, 4, 400_000).astype(np.int8)
    out, counts = readsim.add_noise(frag, rng, 0.05, 0.25, 0.25)
    n = len(frag)
    ins, dele = (counts == 2).mean(), (counts == 0).mean()
    assert abs(ins - 0.0125) < 0.0015 and abs(dele - 0.0125) < 0.0015
    keep = counts == 1
    starts = np.cumsum(counts) - counts
    sub = (out[starts[keep]] != frag[keep]).mean() * keep.mean()
    assert abs(sub - 0.025) < 0.002
    assert len(out) == counts.sum() and abs(len(out) - n) < 0.005 * n
    # an insertion keeps its base, then adds one
    i = np.flatnonzero(counts == 2)
    assert (out[starts[i]] == frag[i]).all()


def test_wraps_around_the_segment():
    traffic = dict(SHORT, error_rate=0.0, reverse=0.0, segment=2000)
    g = readsim.genome(9, 10_000)
    seg = "".join("ACGT"[c] for c in g[4000:6000])
    reads = readsim.make_job(9, 0, traffic, g, 4000)
    circ = seg + seg
    wrapped = 0
    for name, s in reads:
        start = int(name.split("_")[2]) - 4000
        assert circ[start:start + len(s)] == s
        wrapped += start + len(s) > 2000
    assert wrapped > 0


def test_law_matches_the_ports_simulator():
    """Error rate, error split and length law against the port's
    NoisyReadSimulator on a seeded sample, within sampling error."""
    from claragenomicsanalysis_tpu_torch.simulators import (
        NoisyReadSimulator, PoissonGenomeSimulator)
    ref = PoissonGenomeSimulator(3).build_reference(60_000)
    sim = NoisyReadSimulator(seed=4, error_rate=0.05)
    theirs = sim.generate_reads(ref, 400, 1000)
    t_len = np.array([len(r.seq) for r in theirs])
    t_frag = np.array([r.reference_end - r.reference_start for r in theirs])
    law = {"kind": "normal", "mean": 1000, "sd": 100}
    ours = readsim.make_job(4, 0, dict(LONG, lengths=law, segment=60_000,
                                       depth=400 * 1000 / 60_000),
                            readsim.genome(4, 60_000), 0)
    o_frag = np.array([int(n.split("_")[3][:-1]) for n, _ in ours])
    o_len = np.array([len(s) for _, s in ours])
    # fragment lengths: the same normal law (sampling error of 400 draws)
    assert abs(o_frag.mean() - t_frag.mean()) < 4 * 100 / np.sqrt(400)
    assert abs(o_frag.std() - t_frag.std()) < 15
    # the noise changes a length by (insertions - deletions): the same
    # mean ratio of read to fragment length
    assert abs((o_len / o_frag).mean() - (t_len / t_frag).mean()) < 0.002
    # the error rate, read against the fragment by edit distance
    from cga_bench.reference.align import bottom_rows, codes
    import torch

    def rate(pairs):
        q = codes([a for a, _ in pairs], max(len(a) for a, _ in pairs),
                  "cpu")
        t = codes([b for _, b in pairs], max(len(b) for _, b in pairs),
                  "cpu", fill=-2)
        ql = torch.tensor([len(a) for a, _ in pairs])
        rows = bottom_rows(q, ql, t)
        d = rows.gather(1, torch.tensor([[len(b)] for _, b in pairs]))
        return float(d.sum()) / sum(len(b) for _, b in pairs)
    from cga_bench.reference.correct import reverse_complement
    theirs_pairs = [(r.seq, ref[r.reference_start:r.reference_end]
                     if r.strand == "+" else reverse_complement(
                         ref[r.reference_start:r.reference_end]))
                    for r in theirs[:40]]
    gen = "".join("ACGT"[c] for c in readsim.genome(4, 60_000))
    ours_pairs = []
    for name, s in ours[:40]:
        start, L = int(name.split("_")[2]), int(name.split("_")[3][:-1])
        frag = (gen + gen)[start:start + L]
        ours_pairs.append((s, reverse_complement(frag)
                           if name.endswith("-") else frag))
    assert abs(rate(ours_pairs) - rate(theirs_pairs)) < 0.006


@pytest.mark.parametrize("traffic,job,digest", [
    (LONG, -1, "d10ecaec0e972dcb"), (LONG, 0, "bdf300e47b91451e"),
    (LONG, 49, "8cedebdee0e48a85"), (SHORT, -1, "55d31d403539c144"),
    (SHORT, 0, "ae22232908517b1f"), (SHORT, 49, "5a3e4e3b9bfebe10")],
    ids=["long-warmup", "long-0", "long-49", "short-warmup", "short-0",
         "short-49"])
def test_jobs_stay_what_every_earlier_run_measured(tmp_path, traffic, job,
                                                   digest):
    """A job's FASTA, byte for byte, as the generator first made it: the
    ledger compares runs across changes of this file only while it holds."""
    seed, g = 2**40 + 7, 4_641_652
    start = readsim.segment_starts(seed, g, traffic["segment"], 51)[job + 1]
    law = dict(traffic, segment=traffic["warmup_segment"]) if job < 0 \
        else traffic
    path = str(tmp_path / "job.fasta")
    readsim.write_fasta(readsim.make_job(seed, job, law,
                                         readsim.genome(seed, g), int(start)),
                        path)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest()[:16] == digest


def serial_pool(seed, traffic, genome_length, workdir):
    """The pool as one process made it before the workers: (reads, FASTA
    bytes) of the warm-up job and every job, in job order."""
    g = readsim.genome(seed, genome_length)
    n = int(traffic["pool_jobs"])
    starts = readsim.segment_starts(seed, genome_length, traffic["segment"],
                                    n + 1)
    out = []
    for j in range(-1, n):
        law = dict(traffic, segment=traffic["warmup_segment"]) if j < 0 \
            else traffic
        reads = readsim.make_job(seed, j, law, g, int(starts[j + 1]))
        path = os.path.join(workdir, f"serial{j + 1}.fasta")
        readsim.write_fasta(reads, path)
        with open(path, "rb") as f:
            out.append((reads, f.read()))
    return out


def pool_cell(traffic, genome_length):
    return spec.Cell("t", 1, {"genome": {"length": genome_length}}, traffic,
                     [], [])


def built_pool(seed, traffic, genome_length, workdir, workers, cores=None):
    """(reads, FASTA bytes) of every job of ``harness.make_pool``."""
    warm, jobs = harness.make_pool(seed, pool_cell(traffic, genome_length),
                                   str(workdir), lambda p: p, workers, cores)
    out = []
    for reads, path in [warm] + jobs:
        with open(path, "rb") as f:
            out.append((reads, f.read()))
    return out


@pytest.mark.parametrize("workers", [1, 3])
def test_parallel_pool_equals_the_serial_one(tmp_path, workers):
    traffic = dict(TINY, pool_jobs=7)
    seed = 2**33 + 17
    want = serial_pool(seed, traffic, 60_000, tmp_path)
    cores = os.sched_getaffinity(0) if hasattr(os, "sched_getaffinity") \
        else None
    got = built_pool(seed, traffic, 60_000, tmp_path, workers, cores)
    assert len(got) == 8
    assert got == want


def test_a_larger_pool_begins_with_the_smaller_one(tmp_path):
    """The first 50 jobs of a 144-job long10k pool are a 50-job pool's:
    the mix's segments and seeds (one read a job keeps the test short)."""
    g = spec.cell("overlap_ont.long10k", ROOT).config["genome"]["length"]
    few = dict(LONG, depth=1, pool_jobs=50)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    small = built_pool(2**40 + 9, few, g, tmp_path / "a", 3)
    large = built_pool(2**40 + 9, dict(few, pool_jobs=144), g,
                       tmp_path / "b", 3)
    assert len(small) == 51 and len(large) == 145
    assert large[:51] == small


@pytest.mark.parametrize("sound", [True, False], ids=["sound", "failing"])
def test_no_worker_outlives_the_pool(tmp_path, monkeypatch, sound):
    started = []
    popen = readsim.subprocess.Popen

    def record(*args, **kwargs):
        started.append(popen(*args, **kwargs))
        return started[-1]
    monkeypatch.setattr(readsim.subprocess, "Popen", record)
    traffic = dict(TINY, pool_jobs=5)
    if not sound:
        traffic["lengths"] = dict(traffic["lengths"], kind="unknown")
        with pytest.raises(RuntimeError, match="pool worker"):
            built_pool(3, traffic, 60_000, tmp_path, 3)
    else:
        assert len(built_pool(3, traffic, 60_000, tmp_path, 3)) == 6
    assert len(started) == 3
    for p in started:
        assert p.returncode is not None
        with pytest.raises(ProcessLookupError):
            os.kill(p.pid, 0)


def test_the_long10k_pool_fits_the_genome():
    """144 jobs and the warm-up take every 32,000-base segment of E. coli's
    4,641,652 bases; one job more does not fit."""
    g = spec.cell("correct_ont.long10k", ROOT).config["genome"]["length"]
    assert LONG["pool_jobs"] == 144 and SHORT["pool_jobs"] == 80
    assert LONG["pool_jobs"] + 1 == g // LONG["segment"]
    starts = readsim.segment_starts(2**31 + 5, g, LONG["segment"],
                                    LONG["pool_jobs"] + 1)
    assert len(set(starts.tolist())) == 145
    with pytest.raises(ValueError):
        readsim.segment_starts(2**31 + 5, g, LONG["segment"],
                               LONG["pool_jobs"] + 2)
