"""The job generator's law (cga_bench/readsim.py) and its agreement with
the port's read simulator."""

import json
import os

import numpy as np
import pytest

from cga_bench import readsim
from conftest import ROOT

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
