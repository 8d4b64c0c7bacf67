"""The port's mapper on the card against its CPU run (which the CPU tests
hold against the JAX package) and the two map goldens on ``--device cuda``.
Every test needs an NVIDIA GPU and skips without one:

    JAX_PLATFORMS=cpu python -m pytest -m cuda tests/test_torch_mapper_cuda.py
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                      FastaSequence)
from claragenomicsanalysis_tpu_torch.models import mapper
from claragenomicsanalysis_tpu_torch.ops import map_ops, sketch
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)
from claragenomicsanalysis_tpu_torch.utils.genomeutils import encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
MAP_ARGS = ["-k", "15", "-w", "5", "--min-overlap-len", "100",
            "--min-overlap-fraction", "0.3", "--min-bases-per-residue", "500"]

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mapper's card run")


@pytest.fixture(scope="module")
def parser():
    """120 noisy reads of about 3 kb, both strands, from a 60 kb genome."""
    genome = PoissonGenomeSimulator(seed=21).build_reference(60_000)
    sim = NoisyReadSimulator(seed=21, error_rate=0.05)
    return FastaParser("<mem>", records=[
        FastaSequence(r.name, r.seq)
        for r in sim.generate_reads(genome, 120, 3000)])


def _both(fn):
    """fn(device) on the card and on the CPU: (cuda result, cpu result)."""
    return fn("cuda"), fn("cpu")


@pytest.mark.parametrize("case", ["unsplit", "chunked", "overflow",
                                  "query_vs_target"])
def test_map_on_card_equals_cpu(parser, case):
    cfg = MapperConfig(min_overlap_fraction=0.8,
                       index_size_mb=0.05 if case == "chunked" else 30)
    if case == "query_vs_target":
        half = FastaParser("<mem>", records=[
            parser.get_sequence_by_id(i) for i in range(60)])
        cuda, cpu = _both(lambda d: mapper.map_query_vs_target(
            half, parser, cfg, target_index_size_mb=0.1, device=d))
    else:
        cap = 20_000 if case == "overflow" else 1 << 24
        cuda, cpu = _both(lambda d: mapper.map_all_vs_all(
            parser, cfg, max_anchors=cap, device=d))
    assert np.array_equal(cuda.rows, cpu.rows) and cuda.rows.shape[1] > 0
    assert cuda.statuses == cpu.statuses
    if case == "overflow":
        assert any(s.name == "EXCEEDED_MAX_ANCHORS" for s in cuda.statuses)


@pytest.mark.parametrize("F", [1.0, 0.001])
def test_ops_on_card_equal_cpu(parser, F):
    """Each op's arrays on the card equal the CPU's: the sketch, the index
    (filtered and not), the match ranges and anchors, the chain and the
    compaction."""
    seqs = [parser.get_sequence_by_id(i).seq for i in range(40)]
    L = max(map(len, seqs))
    reads = np.full((len(seqs), L), -1, dtype=np.int8)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = encode(s)
    lens = torch.tensor([len(s) for s in seqs])
    cfg = MapperConfig(filtering_parameter=F)
    from fractions import Fraction
    frac = Fraction(F).limit_denominator(10**6)

    def run(dev):
        sk = sketch.sketch_batch(torch.from_numpy(reads).to(dev),
                                 lens.to(dev), cfg.kmer_size,
                                 cfg.window_size)
        idx = map_ops.build_index(*sk, 5, frac.numerator, frac.denominator)
        lo, cum, total = map_ops.match_count(idx, idx)
        a = map_ops.match_expand(idx, idx, lo, cum, int(total) + 50)
        out = map_ops.chain_anchors(a, 15, 4, 50, 100, 19, 20, 5000)
        stacked, nv = map_ops.compact_overlaps(out)
        return [x.cpu() for x in (*sk, *idx.values(), lo, cum,
                                  *a.values(), *out.values(), stacked, nv)]

    cuda, cpu = _both(run)
    assert len(cuda) == len(cpu)
    for x, y in zip(cuda, cpu):
        assert torch.equal(x, y)


def test_murmur32_on_card_equals_cpu():
    x = torch.cat([torch.tensor([0, 2**31 - 1, 2**31, 2**32 - 1]),
                   torch.randint(0, 2**32, (1 << 16,))])
    assert torch.equal(sketch.murmur32(x.cuda()).cpu(), sketch.murmur32(x))


@pytest.mark.parametrize("inputs,golden", [
    (["sample_reads.fasta"], "sample_overlaps.paf"),
    (["sample_reads.fasta", "sample_targets.fasta"], "sample_qt.paf")])
def test_cli_map_golden_on_card(inputs, golden):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["map"] + [os.path.join(DATA, f) for f in inputs]
                        + MAP_ARGS + ["--device", "cuda"]) == 0
    with open(os.path.join(DATA, "golden", golden)) as f:
        assert buf.getvalue() == f.read()
