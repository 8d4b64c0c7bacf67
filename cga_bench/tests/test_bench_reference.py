"""The plain reference against the port on the CPU at small sizes: the
same overlaps, the same paths on both of the aligners' routes, the same
POA consensus; and its control, which has to differ."""

import numpy as np
import pytest

from cga_bench import readsim
from cga_bench.reference import align, correct, judge, mapper, poa
from conftest import TINY

MAPPER = {"kmer_size": 15, "window_size": 15, "hash_representations": True,
          "filtering_parameter": 1.0, "min_residues": 4,
          "min_overlap_len": 50, "min_bases_per_residue": 100,
          "min_overlap_fraction": 0.8, "max_anchor_gap": 5000,
          "index_size_mb": 30, "skip_self_mappings": True}


def job(law, segment=4000, depth=8, seed=21):
    traffic = dict(TINY, lengths=law, segment=segment, depth=depth)
    return readsim.make_job(seed, 0, traffic, readsim.genome(seed, 50_000),
                            8000)


@pytest.mark.parametrize("law", [{"kind": "normal", "mean": 1500, "sd": 150},
                                 {"kind": "uniform", "lo": 250, "hi": 500}],
                         ids=["long", "short"])
def test_mapper_equals_the_port(law):
    from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
    from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                          FastaSequence)
    from claragenomicsanalysis_tpu_torch.models.mapper import map_all_vs_all
    reads = job(law)
    parser = FastaParser("", records=[FastaSequence(n, s) for n, s in reads])
    port = map_all_vs_all(parser, MapperConfig(**MAPPER), device="cpu").rows
    ref = mapper.map_all_vs_all([s for _, s in reads], MAPPER)
    assert len(ref) > 20
    assert judge.row_diff(port.T, ref) == 0
    assert np.array_equal(port.T.astype(np.int64), ref)


def _pairs():
    """Spans of a tiny job that reach both routes: buckets of 2048 and
    4096 (Hirschberg) and of 512 and 1024 (banded, dense path)."""
    reads = job({"kind": "normal", "mean": 2600, "sd": 600}, segment=6000,
                depth=6, seed=33)
    seqs = [s for _, s in reads]
    rows = mapper.map_all_vs_all(seqs, MAPPER)
    spans = correct.spans(rows, seqs)
    by_bucket = {}
    for q, t in spans:
        by_bucket.setdefault(align.span_bucket(len(q), len(t)), []).append(
            (q, t))
    out = []
    for b in sorted(by_bucket):
        out += by_bucket[b][:3]
    return out


@pytest.fixture(scope="module")
def pairs():
    return _pairs()


@pytest.mark.parametrize("algorithm", ["myers", "banded-escalate"])
def test_paths_equal_the_ports_aligner(pairs, algorithm):
    from claragenomicsanalysis_tpu_torch.core.status import StatusType
    from claragenomicsanalysis_tpu_torch.models.aligner import create_aligner
    buckets = {align.span_bucket(len(q), len(t)) for q, t in pairs}
    assert max(buckets) >= 4096 and min(buckets) <= 1024
    ref = align.align_pairs([q for q, _ in pairs], [t for _, t in pairs],
                            algorithm, "cpu")
    routes = set()
    for (q, t), path in zip(pairs, ref):
        L = align.span_bucket(len(q), len(t))
        a = create_aligner(L, L, 1, band_radius=min(256, L),
                           algorithm=algorithm, device="cpu")
        a.add_alignment(q, t)
        got = a.get_alignments()[0]
        assert got.status == StatusType.SUCCESS
        assert got.path == path, (len(q), len(t), L)
        assert align.cigar(path) == got.convert_to_cigar()
        qd = align.codes([q], len(q), "cpu")
        td = align.codes([t], len(t), "cpu", fill=-2)
        import torch
        d = int(align.bottom_rows(qd, torch.tensor([len(q)]), td)[0, len(t)])
        routes.add(align.route(algorithm, L, len(q), len(t), d) or L > 2048)
    assert routes == {True, False}


def test_control_paths_are_optimal_but_not_canonical(pairs):
    qs, ts = [q for q, _ in pairs], [t for _, t in pairs]
    ref = align.align_pairs(qs, ts, "myers", "cpu")
    ctl = align.align_pairs(qs, ts, "myers", "cpu", control=True)
    assert [sum(1 for c in p if c) for p in ref] == \
        [sum(1 for c in p if c) for p in ctl]
    assert sum(a != b for a, b in zip(ref, ctl)) >= len(pairs) // 4


def test_poa_consensus_equals_the_ports_batch():
    from claragenomicsanalysis_tpu_torch.core.config import BatchSize
    from claragenomicsanalysis_tpu_torch.core.status import StatusType
    from claragenomicsanalysis_tpu_torch.models.poa import create_batch
    rng = np.random.default_rng(5)
    windows = []
    for depth in (3, 5, 9):
        for _ in range(3):
            base = "".join("ACGT"[c] for c in rng.integers(0, 4, 120))
            seqs = []
            for _ in range(depth):
                codes = np.array(["ACGT".index(c) for c in base], np.int8)
                noisy, _ = readsim.add_noise(codes, rng, 0.08, 0.25, 0.25)
                seqs.append("".join("ACGT"[c] for c in noisy))
            windows.append(seqs)
    for seqs in windows:
        d = correct.depth_bucket(len(seqs), 15)
        bs = BatchSize(max_sequence_size=256, max_nodes_per_window=384,
                       max_sequences_per_poa=d, max_pred_per_node=max(4, d),
                       max_aligned_per_node=max(4, d // 2))
        b = create_batch(batch_size=bs, max_poas=1, device="cpu")
        b.add_poa_group(seqs)
        b.generate_poa()
        cons, _, st = b.get_consensus()
        ref, ok = poa.consensus(seqs, 384, max(4, d), max(4, d // 2), d, 256)
        assert ok == (st[0] == StatusType.SUCCESS)
        assert cons[0] == ref


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(pairs, cuda_device):
    qs, ts = [q for q, _ in pairs], [t for _, t in pairs]
    for algorithm in ("myers", "banded-escalate"):
        assert align.align_pairs(qs, ts, algorithm, cuda_device) == \
            align.align_pairs(qs, ts, algorithm, "cpu")


def _square(x):
    return x * x


def test_pool_map_equals_one_process_and_leaves_none_behind():
    import multiprocessing as mp
    tasks = list(range(40))
    assert judge.pool_map(_square, tasks, 2) == [x * x for x in tasks]
    assert mp.active_children() == []
    assert judge.host_workers("cpu") == 0
