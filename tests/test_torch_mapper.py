"""The port's mapper (claragenomicsanalysis_tpu_torch/models/mapper.py, cli
map) against the JAX package's ``models/mapper.py``, ``cpu/mapper_oracle``
and the two map goldens, on the CPU.  Every comparison is exact."""

import contextlib
import io
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core.config import MapperConfig as JaxCfg
from claragenomicsanalysis_tpu.cpu import mapper_oracle
from claragenomicsanalysis_tpu.io.fasta import FastaParser as JaxParser
from claragenomicsanalysis_tpu.io.fasta import FastaSequence as JaxSeq
from claragenomicsanalysis_tpu.models import mapper as jax_mapper
from claragenomicsanalysis_tpu.parallel import index_store as jax_store
from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
from claragenomicsanalysis_tpu_torch.core.status import StatusType
from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                      FastaSequence)
from claragenomicsanalysis_tpu_torch.models import mapper
from claragenomicsanalysis_tpu_torch.parallel import index_store
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
MAP_ARGS = ["-k", "15", "-w", "5", "--min-overlap-len", "100",
            "--min-overlap-fraction", "0.3", "--min-bases-per-residue", "500"]
CFG = dict(min_overlap_fraction=0.8, min_residues=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these small shapes run on one thread: pytest-
    xdist runs several test processes at once, and torch's default pool of
    a thread a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reads():
    """32 noisy reads of about 1.5 kb, both strands, from a 12 kb genome."""
    genome = PoissonGenomeSimulator(seed=3).build_reference(12_000)
    sim = NoisyReadSimulator(seed=3, error_rate=0.05)
    rs = sim.generate_reads(genome, 32, 1500)
    assert {r.strand for r in rs} == {"+", "-"}
    return [(r.name, r.seq) for r in rs]


def parsers(recs):
    return (FastaParser("<mem>", records=[FastaSequence(*r) for r in recs]),
            JaxParser("<mem>", records=[JaxSeq(*r) for r in recs]))


@pytest.fixture(scope="module")
def jax_rows(reads):
    _, jp = parsers(reads)
    res = jax_mapper.map_all_vs_all(jp, JaxCfg(**CFG))
    return res.rows, res.statuses


def test_map_all_vs_all_equals_jax_and_oracle(reads, jax_rows):
    tp, _ = parsers(reads)
    res = mapper.map_all_vs_all(tp, MapperConfig(**CFG), device="cpu")
    rows, statuses = jax_rows
    assert np.array_equal(res.rows, rows)
    assert res.statuses == statuses == [StatusType.SUCCESS]
    assert set(res.rows[7].tolist()) == {0, 1}       # both strands
    oracle = mapper_oracle.map_all_vs_all([s for _, s in reads],
                                          JaxCfg(**CFG))
    assert [o.key() + (o.num_residues,) for o in res.overlaps] == \
        [o.key() + (o.num_residues,) for o in oracle]
    assert res.overlaps == mapper.Overlapper.rows_to_overlaps(res.rows)


def test_chunked_run_equals_unsplit(reads, jax_rows):
    """A 10 kb index budget splits the reads into 6 chunks (36 pairs)."""
    tp, _ = parsers(reads)
    cfg = MapperConfig(**CFG, index_size_mb=0.01)
    assert len(tp.get_chunks(cfg.index_size_mb * 1_000_000)) == 6
    res = mapper.map_all_vs_all(tp, cfg, device="cpu")
    assert np.array_equal(res.rows, jax_rows[0])
    assert len(res.statuses) == 36 and res.cache_misses == 6


def test_anchor_overflow_equals_jax(reads):
    """max_anchors below a pair's count: the same kept anchors' rows and
    EXCEEDED_MAX_ANCHORS, as the JAX driver gives."""
    tp, jp = parsers(reads)
    cfg = MapperConfig(**CFG)
    idx = mapper.Index.create_index(tp, 0, len(reads), cfg, device="cpu")
    full = mapper.Matcher.create_matcher(idx, idx, cfg, cap=1 << 30,
                                         device="cpu")
    cap = full.n_anchors // 2
    res = mapper.map_all_vs_all(tp, cfg, max_anchors=cap, device="cpu")
    want = jax_mapper.map_all_vs_all(jp, JaxCfg(**CFG), max_anchors=cap)
    assert res.statuses == want.statuses == [
        StatusType.EXCEEDED_MAX_ANCHORS]
    assert np.array_equal(res.rows, want.rows) and res.rows.shape[1] > 0
    m = mapper.Matcher.create_matcher(idx, idx, cfg, cap=cap, device="cpu")
    assert (m.n_anchors, m.cap_used, m.overflow, m.truncated) == (
        full.n_anchors, cap, True, False)


def test_map_query_vs_target_equals_jax(reads):
    """One target chunk and, by a 4 kb target budget, several: both give the
    JAX driver's rows (its output does not depend on the batching)."""
    tq, jq = parsers(reads[:16])       # 16 and 16: one JAX index shape
    tt, jt = parsers(reads[16:])
    want = jax_mapper.map_query_vs_target(jq, jt, JaxCfg(**CFG))
    assert want.rows.shape[1] > 0
    for t_mb, n_pairs in ((None, 1), (0.004, 8)):
        res = mapper.map_query_vs_target(
            tq, tt, MapperConfig(**CFG), target_index_size_mb=t_mb,
            device="cpu")
        assert np.array_equal(res.rows, want.rows)
        assert res.statuses == [StatusType.SUCCESS] * n_pairs


def test_index_views_equal_jax(reads):
    tp, jp = parsers(reads)
    ours = mapper.Index.create_index(tp, 4, 20, MapperConfig(**CFG),
                                     device="cpu")
    theirs = jax_mapper.Index.create_index(jp, 4, 20, JaxCfg(**CFG))
    assert ours.n_elems == theirs.n_elems
    for view in ("representations", "read_ids", "positions_in_reads",
                 "directions_of_reads", "unique_representations",
                 "first_occurrence_of_representations"):
        assert np.array_equal(getattr(ours, view)(),
                              getattr(theirs, view)()), view
    assert (ours.read_lengths, ours.read_names, ours.number_of_reads()) == (
        theirs.read_lengths, theirs.read_names, theirs.number_of_reads())


def test_fuse_and_rescue_equal_jax(reads, jax_rows):
    tp, jp = parsers(reads)
    rows = jax_rows[0]
    for gap in (0, 500, 5000):
        assert np.array_equal(mapper.Overlapper.fuse_overlap_rows(rows, gap),
                              jax_mapper.Overlapper.fuse_overlap_rows(rows,
                                                                      gap))
    ours = mapper.Overlapper.rows_to_overlaps(rows)
    theirs = jax_mapper.Overlapper.rows_to_overlaps(rows)
    assert [vars(o) for o in mapper.Overlapper.fuse_overlaps(ours, 300)] == \
        [vars(o) for o in jax_mapper.Overlapper.fuse_overlaps(theirs, 300)]
    assert [vars(o) for o in mapper.Overlapper.filter_overlaps(
        ours, 8, 900)] == [vars(o) for o in jax_mapper.Overlapper
                           .filter_overlaps(theirs, 8, 900)]
    for ext, sim in ((50, 0.85), (200, 0.3)):
        a = mapper.Overlapper.rescue_overlap_ends(ours, tp, ext, sim)
        b = jax_mapper.Overlapper.rescue_overlap_ends(theirs, jp, ext, sim)
        assert [vars(o) for o in a] == [vars(o) for o in b]
    pairs = [(reads[i][1][:300], reads[i + 1][1][-300:]) for i in range(8)]
    assert np.array_equal(mapper._similarity_batch(pairs, 4),
                          jax_mapper._similarity_batch(pairs, 4))
    assert mapper.sequence_similarity("ACGTN" * 9, "acgt" * 9, 3) == \
        jax_mapper.sequence_similarity("ACGTN" * 9, "acgt" * 9, 3)


def test_index_store_round_trip(reads, jax_rows, tmp_path):
    """An index stored by the JAX package loads in the port (the .npz
    layout is shared), and the port's own store round-trips; runs through
    the store give the unstored rows."""
    tp, jp = parsers(reads)
    cfg, jcfg = MapperConfig(**CFG), JaxCfg(**CFG)
    key = index_store.index_key(tp, 0, 32, cfg)
    assert key == jax_store.index_key(jp, 0, 32, jcfg)
    jax_store.save_index(jax_mapper.Index.create_index(jp, 0, 32, jcfg),
                         str(tmp_path), key)
    loaded = index_store.load_index(str(tmp_path), key, device="cpu")
    built = mapper.Index.create_index(tp, 0, 32, cfg, device="cpu")
    for k in ("rep", "read_id", "pos", "dir"):
        assert torch.equal(loaded._arrays[k], built._arrays[k]), k
    res = mapper.map_all_vs_all(tp, cfg, index_store_dir=str(tmp_path),
                                device="cpu")
    assert np.array_equal(res.rows, jax_rows[0])
    own = tmp_path / "own"
    idx, cached = index_store.get_or_build(tp, 3, 9, cfg, str(own), "cpu")
    again, cached2 = index_store.get_or_build(tp, 3, 9, cfg, str(own), "cpu")
    assert (cached, cached2) == (False, True)
    assert again.n_elems == idx.n_elems and all(
        torch.equal(again._arrays[k], idx._arrays[k])
        for k in ("rep", "read_id", "pos", "dir"))


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("inputs,golden", [
    (["sample_reads.fasta"], "sample_overlaps.paf"),
    (["sample_reads.fasta", "sample_targets.fasta"], "sample_qt.paf")])
def test_cli_map_golden_on_cpu(inputs, golden):
    out = _cli(["map"] + [os.path.join(DATA, f) for f in inputs] + MAP_ARGS
               + ["--device", "cpu"])
    with open(os.path.join(DATA, "golden", golden)) as f:
        assert out == f.read()


def test_cli_map_options(tmp_path, capsys):
    """--fuse-overlaps, --rescue-overlap-ends and -c: the JAX CLI's steps
    in its order (rows fused, then ends rescued), each step held against
    the JAX function by test_fuse_and_rescue_equal_jax; the rescue warning
    in query-vs-target mode."""
    reads = os.path.join(DATA, "sample_reads.fasta")
    extra = ["--fuse-overlaps", "--fusion-max-gap", "2000",
             "--rescue-overlap-ends", "-c", str(tmp_path / "store")]
    ours = _cli(["map", reads] + MAP_ARGS + extra + ["--device", "cpu"])
    parser = FastaParser(reads)
    res = mapper.map_all_vs_all(parser, _cfg_of(MAP_ARGS), device="cpu")
    ovs = mapper.Overlapper.rescue_overlap_ends(
        mapper.Overlapper.rows_to_overlaps(
            mapper.Overlapper.fuse_overlap_rows(res.rows, 2000)), parser)
    want = "".join(r + "\n" for r in mapper.overlaps_to_paf(ovs, parser))
    assert ours == want and ours != _cli(["map", reads] + MAP_ARGS
                                         + ["--device", "cpu"])
    assert len(os.listdir(tmp_path / "store")) == 1
    capsys.readouterr()
    _cli(["map", reads, os.path.join(DATA, "sample_targets.fasta"),
          "--rescue-overlap-ends", "--device", "cpu"] + MAP_ARGS)
    assert "all-vs-all only" in capsys.readouterr().err


def _cfg_of(argv):
    import argparse
    p = argparse.ArgumentParser()
    cli._add_mapper_flags(p)
    return cli._mapper_cfg(p.parse_args(argv))


@pytest.mark.parametrize("entry", ["create_index", "create_matcher",
                                   "map_all_vs_all", "map_query_vs_target",
                                   "cli"])
def test_cuda_request_raises_without_card(entry, reads):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tp, _ = parsers(reads[:4])
    cfg = MapperConfig(**CFG)
    calls = {
        "create_index": lambda: mapper.Index.create_index(tp, 0, 4, cfg),
        "create_matcher": lambda: mapper.Matcher.create_matcher(
            *[mapper.Index.create_index(tp, 0, 4, cfg, device="cpu")] * 2,
            cfg),
        "map_all_vs_all": lambda: mapper.map_all_vs_all(tp, cfg),
        "map_query_vs_target": lambda: mapper.map_query_vs_target(tp, tp,
                                                                  cfg),
        "cli": lambda: cli.main(["map", os.path.join(
            DATA, "sample_reads.fasta")]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_config_k_checks_and_defaults():
    """The two min_overlap_fraction defaults (config 0.95, CLI 0.8) and the
    flags' mapping onto MapperConfig, as in the JAX CLI."""
    import argparse
    from claragenomicsanalysis_tpu import cli as jax_cli
    assert MapperConfig().min_overlap_fraction == 0.95
    for argv in ([], MAP_ARGS + ["-F", "0.002", "--no-hashing", "-i", "3",
                                 "--min-residues", "6",
                                 "--max-anchor-gap", "900"]):
        ps = []
        for mod in (cli, jax_cli):
            p = argparse.ArgumentParser()
            mod._add_mapper_flags(p)
            ps.append(vars(mod._mapper_cfg(p.parse_args(argv))))
        assert ps[0] == ps[1]
    assert ps[0]["filtering_parameter"] == 0.002
    assert vars(_cfg_of([]))["min_overlap_fraction"] == 0.8
    with pytest.raises(ValueError):
        MapperConfig(kmer_size=16, hash_representations=False)
    assert replace(MapperConfig(), kmer_size=31).kmer_size == 31
