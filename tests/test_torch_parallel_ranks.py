"""The port's multi-rank layer (claragenomicsanalysis_tpu_torch/parallel/)
against its own one-rank paths and the goldens: four gloo ranks on the CPU
(one rank group for the module, its cases shared by the tests), the CLI's
``-d N``, and two ranks on one card (``cuda`` marker).  This file imports
no JAX: the ranks import its case functions, and the JAX comparisons
(tests/test_torch_parallel.py, tests/test_torch_ring_nw.py) reuse them.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parallel_ranks.py
    JAX_PLATFORMS=cpu python -m pytest -m cuda tests/test_torch_parallel_ranks.py
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.align.hirschberg import (
    hirschberg_align_batch, ring_min_len)
from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                         MapperConfig,
                                                         PipelineConfig)
from claragenomicsanalysis_tpu_torch.core.status import OutputType
from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                      FastaSequence,
                                                      create_fasta_parser)
from claragenomicsanalysis_tpu_torch.models.aligner import (banded_align,
                                                            create_aligner)
from claragenomicsanalysis_tpu_torch.models.correct import correct_reads
from claragenomicsanalysis_tpu_torch.models.mapper import map_all_vs_all
from claragenomicsanalysis_tpu_torch.models.pipeline import run_pipeline
from claragenomicsanalysis_tpu_torch.models.poa import create_batch
from claragenomicsanalysis_tpu_torch.ops.myers import myers_plan, num_words
from claragenomicsanalysis_tpu_torch.parallel import (axis_meshes, make_mesh,
                                                      map_all_vs_all_sharded,
                                                      merge_sharded_rows,
                                                      multihost,
                                                      sharded_banded_nw)
from claragenomicsanalysis_tpu_torch.parallel.shard import shard_slice
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.utils.genomeutils import pack_pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
WORLD = 4                # gloo ranks of a module's rank group
RANKS_TIMEOUT = 240      # seconds a rank group may take
MAP_ARGS = ["-k", "15", "-w", "5", "--min-overlap-len", "100",
            "--min-overlap-fraction", "0.3", "--min-bases-per-residue", "500"]
MAP_CFG = MapperConfig(kmer_size=15, window_size=5, min_overlap_len=100,
                       min_overlap_fraction=0.3, min_bases_per_residue=500)
#: the JAX package's tests/test_parallel.py mapper settings
SMALL_CFG = MapperConfig(kmer_size=7, window_size=4, min_residues=3,
                         min_overlap_len=30, min_overlap_fraction=0.5,
                         min_bases_per_residue=1000)
#: (data, rep, sp) requests for make_mesh on four ranks; None = default
MESH_REQUESTS = [(None, 1, 1), (2, 2, 1), (1, 4, 1), (1, 1, 4), (2, 1, 2),
                 (None, 2, 1), (8, 1, 1), (None, 3, 1), (3, 1, 1)]


# ------------------------------------------------------------ the inputs


def random_seq(n: int, rng) -> str:
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=n)])


def mutate(seq: str, n: int, rng) -> str:
    """n random substitutions, insertions or deletions (the JAX package's
    mutate_sequence)."""
    s = list(seq)
    for _ in range(n):
        if not s:
            break
        kind = rng.integers(0, 3)
        pos = int(rng.integers(0, len(s)))
        if kind == 0:
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        elif kind == 1:
            s.insert(pos, "ACGT"[int(rng.integers(0, 4))])
        else:
            del s[pos]
    return "".join(s)


def nw_pairs(seed: int = 1234, n: int = 13) -> list[tuple[str, str]]:
    """n pairs of 10-100 bases, the second 5 edits from the first (the JAX
    test_sharded_aligner_bit_identical's shape, not a multiple of 8)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a = random_seq(int(rng.integers(10, 100)), rng)
        pairs.append((a, mutate(a, 5, rng)))
    return pairs


def nw_batch(pairs, L: int = 112):
    return pack_pairs([a for a, _ in pairs], [b for _, b in pairs], L, L)


def aligner_pairs(seed: int = 5) -> list[tuple[str, str]]:
    """Pairs of 50-400 bases with length gaps up to 70 (several adaptive
    bands), an empty and an N-rich pair."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(22):
        a = random_seq(int(rng.integers(50, 400)), rng)
        b = mutate(a, int(rng.integers(0, 20)), rng)
        pairs.append((a, b[: max(1, len(b) - (i % 5) * 17)]))
    pairs += [("", "ACGT"), ("ACGTN" * 20, "ACGT" * 24)]
    return pairs


def long_pairs(seed: int = 9) -> list[tuple[str, str]]:
    """Pairs of 150-320 bases: with sp_min_len 64, two or three
    Hirschberg levels of each go to the ring."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(5):
        a = random_seq(int(rng.integers(150, 320)), rng)
        pairs.append((a, mutate(a, int(rng.integers(5, 30)), rng)))
    pairs += [("ACGT" * 50, "ACGT" * 50), ("AC" * 90, "GT" * 70)]
    return pairs


def sim_reads(n: int, glen: int, rlen: int, seed: int = 7,
              err: float = 0.02) -> list[str]:
    genome = PoissonGenomeSimulator(seed=seed).build_reference(glen)
    sim = NoisyReadSimulator(seed=seed, error_rate=err)
    return [r.seq for r in sim.generate_reads(genome, n, rlen)]


def mem_parser(seqs) -> FastaParser:
    return FastaParser("<mem>", records=[
        FastaSequence(f"r{i}", s) for i, s in enumerate(seqs)])


def poa_windows(seed: int = 11, n: int = 9) -> list[list[str]]:
    """n windows of 3-7 noisy copies of 40-90 bases, an empty and a single
    sequence among them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = random_seq(int(rng.integers(40, 90)), rng)
        out.append([base] + [mutate(base, 4, rng)
                             for _ in range(int(rng.integers(2, 7)))])
    out[3] = []
    out[5] = out[5][:1]
    return out


def ring_batch(seed: int, B: int = 6, Lq: int = 70, Lt: int = 90):
    """The JAX tests/test_ring_nw.py batch: random or mutated pairs, and
    (q, qlen, t, tlen) int32 codes."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for b in range(B):
        a = random_seq(int(rng.integers(1, Lq)), rng)
        tb = (mutate(a, int(rng.integers(0, 8)), rng)[:Lt] if b % 2
              else random_seq(int(rng.integers(1, Lt)), rng))
        qs.append(a)
        ts.append(tb)
    return (qs, ts) + codes(qs, ts, Lq, Lt)


def codes(qs, ts, Lq: int, Lt: int):
    q, ql, t, tl = pack_pairs(qs, ts, Lq, Lt)
    return q.astype(np.int32), ql, t.astype(np.int32), tl


# ----------------------------------------------- the cases a rank runs


def _mesh_case(_):
    out = {}
    for data, rep, sp in MESH_REQUESTS:
        try:
            m = make_mesh(data=data, rep=rep, sp=sp)
            out[(data, rep, sp)] = (m.shape, m.coords)
        except ValueError as e:
            out[(data, rep, sp)] = str(e)
    mesh = make_mesh(data=2, rep=2)
    d, r = axis_meshes(mesh)
    out["views"] = (d.shape, r.shape, d.axis_ranks("data"),
                    r.axis_ranks("rep"), mesh.axis_ranks("data"),
                    mesh.axis_ranks("rep"))
    out["none"] = axis_meshes(None)
    return out


def _banded_case(_):
    q, ql, t, tl = nw_batch(nw_pairs())
    out = {}
    for n in (2, 3):
        mesh = make_mesh(data=n)
        if mesh.coords is not None:
            out[n] = sharded_banded_nw(q, ql, t, tl, 16, mesh, "cpu")
    return out


def _aligner_case(_):
    pairs = aligner_pairs()
    out = {}
    for name, n, kernel in (("diag4", 4, "diag"), ("row3", 3, "row")):
        mesh = make_mesh(data=n)
        if mesh.coords is None:
            continue
        al = create_aligner(400, 400, len(pairs), band_radius=16,
                            device="cpu", kernel=kernel, mesh=mesh)
        for a, b in pairs:
            al.add_alignment(a, b)
        out[name] = [(x.status, x.edit_distance, x.path)
                     for x in al.get_alignments()]
    return out


def _poa_case(_):
    out = {}
    for name, n, kernel in (("lockstep3", 3, "lockstep"),
                            ("window2", 2, "window"),
                            ("lockstep4", 4, "lockstep")):
        mesh = make_mesh(data=n)
        if mesh.coords is not None:
            out[name] = run_poa(poa_windows(), kernel, mesh)
    return out


def run_poa(windows, kernel: str, mesh=None, device="cpu"):
    b = create_batch(max_poas=len(windows), device=device, kernel=kernel,
                     output_mask=OutputType.CONSENSUS | OutputType.MSA,
                     mesh=mesh)
    for w in windows:
        b.add_poa_group(w)
    return b.get_consensus(), b.get_msa()


def _hirschberg_case(_):
    pairs = long_pairs()
    out = {}
    for name, sp in (("sp2", 2), ("sp3", 3)):
        mesh = make_mesh(data=1, sp=sp)
        if mesh.coords is None:
            continue
        with profiling.stage_times() as st:
            paths, dists = hirschberg_align_batch(
                [a for a, _ in pairs], [b for _, b in pairs], "cpu",
                mesh=mesh, sp_min_len=64)
        out[name] = (paths, dists.tolist(),
                     st.counters.get("hirschberg.ring_levels", 0))
    mesh = make_mesh(data=1, sp=WORLD)
    al = create_aligner(400, 400, len(pairs), algorithm="hirschberg-myers",
                        device="cpu", mesh=mesh, sp_min_len=64)
    for a, b in pairs:
        al.add_alignment(a, b)
    out["aligner"] = [(x.edit_distance, x.path) for x in al.get_alignments()]
    return out


def _compositions_case(work_dir):
    """correct_reads (plain and with a work directory) and run_pipeline on
    a mesh of two ranks (every rank aligns every overlap)."""
    parser = create_fasta_parser(os.path.join(DATA, "sample_reads.fasta"))
    mesh = make_mesh(data=2)
    if mesh.coords is None:
        return None
    corrected = correct_reads(parser, CorrectConfig(mapper=MAP_CFG,
                                                    max_support=15),
                              device="cpu", mesh=mesh)
    resumed = correct_reads(parser, CorrectConfig(mapper=MAP_CFG,
                                                  max_support=15),
                            device="cpu", mesh=mesh,
                            work_dir=os.path.join(work_dir, "correct"))
    pipe = run_pipeline(parser, PipelineConfig(mapper=MAP_CFG),
                        device="cpu", mesh=mesh)
    return {"correct": corrected.seqs, "resumed": resumed.seqs,
            "pipeline": pipe.paf_rows}


def _map_case(work_dir):
    """map_all_vs_all on rep meshes of 2 and 4 ranks, and the sharded
    output of a (data 2, rep 2) mesh, with a small index budget (several
    chunk pairs)."""
    parser = mem_parser(sim_reads(24, 3000, 300, seed=23, err=0.03))
    cfg = MapperConfig(kmer_size=7, window_size=4, min_residues=3,
                       min_overlap_len=30, min_overlap_fraction=0.5,
                       min_bases_per_residue=1000, index_size_mb=0.002)
    out = {}
    for n in (2, 4):
        _, rep = axis_meshes(make_mesh(data=n))
        if rep.coords is not None:
            out[n] = map_all_vs_all(parser, cfg, device="cpu", mesh=rep).rows
    _, rep = axis_meshes(make_mesh(data=3))
    if rep.coords is not None:
        out["query_vs_target"] = _query_vs_target(rep)
    mesh = make_mesh(data=2, rep=2)
    parts = os.path.join(work_dir, "parts")
    written, n_pairs = map_all_vs_all_sharded(parser, cfg, parts, mesh,
                                              device="cpu")
    out["parts"] = ([os.path.basename(p) for p in written], n_pairs)
    out["replicated"] = map_all_vs_all(parser, cfg, device="cpu",
                                       mesh=mesh).rows
    return out


def _matcher_case(_):
    """Matcher.create_matcher on rep meshes of 2 and 4 ranks: its anchors
    as a sorted set, its count and status, and the rows chained from them."""
    from claragenomicsanalysis_tpu_torch.models.mapper import (Index, Matcher,
                                                               Overlapper)
    seqs, cfg = match_reads("routed")
    idx = Index.create_index(mem_parser(seqs), 0, len(seqs), cfg, "cpu")
    out = {}
    for n in (1, 2, 4):
        _, rep = axis_meshes(make_mesh(data=n))
        if rep.coords is None:
            continue
        m = Matcher.create_matcher(idx, idx, cfg, device="cpu",
                                   mesh=rep if n > 1 else None)
        out[n] = (anchor_set(m.anchors()), m.n_anchors, m.status,
                  Overlapper.get_overlap_rows(m.anchors(), cfg))
    return out


def anchor_set(anchors: dict) -> np.ndarray:
    """The valid anchors as rows (q_read, t_read, q_pos, t_pos, dir) in
    lexicographic order."""
    valid = anchors["valid"].numpy()
    a = np.stack([anchors[f].numpy()[valid] for f in
                  ("q_read", "t_read", "q_pos", "t_pos", "dir")], 1)
    return a[np.lexsort(a.T[::-1])]


#: the correction manifest rank 0 reads, and what the other ranks would
#: see if they read it while rank 0 rewrites it
MANIFEST = '{"0": true, "2": true, "stale": true}'


def _manifest_case(work_dir):
    """read_done with a whole manifest on rank 0 and one cut off mid-write
    on every other rank: every rank gets rank 0's entries."""
    from claragenomicsanalysis_tpu_torch.parallel.manifest import read_done
    me = multihost.process_index()
    path = os.path.join(work_dir, f"manifest_r{me}.json")
    with open(path, "w") as f:
        f.write(MANIFEST if me == 0 else MANIFEST[:9])
    return read_done(path, ["0", "1", "2"], make_mesh())


def match_reads(which: str) -> tuple[list[str], MapperConfig]:
    """The JAX tests/test_parallel.py read sets: 24 reads of 220 bases,
    10 of 200 (the overflow case) and 3 of 70 kb (an index the JAX package
    builds unpacked)."""
    if which == "long":
        cfg = MapperConfig(kmer_size=15, window_size=10, min_residues=4,
                           min_overlap_len=500, min_overlap_fraction=0.2,
                           min_bases_per_residue=1000)
        return sim_reads(3, 100_000, 70_000, seed=31), cfg
    if which == "overflow":
        return sim_reads(10, 800, 200), SMALL_CFG
    return sim_reads(24, 1500, 220), SMALL_CFG


def _match_chain_case(_):
    """sharded_match_chain, both routes, on rep meshes of 2 and 4 ranks
    (rows merged by compact_rows), the overflow flag at cap 64, and
    map_all_vs_all on the 70 kb reads."""
    from claragenomicsanalysis_tpu_torch.models.mapper import (Index,
                                                               Overlapper)
    from claragenomicsanalysis_tpu_torch.parallel import sharded_match_chain
    out = {}
    seqs, cfg = match_reads("routed")
    idx = Index.create_index(mem_parser(seqs), 0, len(seqs), cfg, "cpu")
    for n in (2, 4):
        _, mesh = axis_meshes(make_mesh(data=n))
        if mesh.coords is None:
            continue
        for route in (True, False):
            o, flag = sharded_match_chain(idx._arrays, idx._arrays, cfg, mesh,
                                          cap=1 << 16, route=route)
            rows = (Overlapper.compact_rows(o, mesh) if route else
                    Overlapper.compact_rows({k: torch.from_numpy(v)
                                             for k, v in o.items()}))
            out[(n, route)] = (rows, flag)
    seqs, cfg = match_reads("overflow")
    idx = Index.create_index(mem_parser(seqs), 0, len(seqs), cfg, "cpu")
    _, mesh = axis_meshes(make_mesh())
    o, flag = sharded_match_chain(idx._arrays, idx._arrays, cfg, mesh,
                                  cap=64)
    out["overflow"] = (Overlapper.compact_rows(o, mesh), flag)
    seqs, cfg = match_reads("long")
    out["long"] = map_all_vs_all(mem_parser(seqs), cfg, device="cpu",
                                 mesh=mesh).rows
    return out


def _ring_case(_):
    """ring_wavefront_nw and its rows on (data, sp) meshes, and a batch
    with an empty query, an empty target and an identical pair."""
    from claragenomicsanalysis_tpu_torch.parallel.ring_nw import (
        ring_wavefront_nw, ring_wavefront_nw_rows)
    out = {}
    _, _, q, ql, t, tl = ring_batch(1234)
    a = random_seq(40, np.random.default_rng(3))
    edge = codes([a, "", a], [a, a, ""], 48, 48)
    for data, sp in ((1, 2), (1, 3), (2, 2), (1, 4)):
        mesh = make_mesh(data=data, sp=sp)
        if mesh.coords is None:
            continue
        out[(data, sp)] = (ring_wavefront_nw(q, ql, t, tl, mesh),
                           ring_wavefront_nw_rows(q, ql, t, tl, mesh),
                           ring_wavefront_nw(*edge, mesh))
    return out


def deal_settings() -> dict:
    """The benchmark's ``correct_ont`` settings (``cli correct``'s, with
    the cudamapper k 15 / w 15 defaults)."""
    with open(os.path.join(ROOT, "cga_bench", "configs",
                           "correct_ont.json")) as f:
        return json.load(f)["settings"]


def deal_config() -> CorrectConfig:
    s = deal_settings()
    return CorrectConfig(mapper=MapperConfig(**s["mapper"]),
                         **{k: v for k, v in s.items() if k != "mapper"})


def deal_inputs() -> dict[str, list[str]]:
    """``reads``: 8 noisy reads of 400 bases at about 3x, a random read
    with no overlaps among them (read 3); ``few``: two overlapping reads,
    fewer than three or four ranks."""
    rng = np.random.default_rng(43)
    seqs = sim_reads(8, 1200, 400, seed=41, err=0.05)
    genome = random_seq(1100, rng)
    return {"reads": seqs[:3] + [random_seq(400, rng)] + seqs[3:],
            "few": [mutate(genome[:1000], 20, rng),
                    mutate(genome[100:], 20, rng)]}


def _deal_case(work_dir):
    """correct_reads with the reads dealt over 'data' on meshes of 2, 3 and
    4 ranks, each inside a stage_times() block, and a run of the two reads
    on three ranks stopped after its first part of one read, then
    resumed."""
    cfg = deal_config()
    out = {}
    for name, seqs in deal_inputs().items():
        for n in (2, 3, 4):
            mesh = make_mesh(data=n)
            if mesh.coords is None:
                continue
            with profiling.stage_times() as st:
                res = correct_reads(mem_parser(seqs), cfg, device="cpu",
                                    mesh=mesh)
            out[(name, n)] = (res.seqs, res.rows)
            out[("traced", name, n)] = (dict(st.counters), st.host_ms())
    mesh = make_mesh(data=3)
    if mesh.coords is not None:
        parser = mem_parser(deal_inputs()["few"])
        work = os.path.join(work_dir, "deal")
        try:
            correct_reads(parser, cfg, work_dir=work, part_size=1,
                          fail_after_parts=1, device="cpu", mesh=mesh)
            stopped = None
        except RuntimeError as e:
            stopped = str(e)
        res = correct_reads(parser, cfg, work_dir=work, part_size=1,
                            device="cpu", mesh=mesh)
        out["resumed"] = (stopped, res.seqs, sorted(os.listdir(work)))
    return out


CASES = {"mesh": _mesh_case, "banded": _banded_case,
         "aligner": _aligner_case, "poa": _poa_case,
         "hirschberg": _hirschberg_case, "compositions": _compositions_case,
         "map": _map_case, "match_chain": _match_chain_case,
         "ring": _ring_case, "matcher": _matcher_case,
         "manifest": _manifest_case, "deal": _deal_case}
#: the cases this module's tests read
OWN_CASES = ("mesh", "banded", "aligner", "poa", "hirschberg",
             "compositions", "map", "matcher", "manifest")


def rank_cases(names, work_dir):
    """A rank's results of the named cases, {name: result}.  The JAX
    comparison modules run their cases from here too: the ranks import
    this file, which imports no JAX."""
    torch.set_num_threads(1)
    cases = CASES | CARD_CASES
    return {name: cases[name](work_dir) for name in names}


def run_cases(names, work_dir, world: int = WORLD, devices=None) -> list:
    """Every rank's rank_cases(names) from one group of ``world`` ranks
    (``devices``: one a rank, default the CPU for every rank)."""
    return multihost.run_ranks(rank_cases, world,
                               devices or ["cpu"] * world,
                               args=(list(names), str(work_dir)),
                               timeout=RANKS_TIMEOUT, log_level="WARNING")


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
def work_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def ranks(work_dir):
    return run_cases(OWN_CASES, work_dir)


@pytest.fixture(scope="module")
def deal_ranks(work_dir):
    """The deal's cases, in a rank group of their own."""
    return run_cases(("deal",), work_dir)


def every_rank(ranks, case, key=None):
    """The members' results of a case (non-members return nothing)."""
    vals = [r[case] if key is None else r[case].get(key) for r in ranks]
    return [v for v in vals if v is not None]


# ------------------------------------------------------------ CPU tests


def test_mesh_shapes_and_errors(ranks):
    got = ranks[0]["mesh"]
    assert got[(None, 1, 1)][0] == {"data": 4, "rep": 1, "sp": 1}
    assert got[(2, 2, 1)][0] == {"data": 2, "rep": 2, "sp": 1}
    assert got[(1, 1, 4)][0] == {"data": 1, "rep": 1, "sp": 4}
    assert got[(None, 2, 1)][0]["data"] == 2
    assert got[(8, 1, 1)] == "need 8 devices, have 4"
    assert got[(None, 3, 1)] == "4 devices not divisible by rep*sp=3"
    # the mesh of three ranks leaves rank 3 out
    assert got[(3, 1, 1)][1] == {"data": 0, "rep": 0, "sp": 0}
    assert ranks[3]["mesh"][(3, 1, 1)] == ({"data": 3, "rep": 1, "sp": 1},
                                           None)
    assert [r["mesh"][(2, 1, 2)][1] for r in ranks] == [
        {"data": d, "rep": 0, "sp": s} for d in (0, 1) for s in (0, 1)]
    # (data 2, rep 2): the data lines are {0, 2} / {1, 3}, the rep lines
    # {0, 1} / {2, 3}; both views of it put all four on one axis
    views = [r["mesh"]["views"] for r in ranks]
    assert views[0][:2] == ({"data": 4, "rep": 1, "sp": 1},
                            {"data": 1, "rep": 4, "sp": 1})
    assert [v[2] for v in views] == [[0, 1, 2, 3]] * 4
    assert [v[4] for v in views] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [v[5] for v in views] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert ranks[0]["mesh"]["none"] == (None, None)


def test_backend_rule():
    rule = multihost.choose_backend
    assert rule(["cpu", "cpu"]) == "gloo"
    assert rule(["cuda:0", "cuda:0"]) == "gloo"      # ranks share a card
    assert rule(["cuda:0", "cuda:1"]) == "nccl"
    assert rule(["cuda:0", "cpu"]) == "gloo"
    assert rule(["cuda:1"]) == "nccl"


@pytest.mark.parametrize("cards,world,want", [
    (2, 2, ["cuda:0", "cuda:1"]), (4, 3, ["cuda:0", "cuda:1", "cuda:2"]),
    (1, 2, None), (0, 1, None)])
def test_default_devices_are_cards(monkeypatch, cards, world, want):
    """Ranks not given devices get a card each, and raise where there are
    too few: the default never lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is None:
        with pytest.raises(RuntimeError, match=f"{world} ranks but only "
                                               f"{cards} CUDA devices"):
            multihost.default_devices(world)
    else:
        assert multihost.default_devices(world) == want


def test_ranks_without_devices_never_run_on_the_cpu(tmp_path):
    """Without devices, forming a group, starting ranks and a mesh outside
    a group all ask for a card: here, with none, the first two raise before
    any group or process exists and the mesh lies on ``cuda``."""
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")
    init = f"file://{tmp_path / 'rendezvous'}"
    with pytest.raises(RuntimeError, match="2 ranks but only 0 CUDA"):
        multihost.initialize_distributed(init, 2, 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="2 ranks but only 0 CUDA"):
        multihost.run_ranks(_fail_on_rank_1, 2, timeout=60)
    assert multihost.world_devices() == ["cuda"]
    assert make_mesh().device.type == "cuda"


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_banded_nw_equals_one_rank(ranks, n):
    pairs = nw_pairs()
    q, ql, t, tl = nw_batch(pairs)
    scores, paths = banded_align(q, ql, t, tl, np.full(len(pairs), 16),
                                 "cpu")
    got = every_rank(ranks, "banded", n)
    assert len(got) == n
    for s, p in got:
        np.testing.assert_array_equal(s, scores)
        assert p == paths


@pytest.mark.parametrize("name,kernel", [("diag4", "diag"), ("row3", "row")])
def test_ukkonen_on_data_equals_one_rank(ranks, name, kernel):
    pairs = aligner_pairs()
    al = create_aligner(400, 400, len(pairs), band_radius=16, device="cpu",
                        kernel=kernel)
    for a, b in pairs:
        al.add_alignment(a, b)
    want = [(x.status, x.edit_distance, x.path) for x in al.get_alignments()]
    assert len({x[1] for x in want}) > 5       # the bands differ
    for got in every_rank(ranks, "aligner", name):
        assert got == want


@pytest.mark.parametrize("name,kernel", [("lockstep3", "lockstep"),
                                         ("window2", "window"),
                                         ("lockstep4", "lockstep")])
def test_sharded_poa_equals_one_rank(ranks, name, kernel):
    want = run_poa(poa_windows(), kernel)
    for got in every_rank(ranks, "poa", name):
        assert got == want


def test_ring_threshold_rule():
    """The automatic sp threshold: the shortest padded query for which B4
    needs a second pass."""
    L = ring_min_len()
    assert myers_plan(num_words(L))[2] == 2
    assert myers_plan(num_words(L - 1))[2] == 1
    assert L == 16_385


@pytest.mark.parametrize("name", ["sp2", "sp3"])
def test_hirschberg_on_ring_equals_one_rank(ranks, name):
    pairs = long_pairs()
    paths, dists = hirschberg_align_batch([a for a, _ in pairs],
                                          [b for _, b in pairs], "cpu")
    got = every_rank(ranks, "hirschberg", name)
    assert len(got) == int(name[2:])
    for p, d, ring_levels in got:
        assert ring_levels >= 2          # levels really took the ring
        assert p == paths and d == dists.tolist()


def test_hirschberg_aligner_on_sp_mesh(ranks):
    pairs = long_pairs()
    al = create_aligner(400, 400, len(pairs), algorithm="hirschberg-myers",
                        device="cpu")
    for a, b in pairs:
        al.add_alignment(a, b)
    want = [(x.edit_distance, x.path) for x in al.get_alignments()]
    for got in every_rank(ranks, "hirschberg", "aligner"):
        assert got == want


@pytest.mark.parametrize("what,golden", [
    ("correct", "sample_corrected.fasta"),
    ("resumed", "sample_corrected.fasta"),
    ("pipeline", "sample_pipeline.paf")])
def test_compositions_on_mesh_equal_goldens(ranks, what, golden):
    with open(os.path.join(DATA, "golden", golden)) as f:
        want = f.read()
    parser = create_fasta_parser(os.path.join(DATA, "sample_reads.fasta"))
    members = every_rank(ranks, "compositions")
    assert len(members) == 2
    for r in members:
        got = r[what]
        if what == "pipeline":
            text = "".join(row + "\n" for row in got)
        else:
            text = "".join(f">{parser.get_sequence_by_id(i).name}\n{s}\n"
                           for i, s in enumerate(got))
        assert text == want


@pytest.mark.parametrize("n", [2, 4])
def test_map_on_rep_equals_one_rank(ranks, n):
    rows = _map_one_rank()
    assert rows.shape[1] > 50
    got = every_rank(ranks, "map", n)
    assert len(got) == n
    for r in got:
        np.testing.assert_array_equal(r, rows)


def _query_vs_target(mesh=None):
    """The sample reads against the sample targets, two index chunks a
    side."""
    from claragenomicsanalysis_tpu_torch.models.mapper import \
        map_query_vs_target
    cfg = MapperConfig(kmer_size=15, window_size=5, min_overlap_len=100,
                       min_overlap_fraction=0.3, min_bases_per_residue=500,
                       index_size_mb=0.006)
    return map_query_vs_target(
        create_fasta_parser(os.path.join(DATA, "sample_reads.fasta")),
        create_fasta_parser(os.path.join(DATA, "sample_targets.fasta")), cfg,
        device="cpu", mesh=mesh).rows


def test_query_vs_target_on_rep_equals_one_rank(ranks):
    rows = _query_vs_target()
    assert rows.shape[1] > 0
    got = every_rank(ranks, "map", "query_vs_target")
    assert len(got) == 3
    for r in got:
        np.testing.assert_array_equal(r, rows)


def _map_one_rank():
    parser = mem_parser(sim_reads(24, 3000, 300, seed=23, err=0.03))
    cfg = MapperConfig(kmer_size=7, window_size=4, min_residues=3,
                       min_overlap_len=30, min_overlap_fraction=0.5,
                       min_bases_per_residue=1000, index_size_mb=0.002)
    return map_all_vs_all(parser, cfg, device="cpu").rows


def test_sharded_output_parts_merge_to_the_rows(ranks, work_dir):
    rows = _map_one_rank()
    written = [r["map"]["parts"] for r in ranks]
    n_pairs = written[0][1]
    assert n_pairs >= 4
    # ranks 0 and 1 own rep shards 0 and 1; ranks 2 and 3 (data 1) write
    # nothing
    assert [len(w) for w, _ in written] == [n_pairs, n_pairs, 0, 0]
    assert written[1][0][0] == "part_p00000_r001.npy"
    for r in ranks:
        np.testing.assert_array_equal(r["map"]["replicated"], rows)
    np.testing.assert_array_equal(
        merge_sharded_rows(str(work_dir / "parts")), rows)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_matcher_equals_one_rank(ranks, n):
    """Matcher.create_matcher(mesh=) on a rep line of n ranks: every rank
    holds the one-rank anchor set, count and status, and chains it into
    the one-rank rows."""
    want = ranks[0]["matcher"][1]
    got = every_rank(ranks, "matcher", n)
    assert len(got) == n
    for anchors, total, status, rows in got:
        np.testing.assert_array_equal(anchors, want[0])
        assert (total, status) == (want[1], want[2])
        np.testing.assert_array_equal(rows, want[3])
    assert want[0].shape[0] > 0 and want[3].shape[1] > 0


def test_manifest_read_on_rank_0_only(ranks):
    """Only rank 0 reads a checkpoint manifest (it rewrites the file after
    every part): ranks that find it half written get rank 0's entries."""
    assert ranks[0]["manifest"] == json.loads(MANIFEST)
    for r in ranks[1:]:
        assert r["manifest"] == {"0": True, "2": True}


@pytest.fixture(scope="module")
def one_rank_deal():
    """Each deal input corrected on one rank, and the benchmark's plain
    reference's numbers for it (every read compared)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from cga_bench.reference.judge import judge_correct
    out = {}
    for name, seqs in deal_inputs().items():
        res = correct_reads(mem_parser(seqs), deal_config(), device="cpu")
        job = [(f"r{i}", s) for i, s in enumerate(seqs)]
        numbers = judge_correct([job], [{"seqs": res.seqs,
                                         "rows": res.rows.T}],
                                deal_settings(), {"windows": 10**6}, 1,
                                "cpu")
        out[name] = (res, numbers)
    return out


@pytest.mark.parametrize("name", ["reads", "few"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_dealt_reads_equal_one_rank_and_the_reference(deal_ranks,
                                                      one_rank_deal, name, n):
    """correct_reads on a mesh of n ranks deals the reads over 'data': every
    rank returns the one-rank reads byte for byte, which the reference
    holds exactly (every number 0, every read compared)."""
    from claragenomicsanalysis_tpu_torch.models.correct import (deal_reads,
                                                                read_areas)
    res, numbers = one_rank_deal[name]
    seqs = deal_inputs()[name]
    assert numbers["reads_compared"][0] == len(seqs)
    assert all(v == 0 for v, lim in numbers.values() if lim is not None)
    rows = res.rows.T
    if name == "reads":
        assert rows.shape[0] > 10 and not (rows[:, :2] == 3).any()
    else:
        assert len(seqs) < 3 and rows.shape[0] == 2
    got = ([(res.seqs, res.rows)] if n == 1
           else every_rank(deal_ranks, "deal", (name, n)))
    assert len(got) == n
    for g_seqs, g_rows in got:
        assert g_seqs == res.seqs
        np.testing.assert_array_equal(g_rows, res.rows)
    by_query = {}
    for o in res_overlaps(res):
        by_query.setdefault(o.query_read_id, []).append(o)
    deal = deal_reads(read_areas(list(range(len(seqs))), by_query), n)
    assert sorted(i for share in deal for i in share) == list(range(len(seqs)))
    if len(seqs) < n:
        assert [] in deal


def res_overlaps(res):
    from claragenomicsanalysis_tpu_torch.models.mapper import Overlapper
    return Overlapper.rows_to_overlaps(res.rows)


def test_dealt_run_resumes_to_one_rank(deal_ranks, one_rank_deal):
    """With a work directory each part of reads is dealt and gathered in
    turn and rank 0 writes its file: a run stopped after its first part
    resumes to the one-rank reads."""
    res, _ = one_rank_deal["few"]
    got = every_rank(deal_ranks, "deal", "resumed")
    assert len(got) == 3
    for stopped, seqs, _ in got:
        assert stopped == "injected failure for resume test"
        assert seqs == res.seqs
    # as rank 0, the writer, saw them when it returned
    assert got[0][2] == ["correct_manifest.json", "corrected_part_0.json",
                         "corrected_part_1.json", "map"]


def test_deal_balances_the_area():
    from claragenomicsanalysis_tpu_torch.models.correct import deal_reads
    assert deal_reads([5, 1, 4, 0, 0, 3], 2) == [[0, 1, 3, 4], [2, 5]]
    assert deal_reads([0, 0, 0], 4) == [[0], [1], [2], []]
    assert deal_reads([], 3) == [[], [], []]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_shard_counters_add_up_and_comm_is_traced(deal_ranks, n):
    """Inside a stage_times() block every rank of the deal counts its own
    share of the DP area, and the shares add up to the total each rank
    counts; the exchanges, the deal, the wait and the gather are ranges,
    and the exchanges are counted."""
    traced = every_rank(deal_ranks, "deal", ("traced", "reads", n))
    assert len(traced) == n
    areas = [c["shard.area"] for c, _ in traced]
    for counters, host_ms in traced:
        assert counters["shard.area_total"] == sum(areas) > 0
        assert counters["shard.area_max"] == max(areas)
        assert (counters["shard.ranks"], counters["shard.deals"]) == (n, 1)
        assert counters["comm.calls"] > 0 and counters["comm.bytes"] > 0
        assert {"comm.all_gather", "comm.all_to_all", "comm.all_reduce",
                "comm.gather_reads", "ranks.deal", "ranks.wait"} <= set(
                    host_ms)


def test_shard_slice():
    assert [shard_slice(13, 3, i) for i in range(3)] == [
        slice(0, 5), slice(5, 10), slice(10, 13)]
    assert shard_slice(2, 4, 3) == slice(2, 2)


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(multihost.RanksFailed) as e:
        multihost.run_ranks(_fail_on_rank_1, 2, ["cpu"] * 2, timeout=60,
                            log_level="WARNING")
    assert e.value.exitcodes[1] == 1
    assert e.value.first_error == 1


def _fail_on_rank_1():
    if multihost.process_index() == 1:
        raise RuntimeError("rank 1 fails")
    return 0


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("sub,golden", [
    ("align", "sample_align.txt"), ("map_store", "sample_overlaps.paf")])
def test_cli_two_ranks_equal_golden(sub, golden, tmp_path, capfd):
    """``cli <sub> -d 2 --device cpu`` (two gloo ranks; rank 0 writes
    stdout through the file descriptor it inherits) equals the golden; with
    an index store rank 0 alone writes it, each index once and whole."""
    store = tmp_path / "store"
    argv = {"align": ["align", f"{DATA}/sample_queries.fasta",
                      f"{DATA}/sample_targets.fasta", "--band-radius", "64"],
            "map_store": ["map", f"{DATA}/sample_reads.fasta", "-c",
                          str(store)] + MAP_ARGS}[sub]
    capfd.readouterr()
    assert cli.main(["--log-level", "WARNING"] + argv
                    + ["--device", "cpu", "-d", "2"]) == 0
    with open(os.path.join(DATA, "golden", golden)) as f:
        assert capfd.readouterr().out == f.read()
    if sub == "map_store":
        assert [p.name.count(".") for p in store.iterdir()] == [1]


def test_cli_one_device_is_no_flag():
    argv = ["align", f"{DATA}/sample_queries.fasta",
            f"{DATA}/sample_targets.fasta", "--device", "cpu"]
    assert _cli(argv + ["-d", "1"]) == _cli(argv)


def test_cli_refuses_more_devices_than_cards():
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(2, k + 1)
    with pytest.raises(SystemExit, match=f"--devices {n} but only {k} "
                                         "available"):
        cli.main(["align", f"{DATA}/sample_queries.fasta",
                  f"{DATA}/sample_targets.fasta", "-d", str(n)])


# ------------------------------------------------------------ card tests


def _card_cases(_):
    """Two ranks on one card: ukkonen on 'data', POA on 'data' (both
    routes), the map on 'rep', Hirschberg on the 'sp' ring."""
    pairs = aligner_pairs()
    mesh = make_mesh()
    al = create_aligner(400, 400, len(pairs), band_radius=16,
                        device="cuda", mesh=mesh)
    for a, b in pairs:
        al.add_alignment(a, b)
    lp = long_pairs()
    _, rep = axis_meshes(mesh)
    parser = mem_parser(sim_reads(24, 3000, 300, seed=23, err=0.03))
    return {"ukkonen": [(x.edit_distance, x.path)
                        for x in al.get_alignments()],
            "poa": [run_poa(poa_windows(), k, mesh, "cuda")
                    for k in ("lockstep", "window")],
            "map": map_all_vs_all(parser, SMALL_CFG, device="cuda",
                                  mesh=rep).rows,
            "ring": hirschberg_align_batch(
                [a for a, _ in lp], [b for _, b in lp], "cuda",
                mesh=make_mesh(data=1, sp=2), sp_min_len=64)[0]}


CARD_CASES = {"card": _card_cases}


@pytest.mark.cuda
def test_two_ranks_on_one_card_equal_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: two ranks on cuda:0")
    from claragenomicsanalysis_tpu_torch.ops import _build
    _build.build()
    got = run_cases(["card"], tmp_path, world=2,
                    devices=["cuda:0", "cuda:0"])
    pairs = aligner_pairs()
    al = create_aligner(400, 400, len(pairs), band_radius=16, device="cpu")
    for a, b in pairs:
        al.add_alignment(a, b)
    lp = long_pairs()
    parser = mem_parser(sim_reads(24, 3000, 300, seed=23, err=0.03))
    want = {"ukkonen": [(x.edit_distance, x.path)
                        for x in al.get_alignments()],
            "poa": [run_poa(poa_windows(), k) for k in ("lockstep", "window")],
            "map": map_all_vs_all(parser, SMALL_CFG, device="cpu").rows,
            "ring": hirschberg_align_batch([a for a, _ in lp],
                                           [b for _, b in lp], "cpu")[0]}
    for r in got:
        card = r["card"]
        assert card["ukkonen"] == want["ukkonen"]
        assert card["poa"] == want["poa"]
        np.testing.assert_array_equal(card["map"], want["map"])
        assert card["ring"] == want["ring"]
