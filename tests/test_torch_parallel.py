"""The port's data- and rep-sharded paths (claragenomicsanalysis_tpu_torch/
parallel/) on four gloo ranks against the JAX package's mesh functions on
its fake CPU devices (tests/conftest.py): the mesh's shapes and errors,
sharded_banded_nw, sharded_match_chain on both routes (the overflow case
and an index the JAX package builds unpacked included) and the sharded
output's part files, read by both packages' merges.  The ranks run the
case functions of tests/test_torch_parallel_ranks.py, which imports no
JAX."""

import numpy as np
import pytest
import torch

import jax

from claragenomicsanalysis_tpu.io.fasta import FastaParser as JaxParser
from claragenomicsanalysis_tpu.io.fasta import FastaSequence as JaxSeq
from claragenomicsanalysis_tpu.core.config import MapperConfig as JaxCfg
from claragenomicsanalysis_tpu.models.mapper import Index as JaxIndex
from claragenomicsanalysis_tpu.models.mapper import (
    map_all_vs_all as jax_map_all_vs_all)
from claragenomicsanalysis_tpu.ops import nw_band
from claragenomicsanalysis_tpu.parallel import make_mesh as jax_make_mesh
from claragenomicsanalysis_tpu.parallel import merge_sharded_rows as jax_merge
from claragenomicsanalysis_tpu.parallel import sharded_banded_nw as jax_nw
from claragenomicsanalysis_tpu.parallel import (
    sharded_match_chain as jax_match_chain)
from claragenomicsanalysis_tpu_torch.parallel import merge_sharded_rows

import test_torch_parallel_ranks as cases

FIELDS = ("q_read", "t_read", "q_start", "q_end", "t_start", "t_end",
          "n_res", "dir")


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
    return cases.run_cases(("mesh", "banded", "match_chain", "map"),
                           work_dir)


def jax_cfg(cfg) -> JaxCfg:
    return JaxCfg(**{f: getattr(cfg, f) for f in (
        "kmer_size", "window_size", "min_residues", "min_overlap_len",
        "min_overlap_fraction", "min_bases_per_residue", "index_size_mb")})


def jax_parser(seqs) -> JaxParser:
    return JaxParser("<mem>", records=[JaxSeq(f"r{i}", s)
                                       for i, s in enumerate(seqs)])


def keyset_rows(rows) -> list:
    return sorted(map(tuple, np.asarray(rows).T.tolist()))


def keyset_masked(out) -> list:
    sel = np.nonzero(np.asarray(out["valid"]))[0]
    return sorted(tuple(int(np.asarray(out[f])[i]) for f in FIELDS)
                  for i in sel)


def test_mesh_shapes_and_errors_match_jax(ranks):
    """make_mesh's shapes and errors on four ranks equal the JAX
    make_mesh's on four devices."""
    devs = jax.devices()[:4]
    got = ranks[0]["mesh"]
    for req in cases.MESH_REQUESTS:
        data, rep, sp = req
        try:
            m = jax_make_mesh(data=data, rep=rep, sp=sp, devices=devs)
            assert got[req][0] == dict(m.shape), req
        except ValueError as e:
            assert got[req] == str(e), req


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_banded_nw_matches_jax(ranks, n):
    """13 pairs at r = 16 on n ranks: the JAX sharded_banded_nw's scores
    and paths on its eight-device mesh."""
    q, ql, t, tl = cases.nw_batch(cases.nw_pairs())
    s8, tb8 = jax_nw(q, ql, t, tl, 16, jax_make_mesh(data=8))
    paths8 = nw_band.traceback_paths(np.asarray(tb8), ql, tl, 16)
    got = cases.every_rank(ranks, "banded", n)
    assert len(got) == n
    for scores, paths in got:
        np.testing.assert_array_equal(scores, np.asarray(s8))
        assert paths == paths8


@pytest.fixture(scope="module")
def routed_jax():
    """The JAX routed and all-gathered match + chain on rep = 8, and its
    one-device map, on the 24 reads."""
    seqs, cfg = cases.match_reads("routed")
    cfg = jax_cfg(cfg)
    p = jax_parser(seqs)
    idx = JaxIndex.create_index(p, 0, len(seqs), cfg)
    mesh = jax_make_mesh(data=1, rep=8)
    routed, ov = jax_match_chain(idx._arrays, idx._arrays, cfg, mesh,
                                 cap=1 << 16, route=True)
    assert not ov
    return keyset_masked(routed), jax_map_all_vs_all(p, cfg).rows


@pytest.mark.parametrize("n,route", [(2, True), (2, False), (4, True),
                                     (4, False)])
def test_sharded_match_chain_matches_jax(ranks, routed_jax, n, route):
    want_keys, want_rows = routed_jax
    got = cases.every_rank(ranks, "match_chain", (n, route))
    assert len(got) == n
    for rows, overflow in got:
        assert not overflow
        assert keyset_rows(rows) == want_keys
        np.testing.assert_array_equal(rows, want_rows)


def test_sharded_match_chain_overflow_matches_jax(ranks):
    """Anchors past the cap (64) raise the overflow flag, as in the JAX
    routed path, with the same rows."""
    seqs, cfg = cases.match_reads("overflow")
    cfg = jax_cfg(cfg)
    idx = JaxIndex.create_index(jax_parser(seqs), 0, len(seqs), cfg)
    out, overflow = jax_match_chain(idx._arrays, idx._arrays, cfg,
                                    jax_make_mesh(data=1, rep=8), cap=64)
    assert overflow
    for rows, flag in (r["match_chain"]["overflow"] for r in ranks):
        assert flag
        assert keyset_rows(rows) == keyset_masked(out)


def test_map_long_reads_matches_jax(ranks):
    """70 kb reads (an unpacked index in the JAX package): map_all_vs_all
    on four rep ranks equals the JAX package's one-device rows."""
    seqs, cfg = cases.match_reads("long")
    assert max(map(len, seqs)) > (1 << 16)
    want = jax_map_all_vs_all(jax_parser(seqs), jax_cfg(cfg)).rows
    assert want.shape[1] > 0
    for r in ranks:
        np.testing.assert_array_equal(r["match_chain"]["long"], want)


def test_sharded_parts_read_by_both_merges(ranks, work_dir):
    """The port's part files (JAX names and layout) merged by the JAX
    merge_sharded_rows and by the port's equal the JAX package's rows."""
    seqs = cases.sim_reads(24, 3000, 300, seed=23, err=0.03)
    cfg = JaxCfg(kmer_size=7, window_size=4, min_residues=3,
                 min_overlap_len=30, min_overlap_fraction=0.5,
                 min_bases_per_residue=1000, index_size_mb=0.002)
    want = jax_map_all_vs_all(jax_parser(seqs), cfg).rows
    parts = str(work_dir / "parts")
    np.testing.assert_array_equal(jax_merge(parts), want)
    np.testing.assert_array_equal(merge_sharded_rows(parts), want)
    np.testing.assert_array_equal(ranks[0]["map"]["replicated"], want)
