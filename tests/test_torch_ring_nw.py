"""The port's ring wavefront over 'sp' (claragenomicsanalysis_tpu_torch/
parallel/ring_nw.py) on gloo ranks on the CPU: scores and bottom rows on
(data, sp) meshes of 2-4 ranks against the JAX ring on its fake CPU
devices, cpu/nw_oracle and the port's Myers rows, and a batch with empty
and identical pairs.  The ranks run tests/test_torch_parallel_ranks.py's
``ring`` case."""

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.parallel import make_mesh as jax_make_mesh
from claragenomicsanalysis_tpu.parallel.ring_nw import (
    ring_wavefront_nw as jax_ring, ring_wavefront_nw_rows as jax_ring_rows)
from claragenomicsanalysis_tpu_torch.ops.myers import myers_bottom_row

import test_torch_parallel_ranks as cases

MESHES = [(1, 2), (1, 3), (2, 2), (1, 4)]


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
def ranks(tmp_path_factory):
    return cases.run_cases(["ring"], tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def batch():
    return cases.ring_batch(1234)


@pytest.fixture(scope="module")
def jax_ring_out(batch):
    _, _, q, ql, t, tl = batch
    mesh = jax_make_mesh(data=2, rep=1, sp=4)
    return (np.asarray(jax_ring(q, ql, t, tl, mesh)),
            np.asarray(jax_ring_rows(q, ql, t, tl, mesh)))


def members(ranks, key):
    got = [r["ring"].get(key) for r in ranks]
    return [g for g in got if g is not None]


@pytest.mark.parametrize("data,sp", MESHES)
def test_ring_scores_match_oracle_and_jax(ranks, batch, jax_ring_out,
                                          data, sp):
    qs, ts = batch[:2]
    want = np.array([nw_oracle.nw_matrix(a, b)[len(a), len(b)]
                     for a, b in zip(qs, ts)], np.int32)
    np.testing.assert_array_equal(jax_ring_out[0], want)
    got = members(ranks, (data, sp))
    assert len(got) == data * sp
    for scores, _, _ in got:
        np.testing.assert_array_equal(scores, want)


@pytest.mark.parametrize("data,sp", MESHES)
def test_ring_rows_match_jax_and_myers(ranks, batch, jax_ring_out, data, sp):
    """Bottom rows (B, Lt + 1), column 0 = qlen: equal to the JAX ring's
    and, up to each target's length, to the oracle's and the port's Myers
    rows (columns past tlen are defined but unused, as in the JAX
    package)."""
    qs, ts, q, ql, t, tl = batch
    rows_myers = myers_bottom_row(torch.from_numpy(q.astype(np.int8)),
                                  torch.from_numpy(ql),
                                  torch.from_numpy(t.astype(np.int8)),
                                  torch.from_numpy(tl))[0].numpy()
    for _, rows, _ in members(ranks, (data, sp)):
        np.testing.assert_array_equal(rows, jax_ring_out[1])
        for b, (a, s) in enumerate(zip(qs, ts)):
            want = nw_oracle.nw_matrix(a, s)[len(a), :len(s) + 1]
            np.testing.assert_array_equal(rows[b, :len(s) + 1], want)
            np.testing.assert_array_equal(rows[b, :len(s) + 1],
                                          rows_myers[b, :len(s) + 1])


def test_ring_empty_and_identical(ranks):
    for key in MESHES:
        for _, _, edge in members(ranks, key):
            np.testing.assert_array_equal(edge, [0, 40, 40])
