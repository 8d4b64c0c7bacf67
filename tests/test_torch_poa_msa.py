"""The port's MSA, graph export and one-kernel-per-window route
(claragenomicsanalysis_tpu_torch) against the JAX package's
``create_batch(..., backend="xla")``, its one-kernel POA in interpret mode and
``cpu.poa_oracle``, on the windows of tests/test_torch_poa.py.  Integer
outputs and strings, compared exactly (tolerance 0)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core.config import BatchSize as JaxBatchSize
from claragenomicsanalysis_tpu.core.config import PoaScores as JaxPoaScores
from claragenomicsanalysis_tpu.core.status import OutputType as JaxOutputType
from claragenomicsanalysis_tpu.cpu.poa_oracle import PoaGraph
from claragenomicsanalysis_tpu.models.poa import create_batch as jax_batch
from claragenomicsanalysis_tpu.ops.poa_pallas import poa_batch_pallas
from claragenomicsanalysis_tpu.utils.genomeutils import encode
from claragenomicsanalysis_tpu_torch.core.config import BatchSize, PoaScores
from claragenomicsanalysis_tpu_torch.core.status import StatusType
from claragenomicsanalysis_tpu_torch.models import poa
from claragenomicsanalysis_tpu_torch.ops import _build, poa_window
from test_torch_poa import (MSA, SHAPES, jax_ref_batch, port_batch,
                            windows_for)


@functools.lru_cache(maxsize=None)
def port_msa(name: str, kernel: str = "lockstep"):
    """(add statuses, get_consensus(), get_msa()) of the port's batch with
    the MSA on the CPU."""
    b, stats = port_batch(name, windows_for(name), output_mask=MSA,
                          kernel=kernel)
    return stats, b.get_consensus(), b.get_msa()


@pytest.mark.parametrize("name", list(SHAPES))
def test_batch_msa_matches_jax_batch(name):
    """get_msa's strings and statuses equal the JAX batch's on every edge
    window, and asking for the MSA leaves get_consensus as it was."""
    windows = windows_for(name)
    stats, cons, (msas, mstat) = port_msa(name)
    jb, jstats = jax_ref_batch(name, windows,
                               output_mask=JaxOutputType.CONSENSUS
                               | JaxOutputType.MSA)
    jmsas, jmstat = jb.get_msa()
    assert [int(x) for x in stats] == [int(x) for x in jstats]
    assert msas == jmsas
    assert [int(x) for x in mstat] == [int(x) for x in jmstat]
    assert cons == port_batch(name, windows)[0].get_consensus()
    n_ok = 0
    for w, rows, st in zip(windows, msas, mstat):
        if st == StatusType.SUCCESS:
            n_ok += 1
            assert len(rows) == len(w) and len({len(r) for r in rows}) <= 1
        else:
            assert rows == []
    assert 0 < n_ok < len(windows)


def test_get_msa_needs_the_msa_bit():
    b, _ = port_batch("small", windows_for("small")[:2])
    assert b.get_msa() == ([[], []],
                           [StatusType.OUTPUT_TYPE_UNAVAILABLE] * 2)


@pytest.mark.parametrize("name", list(SHAPES))
def test_get_graphs_matches_jax_batch(name):
    """The DOT text of every window's graph equals the JAX export's; a
    window that failed exports None in both."""
    windows = windows_for(name)
    got = port_batch(name, windows)[0].get_graphs()
    want = jax_ref_batch(name, windows)[0].get_graphs()
    assert [g is None for g in got] == [g is None for g in want]
    assert 0 < sum(g is None for g in got) < len(got)
    for g, w in zip(got, want):
        if g is not None:
            assert g.serialize_to_dot() == w.serialize_to_dot()
    assert port_batch(name, [])[0].get_graphs() == []


def test_get_graphs_matches_oracle():
    """The exported graphs equal cpu.poa_oracle's, built sequence by
    sequence, on windows that succeed."""
    kw = SHAPES["small"][0]
    windows = windows_for("small")[:4]
    b, _ = port_batch("small", windows, kernel="window")
    for w, g in zip(windows, b.get_graphs()):
        og = PoaGraph(batch_size=JaxBatchSize(**kw), scores=JaxPoaScores())
        for i, s in enumerate(w):
            codes = list(encode(s))
            if i == 0:
                og.add_first_sequence(codes, [1] * len(s))
            else:
                og.add_alignment(og.align_sequence(codes), codes,
                                 [1] * len(s))
        assert g.serialize_to_dot() == \
            og.to_directed_graph().serialize_to_dot()


def test_msa_with_weights_and_n_bases_matches_jax_batch():
    """Given weights and N bases: an N base shows as a gap, as in the JAX
    package, and the weights move the consensus the same way."""
    windows = [["ACTTAGGA", "AGTTANGA", "AGTTAGGA"], ["ACGTN", "ACGT"]]
    weights = [[[5] * 8, [1] * 8, [1] * 8], None]
    kw = SHAPES["small"][0]
    outs = []
    for b in (poa.create_batch(BatchSize(**kw), output_mask=MSA,
                               device="cpu"),
              jax_batch(JaxBatchSize(**kw), backend="xla",
                        output_mask=JaxOutputType.CONSENSUS
                        | JaxOutputType.MSA)):
        for w, wt in zip(windows, weights):
            b.add_poa_group(w, wt)
        cons, covs, st = b.get_consensus()
        msas, mst = b.get_msa()
        outs.append((cons, covs, [int(x) for x in st], msas,
                     [int(x) for x in mst]))
    assert outs[0] == outs[1]
    assert outs[0][0][0] == "ACTTAGGA" and outs[0][3][0][1] == "AGTTA-GA"


def test_msa_launch_chunks_never_change_a_result(monkeypatch):
    """With the MSA the windows are cut by the larger window_bytes, and a
    batch cut into launches of five windows gives the one launch's rows."""
    bs = BatchSize(**SHAPES["overflow"][0])
    monkeypatch.setattr(poa, "POA_MEM_BUDGET",
                        5 * poa.window_bytes(bs, msa=True))
    assert [len(c) for c in poa.launch_chunks(12, bs, msa=True)] == [5, 5, 2]
    assert [len(c) for c in poa.launch_chunks(12, bs)] == [6, 6]
    b, stats = port_batch("overflow", windows_for("overflow"),
                          output_mask=MSA)
    assert (stats, b.get_consensus(), b.get_msa()) == port_msa("overflow")


def pack_windows(name: str, windows):
    """The batch's own packing of these windows, as int32 tensors."""
    b, _ = port_batch(name, windows)
    return [torch.from_numpy(a) for a in b._pack_arrays()]


@pytest.mark.parametrize("name", list(SHAPES))
def test_window_kernel_route_equals_lockstep_on_cpu(name):
    """kernel="window" gives kernel="lockstep"'s consensus, MSA and
    statuses (on the CPU both run the plain versions)."""
    assert port_msa(name, "window") == port_msa(name, "lockstep")


def test_poa_window_equals_run_windows_on_cpu():
    """poa_window's six outputs equal run_windows' first six, with and
    without the MSA; without it rows and n_cols are zeros and the state
    carries no paths."""
    kw, banded, _ = SHAPES["overflow"]
    bs = BatchSize(**kw)
    arrays = pack_windows("overflow", windows_for("overflow")[:6])
    for msa in (False, True):
        got = poa_window.poa_window(*arrays, bs, PoaScores(), banded, msa)
        want = poa_window.run_windows(bs, PoaScores(), banded, *arrays, msa)
        assert len(got) == 6 and len(want) == 7
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)
        assert (want[6].paths is not None) == msa
        if not msa:
            assert got[3].shape == (6, bs.max_sequences_per_poa, 1)
            assert not got[3].any() and not got[4].any()


def test_window_route_matches_the_pallas_kernel_interpreted():
    """poa_window against the function of the TPU kernel it replaces,
    ``poa_batch_pallas(interpret=True, msa=True)``: statuses on every
    window; consensus, coverage, n_cols and each sequence's row on the
    windows that succeed (the TPU kernel pads MC and N to 128)."""
    kw, banded, _ = SHAPES["small"]
    windows = windows_for("small")[:3] + [["ACGT"], ["TTTT", "AAAA", "TAT"]]
    arrays = pack_windows("small", windows)
    got = [o.numpy() for o in poa_window.poa_window(
        *arrays, BatchSize(**kw), PoaScores(), banded, True)]
    want = [np.asarray(o) for o in poa_batch_pallas(
        *(jnp.asarray(a.numpy()) for a in arrays), JaxBatchSize(**kw),
        JaxPoaScores(), banded=banded, msa=True, interpret=True)]
    np.testing.assert_array_equal(got[5], want[5])
    assert (got[5] == 0).all()
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[4], want[4])
    for wi, w in enumerate(windows):
        n, nc = int(got[2][wi]), int(got[4][wi])
        np.testing.assert_array_equal(got[0][wi, :n], want[0][wi, :n])
        np.testing.assert_array_equal(got[1][wi, :n], want[1][wi, :n])
        np.testing.assert_array_equal(got[3][wi, :len(w), :nc],
                                      want[3][wi, :len(w), :nc])


def test_window_route_refuses_a_plan_over_shared_memory():
    """The shared memory of one window, counted as the kernel lays it out:
    the graph NW's ring, two rows' facts, the sequence and four words of
    state (the graph lives in device memory).  The correction and the deep
    shapes fit; a window whose pred facts alone pass what a block can have
    is refused with the sizes."""
    corr = BatchSize(max_sequence_size=256, max_nodes_per_window=384,
                     max_sequences_per_poa=8, max_pred_per_node=8,
                     max_aligned_per_node=4)
    deep = BatchSize(max_sequence_size=512, max_sequences_per_poa=16,
                     max_pred_per_node=16, max_aligned_per_node=8,
                     max_nodes_per_window=1024)
    limit = _build.SMEM_PER_BLOCK - 128
    assert poa_window.window_smem_bytes(corr) == 4 * 2180 < limit
    assert poa_window.window_smem_bytes(deep, 256) == 4 * 2292 < limit
    assert poa_window.window_plan(2_219, corr)[0] == "warp"
    assert poa_window.window_plan(434, deep, 256)[0] == "block"
    wide = BatchSize(max_sequence_size=256, max_nodes_per_window=384,
                     max_pred_per_node=9_700)
    assert poa_window.window_smem_bytes(wide, ring_rows=0) > limit
    with pytest.raises(ValueError, match="kernel=\"lockstep\""):
        poa_window.window_plan(8, wide)


def test_poa_window_checks_its_arguments():
    with pytest.raises(ValueError, match="int32"):
        poa_window.poa_window(*(a.long() for a in pack_windows(
            "small", windows_for("small")[:2])),
            BatchSize(**SHAPES["small"][0]), PoaScores())
    arrays = pack_windows("small", windows_for("small")[:2])
    with pytest.raises(ValueError, match="want seqs"):
        poa_window.poa_window(arrays[0][:, :2], *arrays[1:],
                              BatchSize(**SHAPES["small"][0]), PoaScores())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", poa.KERNELS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_batch_msa_on_card_equals_cpu(name, kernel):
    """With the MSA, by either kernel route: consensus, MSA and statuses on
    the card equal the CPU plain path's; poa_window's six outputs equal
    its plain version's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    windows = windows_for(name)
    card, _ = port_batch(name, windows, "cuda", output_mask=MSA,
                         kernel=kernel)
    cpu, _ = port_batch(name, windows, "cpu", output_mask=MSA)
    assert card.get_consensus() == cpu.get_consensus()
    assert card.get_msa() == cpu.get_msa()
    assert [g and g.serialize_to_dot() for g in card.get_graphs()] == \
        [g and g.serialize_to_dot() for g in cpu.get_graphs()]
    kw, banded, _ = SHAPES[name]
    arrays = [a.cuda() for a in pack_windows(name, windows)]
    for msa in (False, True):
        args = (*arrays, BatchSize(**kw), PoaScores(), banded, msa)
        for a, b in zip(poa_window.poa_window(*args),
                        poa_window.poa_window_torch(*args)):
            assert torch.equal(a, b)


#: scores whose cells pass the 24 bits of a 4-byte plane word at these
#: shapes: the graph NW runs on 8-byte words
WIDE = PoaScores(match_score=20_000, mismatch_score=-15_000,
                 gap_score=-20_000)


@pytest.mark.cuda
@pytest.mark.parametrize("variant, ring, scores", [
    ("warp", 8, PoaScores()), ("block", 8, PoaScores()),
    ("warp", 2, PoaScores()), ("block", 0, PoaScores()),
    ("warp", 8, WIDE), ("block", 8, WIDE),
])
@pytest.mark.parametrize("name", list(SHAPES))
def test_window_plans_on_card_equal_plain_version(name, variant, ring,
                                                  scores, monkeypatch):
    """B10 as a warp and as a block a window (BLOCK_WINDOWS set so that
    the launch takes the one asked for), with an 8- and a 2-row ring or
    none, on 4- and 8-byte plane words, with and without the MSA, against
    its plain version: windows that stop at different sequences, overflow
    (the overflow shape) and leave the band (the banded one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(poa_window, "BLOCK_WINDOWS",
                        0 if variant == "warp" else 1 << 20)
    monkeypatch.setattr(poa_window, "RING_ROWS", ring)
    kw, banded, _ = SHAPES[name]
    bs = BatchSize(**kw)
    arrays = [a.cuda() for a in pack_windows(name, windows_for(name))]
    W = arrays[0].shape[0]
    word = 8 if scores is WIDE else 4
    assert poa_window.window_plan(W, bs, bs.band_width if banded else 0,
                                  word)[::2] == (variant, ring)
    for msa in (False, True):
        args = (*arrays, bs, scores, banded, msa)
        got = poa_window.poa_window(*args)
        torch.cuda.synchronize()
        want = poa_window.poa_window_torch(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
