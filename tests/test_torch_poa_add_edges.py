"""B6's plain version (``ops.poa_add.add_alignment_torch``) against the JAX
package's ``poa_ops.add_alignment`` at the edges the warp add of
``csrc/poa_add.cuh`` branches on: clique capacities A = 1, 31, 32 and 63
(the members of a clique spill into a second register a lane past 32),
pred-slot counts P = 1, 32, 33 and 64 (the slots spill into a second lane
chunk past 32), a clique and a pred row filled exactly, both overflows
(node and edge) and the clique one, a pred inserted in front of a full row
(every slot shifts), and a path with long runs of inert entries and
deletions walked from k0 = 0.

The graph states are made by hand from a chain (``init_state``): node 6
sits in a clique of K extra nodes (every member's list the others, sorted),
all of them preds of node 7.  Each window then adds one sequence:

- window 0: the chain's bases with an N at position 6 (an N matches no
  node, so it makes a new node beside node 6, which joins the clique) and a
  base unlike node 12's at 12 (a new node that joins node 12's clique of
  one);
- window 1: positions 4-6 deleted, so node 7 takes the edge from node 3,
  the smallest pred, inserted in front of the row;
- window 2: the path of window 0 spread out, a -2 and a (-1, -1) entry
  between every two steps, walked from k0 = 0;
- window 3: two insertions (a base on no node) and an N.

The comparison is exact, every field, ``paths`` row included.  The card
test holds the kernel against the plain version on the same states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core.config import BatchSize as JaxBatchSize
from claragenomicsanalysis_tpu.ops import poa_ops
from claragenomicsanalysis_tpu_torch.core.config import BatchSize
from claragenomicsanalysis_tpu_torch.ops import poa_add
from claragenomicsanalysis_tpu_torch.ops.convert import (
    poa_state_from_reference, poa_state_to_reference)
from claragenomicsanalysis_tpu_torch.ops.poa_state import init_state

CHAIN = 20           # bases of the first sequence
S_IDX = 1            # the added sequence's paths row

#: case -> (A, P, K extra clique members of node 6, max_nodes_per_window or
#: None for the default, the statuses the windows must end in)
CASES = {
    "A1-clique-overflow": (1, 4, 1, None, {0, 23}),
    "A31-clique-filled": (31, 40, 30, None, {0}),
    "A32-clique-over": (32, 36, 32, None, {0, 23}),
    "A63-P64-filled": (63, 64, 62, None, {0}),
    "P1-edge-overflow": (4, 1, 2, None, {24}),
    "P33-second-chunk": (31, 33, 31, None, {0, 23}),
    "P32-row-full": (31, 32, 31, None, {0, 23, 24}),
    "node-overflow": (4, 8, 3, CHAIN + 3, {0, 23}),
}


def batch_size(A, P, max_nodes):
    return dict(max_sequence_size=48, max_sequences_per_poa=3,
                max_pred_per_node=P, max_aligned_per_node=A,
                max_nodes_per_window=max_nodes or 128)


def made_state(A, P, K, max_nodes):
    """The hand-made graphs of four windows (module docstring) -> (port
    state with ``paths``, the chain's codes)."""
    bs = BatchSize(**batch_size(A, P, max_nodes))
    W, L = 4, bs.padded_seq
    rng = np.random.default_rng(A * 100 + P)
    chain = rng.integers(0, 4, CHAIN).astype(np.int32)
    seq0 = np.full((W, L), -1, np.int32)
    seq0[:, :CHAIN] = chain
    w0 = (seq0 >= 0).astype(np.int32)
    st = init_state(bs, torch.from_numpy(seq0), torch.from_numpy(w0),
                    torch.full((W,), CHAIN, dtype=torch.int32), msa=True)
    a = {k: v.copy() for k, v in poa_state_to_reference(st).items()}
    members = list(range(CHAIN, CHAIN + K))
    clique = [6] + members
    for x in members:
        a["base"][:, x] = (chain[6] + 1 + x) % 4
        a["cov"][:, x] = 1
        a["npred"][:, x] = 1
        a["pred"][:, x, :] = -1
        a["pred"][:, x, 0] = 5
        a["predw"][:, x, :] = 0
        a["predw"][:, x, 0] = 1
        a["nsucc"][:, x] = 1
    a["nsucc"][:, 5] += K
    for x in clique:
        others = sorted(set(clique) - {x})
        a["nalig"][:, x] = len(others)
        a["alig"][:, x, :] = -1
        a["alig"][:, x, :len(others)] = others[:A]
    preds = sorted(clique)[:P]
    a["npred"][:, 7] = len(preds)
    a["pred"][:, 7, :] = -1
    a["pred"][:, 7, :len(preds)] = preds
    a["predw"][:, 7, :] = 0
    a["predw"][:, 7, :len(preds)] = 1
    a["node_count"][:] = CHAIN + K
    state = poa_state_from_reference(
        type("S", (), {k: v for k, v in a.items()}))
    return bs, state, chain


def made_paths(bs, chain):
    """(pn, pp, seq, weights, k0) of the four windows' added sequences."""
    W, L = 4, bs.padded_seq
    TL = bs.padded_nodes + L
    pn = np.full((W, TL), -2, np.int32)
    pp = np.full((W, TL), -2, np.int32)
    seq = np.full((W, L), -1, np.int32)
    k0 = np.zeros(W, np.int32)
    other = (chain[12] + 2) % 4

    def put(w, steps, bases, start=None):
        n = len(steps)
        k = TL - n if start is None else start
        for i, (u, p) in enumerate(steps):
            pn[w, k + i], pp[w, k + i] = u, p
        seq[w, :len(bases)] = bases
        k0[w] = TL - n if start is None else 0

    s0 = chain.copy()
    s0[6], s0[12] = -1, other
    put(0, [(u, u) for u in range(CHAIN)], s0)
    s1 = np.concatenate([chain[:4], chain[7:]])
    put(1, [(u, u) for u in range(4)] + [(u, -1) for u in (4, 5, 6)]
        + [(u, u - 3) for u in range(7, CHAIN)], s1)
    spread = []
    for u in range(CHAIN):
        spread += [(u, u), (-2, -2), (-1, -1)]
    put(2, spread, s0, start=TL - 3 * CHAIN)
    s3 = np.concatenate([chain[:9], [1, 2], chain[9:]])
    s3[15] = -1
    put(3, [(u, u) for u in range(9)] + [(-1, 9), (-1, 10)]
        + [(u, u + 2) for u in range(9, CHAIN)], s3)
    weights = ((seq >= 0) * (1 + np.arange(L) % 3)).astype(np.int32)
    return pn, pp, seq, weights, k0


@functools.lru_cache(maxsize=None)
def jax_add(A, P, max_nodes):
    bs = JaxBatchSize(**batch_size(A, P, max_nodes))

    def add(state, pn, pp, seq, w, k0):
        return poa_ops.add_alignment(state, pn, pp, seq, w, jnp.int32(S_IDX),
                                     bs, path_start=k0)
    return jax.jit(jax.vmap(add))


def case_args(name):
    A, P, K, max_nodes, _ = CASES[name]
    bs, state, chain = made_state(A, P, K, max_nodes)
    pn, pp, seq, weights, k0 = made_paths(bs, chain)
    act = torch.ones(4, dtype=torch.bool)
    return (state, torch.from_numpy(pn), torch.from_numpy(pp),
            torch.from_numpy(seq), torch.from_numpy(weights),
            torch.from_numpy(k0), act, bs.max_nodes_per_window, S_IDX)


@pytest.mark.parametrize("name", list(CASES))
def test_add_alignment_edges_match_poa_ops(name):
    A, P, K, max_nodes, statuses = CASES[name]
    args = case_args(name)
    state = args[0]
    got = poa_state_to_reference(poa_add.add_alignment_torch(*args))
    ref = poa_ops.PoaState(**poa_state_to_reference(state))
    want = jax_add(A, P, max_nodes)(ref, *(np.asarray(a) for a in args[1:6]))
    for field in ref._fields:
        np.testing.assert_array_equal(got[field],
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    # the edges the case is for were reached: its statuses, a clique
    # filled to A, node 7's pred row filled to P
    assert set(got["status"].tolist()) == statuses
    if K >= 30:
        assert got["nalig"].max() == A
    if name.startswith("P") or name.startswith("A63"):
        assert got["npred"][:, 7].max() == P


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_warp_add_matches_plain_version_on_card(name, cuda_device):
    args = case_args(name)
    state = args[0]
    dev = tuple(a.to(cuda_device) if torch.is_tensor(a) else a
                for a in args[1:7])
    state = type(state)(*(t.to(cuda_device) for t in state))
    got = poa_add.add_alignment(state, *dev, *args[7:])
    want = poa_add.add_alignment_torch(state, *dev, *args[7:])
    for a, b in zip(got.tensors(), want.tensors()):
        assert torch.equal(a, b)
