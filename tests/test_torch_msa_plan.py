"""The port's POA MSA kernel (claragenomicsanalysis_tpu_torch/csrc/poa_msa.cuh
``msa_warp``, B9, also B10's MSA): its plan chooser at every threshold,
C10's pins (cli poa at 19,370 / 19,371-base sequences), and a numpy replay
of its column pass held against the plain PyTorch version
(``ops/poa_msa.py msa_columns_torch``) and the JAX package's
``poa_ops.msa_columns``.

The replay follows the kernel: the warp gathers 32 ranks at a time (fewer
where a rank's (A + 1) (P + 1) entries are many), a lane a rank, each
rank's members (its node, then its aligned nodes, those in [0, N)) and
their filled pred ids in [0, N) into the rank lists; then it walks those
ranks in order: a rank whose node has a column already is skipped, else
its clique takes 1 + the largest column of the listed preds.  One rank a
gather (the kernel's count at the largest clique and pred capacities)
gives the same columns; an order that is not topological changes the
columns but not the agreement.  The CUDA kernel itself runs only on the
card (the ``cuda`` tests and ``chip_smoke.py``); every comparison is
exact."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.ops import poa_ops
from claragenomicsanalysis_tpu_torch.core.config import BatchSize, PoaScores
from claragenomicsanalysis_tpu_torch.ops import _build, poa_msa, poa_window
from claragenomicsanalysis_tpu_torch.ops.poa_state import PoaState
from test_torch_consensus_plan import SHAPES, windows


def rank_list(order, npred, nalig, pred, alig, r):
    """Rank r's node, its members (the node, then its aligned nodes, those
    in [0, N)) and their filled pred ids in [0, N), as the gather lists
    them."""
    N, P = pred.shape
    A = alig.shape[1]
    u = min(max(int(order[r]), 0), N - 1)
    group = [u] + [int(alig[u, i]) for i in range(min(int(nalig[u]), A))]
    members = [m for m in group if 0 <= m < N]
    preds = [int(q) for m in members
             for q in pred[m, :max(min(int(npred[m]), P), 0)] if 0 <= q < N]
    return u, members, preds


def replay_columns(order, npred, nalig, pred, alig, nc, ranks):
    """msa_warp's column pass on one window, ``ranks`` ranks a gather (the
    kernel's msa_gather_ranks) -> (col, n_cols, ranks that gave a clique
    its column, gathers)."""
    N = pred.shape[0]
    nce = min(max(int(nc), 0), N)
    col = [-1] * N
    done = gathers = 0
    for r0 in range(0, nce, ranks):
        gathers += 1
        lists = [rank_list(order, npred, nalig, pred, alig, r)
                 for r in range(r0, min(r0 + ranks, nce))]
        for u, members, preds in lists:
            if col[u] >= 0:
                continue                   # its clique has its column
            c = max([col[q] for q in preds] + [-1]) + 1
            for m in members:
                col[m] = c
            done += 1
    return col, max(col[:nce] + [-1]) + 1, done, gathers


def msa_args(bs, banded, arrays):
    """The MSA call of a plain lockstep run (run_windows on the CPU):
    (state, order)."""
    seen = []
    real = poa_window.msa_torch

    def spy(*args):
        seen.append(args)
        return real(*args)

    poa_window.msa_torch = spy
    try:
        poa_window.run_windows(bs, PoaScores(), banded,
                               *(torch.from_numpy(a) for a in arrays),
                               msa=True, plain=True)
    finally:
        poa_window.msa_torch = real
    (args,) = seen
    return args


Graph = collections.namedtuple("Graph", "pred npred alig nalig node_count")


def held(state, order, ranks, status_ok):
    """The replay against msa_columns_torch on every window and
    poa_ops.msa_columns on the windows ``status_ok`` (SUCCESS, node N - 1
    unused) but node N - 1 (C7), exactly -> (ranks given a column,
    gathers) a window."""
    W, N, P = state.pred.shape
    npy = [a.numpy() for a in (order, state.npred, state.nalig, state.pred,
                               state.alig, state.node_count)]
    outs = [replay_columns(*(a[w] for a in npy), ranks) for w in range(W)]
    col = np.array([o[0] for o in outs])
    n_cols = np.array([o[1] for o in outs])
    want_col, want_n = poa_msa.msa_columns_torch(state, order)
    np.testing.assert_array_equal(col, want_col.numpy(), err_msg="col")
    np.testing.assert_array_equal(n_cols, want_n.numpy(), err_msg="n_cols")
    g = Graph(*(jnp.asarray(a) for a in (npy[3], npy[1], npy[4], npy[2],
                                         npy[5])))
    jcol, jn = jax.jit(jax.vmap(lambda st, o: poa_ops.msa_columns(
        st, o, None)))(g, jnp.asarray(npy[0]))
    # poa_ops' drop-mode scatter wraps a dropped id onto node N - 1 (C7)
    np.testing.assert_array_equal(col[status_ok, :N - 1],
                                  np.asarray(jcol)[status_ok, :N - 1],
                                  err_msg="jax col")
    np.testing.assert_array_equal(n_cols[status_ok],
                                  np.asarray(jn)[status_ok],
                                  err_msg="jax n_cols")
    return np.array([o[2] for o in outs]), np.array([o[3] for o in outs])


def shape_args(name):
    kw, banded, blen, edits = SHAPES[name]
    bs = BatchSize(**kw)
    state, order = msa_args(bs, banded, windows(
        6, blen, bs.max_sequences_per_poa, edits, bs.padded_seq,
        seed=len(name)))
    ok = ((state.status == 0) & (state.node_count < bs.padded_nodes)).numpy()
    return bs, state, order, ok


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("one_rank", [False, True])
def test_replay_columns_on_lockstep_windows(name, one_rank):
    """The MSA call of a lockstep run at a small shape of each main path
    and under phase 10's tight caps: equal columns, with the kernel's ranks
    a gather (one gather a chunk of 32 ranks) and with one rank a gather."""
    bs, state, order, ok = shape_args(name)
    P, A = bs.max_pred_per_node, bs.max_aligned_per_node
    ranks = 1 if one_rank else poa_msa.msa_gather_ranks(P, A)
    assert ranks == 1 or ranks == 32
    done, gathers = held(state, order, ranks, ok)
    nce = state.node_count.clamp(0, bs.padded_nodes).numpy()
    assert (done > 0).all() and (done <= nce).all()
    assert ok.any() or name == "caps"     # every caps window overflows
    assert (gathers == -(-nce // ranks)).all()


def test_replay_columns_in_an_order_that_is_not_topological():
    """A random order of the nodes: other columns, the same in the replay,
    the plain version and the JAX package."""
    bs, state, order, ok = shape_args("msa")
    rng = np.random.default_rng(5)
    shuffled = torch.from_numpy(np.stack([
        rng.permutation(bs.padded_nodes) for _ in range(len(order))
    ]).astype(np.int32))
    held(state, shuffled, poa_msa.msa_gather_ranks(bs.max_pred_per_node,
                                                   bs.max_aligned_per_node),
         ok)


@pytest.mark.parametrize("P, A, ranks", [(4, 4, 32), (8, 4, 32),
                                         (16, 8, 32), (15, 15, 32),
                                         (16, 15, 30), (40, 31, 6),
                                         (64, 63, 1), (300, 63, 1)])
def test_msa_gather_ranks_and_list_ints(P, A, ranks):
    """32 ranks a gather, or as many as 8,192 ints hold at (A + 1) (P + 1)
    a rank, at least one; the lists hold that many ranks."""
    assert poa_msa.msa_gather_ranks(P, A) == ranks
    ints = ranks * (A + 1) * (P + 1)
    assert poa_msa.msa_list_ints(P, A) == ints
    assert poa_msa.msa_table_bytes(1_000, P, A) == 4 * (1_000 + ints)


@pytest.mark.parametrize("N, P, A, plan", [
    (256, 4, 4, ("warp-shared", 4)),       # the MSA shape
    (384, 8, 4, ("warp-shared", 4)),       # the correction shape
    (1_024, 16, 8, ("warp-shared", 4)),    # the deep shape
    (13_728, 4, 4, ("warp-shared", 4)),    # cli poa, 4,576-base sequences
    (13_736, 4, 4, ("warp-shared", 2)),    # 4,577
    (28_256, 4, 4, ("warp-shared", 2)),    # 9,418
    (28_264, 4, 4, ("warp-shared", 1)),    # 9,419
    (57_312, 4, 4, ("warp-shared", 1)),    # 19,104
    (57_320, 4, 4, ("warp-cols-shared", 1)),  # 19,105: lists in scratch
    (58_112, 4, 4, ("warp-cols-shared", 1)),  # 19,370: 4N = 227 KB
    (58_120, 4, 4, ("warp-device", 4)),    # 19,371 (C10)
])
def test_msa_plan(N, P, A, plan):
    for W, S, L in ((1, 3, 128), (4_096, 8, 128)):
        assert poa_msa.msa_plan(W, N, P, A, S, L) == plan
    variant, n = plan
    fits = n * poa_msa.msa_table_bytes(N, P, A) <= _build.SMEM_PER_BLOCK
    assert fits == (variant == "warp-shared")
    assert (4 * N <= _build.SMEM_PER_BLOCK) == (variant != "warp-device")
    scratch = poa_msa.msa_scratch_ints(variant, N, P, A)
    assert scratch == {"warp-shared": 0,
                       "warp-cols-shared": poa_msa.msa_list_ints(P, A),
                       "warp-device": N + poa_msa.msa_list_ints(P, A)}[
                           variant]


@pytest.mark.parametrize("S, shared", [(19_370, True), (19_371, False)])
def test_c10_cli_poa_threshold(S, shared):
    """C10: cli poa sizes a batch from its longest sequence S (N = 3S
    padded to 8: 58,112 and 58,120 here, P = A = 4); the first design kept
    its columns (4N bytes) in shared memory only and refused N past
    58,112.  Now the columns stay in shared memory through 19,370 bases
    and move to device memory from 19,371, where nothing refuses them."""
    bs = BatchSize(max_sequence_size=S, max_sequences_per_poa=3)
    N = bs.padded_nodes
    assert N == (58_112 if shared else 58_120)
    variant, _ = poa_msa.msa_plan(3, N, bs.max_pred_per_node,
                                  bs.max_aligned_per_node, 3, bs.padded_seq)
    assert (variant != "warp-device") == shared
    assert (4 * N <= _build.SMEM_PER_BLOCK) == shared


def c10_state(N=58_120, W=2, S=3, L=64, nodes=300, seed=0):
    """A synthetic final graph at N nodes a window with a few hundred
    active ones: a backbone chain, a branch of aligned pairs, short paths
    (the threshold is N, not node_count, so the plain version stays
    cheap).  -> (PoaState, order) on the CPU."""
    rng = np.random.default_rng(seed)
    P, A = 4, 4
    base = np.full((W, N), -1, np.int32)
    npred = np.zeros((W, N), np.int32)
    nalig = np.zeros((W, N), np.int32)
    pred = np.full((W, N, P), -1, np.int32)
    alig = np.full((W, N, A), -1, np.int32)
    paths = np.full((W, S, L), -1, np.int32)
    base[:, :nodes] = rng.integers(0, 4, (W, nodes))
    npred[:, 1:nodes] = 1
    pred[:, 1:nodes, 0] = np.arange(nodes - 1)
    for w in range(W):                  # aligned pairs (u, u + 1) here
        for u in range(10 + w, nodes - 2, 37):
            nalig[w, u] = nalig[w, u + 1] = 1
            alig[w, u, 0], alig[w, u + 1, 0] = u + 1, u
            pred[w, u + 1, 0] = u - 1
        for s in range(S):
            start = int(rng.integers(0, nodes - L))
            paths[w, s] = np.arange(start, start + L)
    order = np.tile(np.arange(N, dtype=np.int32), (W, 1))
    nc = np.full(W, nodes, np.int32)
    t = torch.from_numpy
    state = PoaState(base=t(base), cov=t(np.ones((W, N), np.int32)),
                     npred=t(npred), pred=t(pred),
                     predw=t(np.ones((W, N, P), np.int32)),
                     nsucc=t(np.zeros((W, N), np.int32)), nalig=t(nalig),
                     alig=t(alig), node_count=t(nc),
                     status=t(np.zeros(W, np.int32)), paths=t(paths))
    return state, t(order)


def test_c10_state_replays_on_the_cpu():
    """The direct C10 launch's inputs, as the card test makes them: the
    replay and the plain version agree and the aligned pairs share a
    column."""
    state, order = c10_state(N=640)
    col, n_cols, done, _ = replay_columns(
        *(a[0].numpy() for a in (order, state.npred, state.nalig,
                                 state.pred, state.alig, state.node_count)),
        poa_msa.msa_gather_ranks(4, 4))
    want_col, want_n = poa_msa.msa_columns_torch(state, order)
    np.testing.assert_array_equal(col, want_col[0].numpy())
    assert n_cols == int(want_n[0]) and col[10] == col[11] >= 0
    assert done < 300


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_card():
    """B9 in each plan (4, 2 and 1 windows a block, the columns alone in
    shared memory, both tables in device scratch) against the plain
    version on the card, at the MSA call of each small shape's lockstep
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for name in SHAPES:
        bs, state, order, _ = shape_args(name)
        N, P, A = (bs.padded_nodes, bs.max_pred_per_node,
                   bs.max_aligned_per_node)
        S, L = state.paths.shape[1:]
        d = PoaState(*(None if x is None else x.cuda() for x in state))
        want = poa_msa.msa_torch(d, order.cuda())
        per = poa_msa.msa_table_bytes(N, P, A)
        for limit, plan in ((None, ("warp-shared", 4)),
                            (2 * per, ("warp-shared", 2)),
                            (per, ("warp-shared", 1)),
                            (4 * N, ("warp-cols-shared", 1)),
                            (4 * N - 4, ("warp-device", 4))):
            saved = _build.SMEM_PER_BLOCK
            if limit is not None:
                _build.SMEM_PER_BLOCK = limit
            try:
                assert poa_msa.msa_plan(len(order), N, P, A, S, L) == plan
                got = poa_msa.msa(d, order.cuda())
                torch.cuda.synchronize()
            finally:
                _build.SMEM_PER_BLOCK = saved
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, plan)


@pytest.mark.cuda
def test_c10_direct_launch_at_58120_nodes():
    """C10 on the card: B9 launched at N = 58,120 (cli poa's sizing for a
    19,371-base sequence, past what the first design's shared memory
    held) on a synthetic state of 300 active nodes a window, in its plan
    (the tables in device scratch), against msa_torch; max_abs_err 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    state, order = c10_state()
    N = state.base.shape[1]
    assert poa_msa.msa_plan(2, N, 4, 4, 3, 64) == ("warp-device", 4)
    d = PoaState(*(x.cuda() for x in state))
    want = poa_msa.msa_torch(d, order.cuda())
    got = poa_msa.msa(d, order.cuda())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].min()) > 0
