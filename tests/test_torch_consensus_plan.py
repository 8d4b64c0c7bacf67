"""The port's POA consensus kernel (claragenomicsanalysis_tpu_torch/csrc/
poa_consensus.cuh ``consensus_warp``, B8, also B10's consensus): its plan
chooser at every threshold, and a numpy replay of its algorithm held
against the plain PyTorch version (``ops/poa_consensus.py
consensus_torch``) and the JAX package's ``poa_ops.consensus``; and the
plain version against the TPU kernel's own function,
``_consensus_pallas(..., interpret=True)``.

The replay follows the kernel step by step: the table pass (the heaviest
in-edge, its tied preds), the visit order (rank's inverse; a hole means
rank is no permutation of the active nodes), the scores in one pass of 32
positions at a time with a tied pred earlier among the same 32 resolved in
position order, the confirming sweep, the Jacobi sweeps from the starting
scores where the window is not confirmed, the best preds, the end node and
the walk back.  The visit order changes the sweeps run, never an output, so
the cases include a cycle, ranks that are no permutation, ranks wrong on
purpose and ties.  The CUDA kernel itself runs only on the card (the
``cuda`` test and ``chip_smoke.py``); every comparison is exact."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.ops import poa_ops
from claragenomicsanalysis_tpu.ops.poa_pallas2 import _consensus_pallas
from claragenomicsanalysis_tpu_torch.core.config import BatchSize, PoaScores
from claragenomicsanalysis_tpu_torch.ops import (_build, poa_consensus,
                                                 poa_window)
from claragenomicsanalysis_tpu_torch.ops.convert import \
    poa_state_from_reference
from test_torch_poa_ops import port_bs, trajectory

NEG = -(1 << 30)
INT_MIN, INT_MAX = -2**31, 2**31 - 1


def wrap(a, b):
    """int32 addition, as the kernel's (and JAX's) wraps."""
    return (a + b + 2**31) % 2**32 - 2**31


def replay_window(npred, pred, predw, base, cov, rank, nc, MC):
    """consensus_warp on one window -> (codes, covs, length, confirmed in
    rank order, Jacobi sweeps)."""
    N, P = pred.shape
    nce = min(max(int(nc), 0), N)
    npred, pred, predw, rank = (np.asarray(a).astype(np.int64)
                                for a in (npred, pred, predw, rank))

    def clamp(q):
        return min(max(q, 0), N - 1)

    # the table pass
    wmx, ties, has = [], [], []
    for u in range(N):
        k = min(max(int(npred[u]), 0), P) if u < nce else 0
        wm = NEG if k < P else INT_MIN
        for p in range(k):
            wm = max(wm, int(predw[u, p]))
        ties.append([int(pred[u, p]) for p in range(k) if predw[u, p] == wm])
        wmx.append(wm)
        has.append(int(npred[u]) > 0)
    start = [0 if u < nce and not has[u] else NEG for u in range(N)]

    def tied_max(score, u):
        m = NEG if len(ties[u]) < P else INT_MIN
        for q in ties[u]:
            m = max(m, score[clamp(q)])
        return m

    def rule(score, u):
        return wrap(wmx[u], tied_max(score, u)) if has[u] else 0

    # the visit order: rank's inverse
    vis = [-1] * nce
    for u in range(nce):
        if 0 <= rank[u] < nce:
            vis[rank[u]] = u
    bad = min(vis, default=0) < 0
    sc = list(start)
    confirmed, jacobi = False, 0
    if not bad:
        for c0 in range(0, nce, 32):
            m, mask, val = {}, {}, {}
            for lane in range(32):
                i = c0 + lane
                u = vis[i] if i < nce else -1
                m[lane], mask[lane], val[lane] = 0, 0, 0
                if u < 0:
                    continue
                m[lane] = NEG if len(ties[u]) < P else INT_MIN
                for q in ties[u] if has[u] else []:
                    qc = clamp(q)
                    vq = int(rank[qc]) if qc < nce else -1
                    if c0 <= vq < i:
                        mask[lane] |= 1 << (vq - c0)
                    else:
                        m[lane] = max(m[lane], sc[qc])
                        bad |= vq >= i
                val[lane] = wrap(wmx[u], m[lane]) if has[u] else 0
            todo = 0
            for b in mask.values():
                todo |= b
            for j in range(32):
                if todo >> j & 1:
                    for lane in range(32):
                        if mask[lane] >> j & 1:
                            m[lane] = max(m[lane], val[j])
                            u = vis[c0 + lane]
                            val[lane] = wrap(wmx[u], m[lane])
            for lane in range(32):
                if c0 + lane < nce:
                    sc[vis[c0 + lane]] = val[lane]
        bad |= any(sc[u] != rule(sc, u) for u in range(nce) if has[u])
        confirmed = not bad
    if bad:                         # the Jacobi sweeps from the start
        sc, changed = list(start), True
        while changed and jacobi < N + 2:
            new = [rule(sc, u) if u < nce else NEG for u in range(N)]
            changed = new != sc
            sc = new
            jacobi += 1

    def best_pred(u):
        m = tied_max(sc, u)
        return next((q for q in ties[u] if sc[clamp(q)] == m),
                    int(pred[u, 0]))
    bp = [best_pred(u) if u < nce and has[u] else -1 for u in range(N)]

    # the end node, the walk back, the writes
    smax = max(sc[:nce] + [NEG if nc < N else INT_MIN])
    keys = [int(rank[u]) if u < nce and sc[u] == smax else 1 << 30
            for u in range(N)]
    end = keys.index(min(keys))
    k, buf = MC, [-1] * MC
    u = end if nc > 0 else -1
    while u >= 0 and k > 0:
        buf[k - 1] = u
        u = bp[u] if u < N else -1
        k -= 1
    codes, covs = np.full(MC, -1, np.int64), np.zeros(MC, np.int64)
    for i in range(MC - k):
        node = buf[i + k]
        if 0 <= node < N:
            codes[i], covs[i] = base[node], cov[node]
    return codes, covs, MC - k, confirmed, jacobi


def replay(npred, pred, predw, base, cov, rank, nc, MC):
    outs = [replay_window(*(a[w] for a in (npred, pred, predw, base, cov,
                                           rank, nc)), MC)
            for w in range(len(nc))]
    return tuple(np.array([o[k] for o in outs]) for k in range(5))


Graph = collections.namedtuple("Graph", "pred npred predw base cov "
                                        "node_count")


def jax_consensus(npred, pred, predw, base, cov, rank, nc, MC):
    g = Graph(*(jnp.asarray(np.asarray(a)) for a in (pred, npred, predw,
                                                     base, cov, nc)))
    fn = jax.jit(jax.vmap(lambda st, r: poa_ops.consensus(st, None, r, MC)))
    return tuple(map(np.asarray, fn(g, jnp.asarray(np.asarray(rank)))))


def held(args, jax_too=True):
    """The replay against consensus_torch and (``jax_too``)
    poa_ops.consensus, exactly -> (confirmed, Jacobi sweeps) a window."""
    codes, covs, length, confirmed, jacobi = replay(*args)
    want = poa_consensus.consensus_torch(
        *(torch.from_numpy(np.ascontiguousarray(a, np.int32))
          for a in args[:7]), args[7])
    for g, w, n in zip((codes, covs, length), want,
                       ("codes", "covs", "length")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=n)
    if jax_too:
        for g, w, n in zip((codes, covs, length), jax_consensus(*args),
                           ("codes", "covs", "length")):
            np.testing.assert_array_equal(g, w, err_msg=f"jax {n}")
    return confirmed, jacobi


def windows(n, blen, depth, edits, L, seed):
    rng = np.random.default_rng(seed)
    seqs = np.full((n, depth, L), -1, np.int32)
    lens = np.zeros((n, depth), np.int32)
    for w in range(n):
        b = rng.integers(0, 4, blen)
        for s in range(depth):
            m = b.copy()
            for _ in range(edits):
                kind, p = rng.integers(0, 3), int(rng.integers(0, len(m)))
                if kind == 0:
                    m[p] = (m[p] + 1) % 4
                elif kind == 1 and len(m) > 1:
                    m = np.delete(m, p)
                else:
                    m = np.insert(m, p, rng.integers(0, 4, 3))
            m = m[:L]
            seqs[w, s, :len(m)] = m
            lens[w, s] = len(m)
    weights = ((seqs >= 0) * (1 + np.arange(L) % 3)).astype(np.int32)
    return seqs, weights, lens, np.full(n, depth, np.int32)


def consensus_args(bs, banded, arrays):
    """The consensus call of a plain lockstep run (run_windows on the CPU):
    (npred, pred, predw, base, cov, rank, node_count) as numpy, and MC."""
    seen = []
    real = poa_window.consensus_torch

    def spy(*args):
        seen.append(args)
        return real(*args)

    poa_window.consensus_torch = spy
    try:
        poa_window.run_windows(bs, PoaScores(), banded,
                               *(torch.from_numpy(a) for a in arrays),
                               plain=True)
    finally:
        poa_window.consensus_torch = real
    (args,) = seen
    return tuple(a.numpy().copy() for a in args[:7]) + (args[7],)


#: small shapes of the three main paths and phase 10's tight caps:
#: (BatchSize keywords, banded, backbone length, edits)
SHAPES = {
    "correction": (dict(max_sequence_size=48, max_sequences_per_poa=8,
                        max_pred_per_node=8), False, 40, 3),
    "deep": (dict(max_sequence_size=64, max_sequences_per_poa=10,
                  max_pred_per_node=16, max_aligned_per_node=8,
                  band_width=24), True, 56, 5),
    "msa": (dict(max_sequence_size=40, max_sequences_per_poa=8), False, 32,
            3),
    "caps": (dict(max_sequence_size=32, max_sequences_per_poa=6,
                  max_pred_per_node=2, max_aligned_per_node=2,
                  max_nodes_per_window=40), False, 24, 8),
}


def shape_args(name):
    kw, banded, blen, edits = SHAPES[name]
    bs = BatchSize(**kw)
    return consensus_args(bs, banded, windows(
        6, blen, bs.max_sequences_per_poa, edits, bs.padded_seq,
        seed=len(name)))


@pytest.mark.parametrize("name", ["correction", "deep", "msa"])
def test_replay_on_lockstep_windows(name):
    """The consensus call of a lockstep run at a small shape of each main
    path: equal outputs, every window confirmed in rank order (one pass
    and its confirming sweep), no Jacobi sweep."""
    confirmed, jacobi = held(shape_args(name))
    assert confirmed.all() and (jacobi == 0).all()


EDGE_CASES = ("cycle", "duplicate rank", "rank out of range",
              "active nodes shuffled", "active nodes reversed", "ties",
              "node_count <= 0", "node_count past N", "tight caps")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_replay_on_edge_cases(case):
    """A cycle, ranks that are no permutation of the active nodes or are
    not topological, tied in-edges, node counts outside 0..N and the
    overflowed windows of phase 10's caps: the outputs still equal the
    Jacobi sweeps', and the windows that must leave the ordered pass do."""
    args = list(shape_args("caps" if case == "tight caps" else "correction"))
    npred, pred, predw, base, cov, rank, nc, MC = args
    N = pred.shape[1]
    rng = np.random.default_rng(EDGE_CASES.index(case))
    must_fall_back = np.zeros(len(nc), bool)
    if case == "cycle":                 # window 0: 9's pred 5, 5's pred 9
        pred[0, 5, 0], pred[0, 9, 0] = 9, 5
        npred[0, [5, 9]] = np.maximum(npred[0, [5, 9]], 1)
        predw[0, [5, 9], 0] = predw[0, [5, 9]].max() + 1
        must_fall_back[0] = True
    elif case == "duplicate rank":
        rank[:, 3] = rank[:, 4]
        must_fall_back[:] = True
    elif case == "rank out of range":
        rank[1:3, 7] = [-1, N + 4]
        must_fall_back[1:3] = True
    elif case in ("active nodes shuffled", "active nodes reversed"):
        for w in range(len(nc)):
            k = min(int(nc[w]), N)
            rank[w, :k] = (rng.permutation(k) if "shuffled" in case
                           else k - 1 - rank[w, :k])
        must_fall_back[:] = True
    elif case == "ties":
        predw[:, :, 1] = predw[:, :, 0]
    elif case == "node_count <= 0":
        nc[:2] = [0, -3]
    elif case == "node_count past N":
        nc[1] = N + 5
    confirmed, jacobi = held(tuple(args))
    assert not confirmed[must_fall_back].any()
    assert (jacobi[~confirmed] > 0).all() and (jacobi[confirmed] == 0).all()
    if case == "tight caps":
        assert confirmed.any()


def test_chain_across_chunks_resolves_by_shuffles():
    """A 40-node chain (each node's only pred the one before), ranked in
    chain order: every in-chunk pred is resolved by one shuffle a position
    and the second chunk reads the first's final scores, so one pass is
    confirmed; ranked backwards it falls back to Jacobi with the same
    outputs."""
    N, P, MC = 48, 4, 64
    npred = np.zeros((2, N), np.int32)
    pred = np.full((2, N, P), -1, np.int32)
    predw = np.zeros((2, N, P), np.int32)
    npred[:, 1:40] = 1
    pred[:, 1:40, 0] = np.arange(39)
    predw[:, 1:40, 0] = 1 + np.arange(39) % 3
    base = np.tile(np.arange(N, dtype=np.int32) % 4, (2, 1))
    cov = np.ones((2, N), np.int32)
    rank = np.tile(np.arange(N, dtype=np.int32), (2, 1))
    rank[1, :40] = 39 - np.arange(40)
    nc = np.array([40, 40], np.int32)
    args = (npred, pred, predw, base, cov, rank, nc, MC)
    confirmed, jacobi = held(args)
    assert confirmed[0] and jacobi[0] == 0
    assert not confirmed[1] and jacobi[1] == 40
    assert (replay(*args)[2] == 40).all()


def test_plain_version_matches_the_pallas_kernel_interpreted():
    """The function of the TPU kernel itself (argsort(rank) as its visit
    order), run in interpret mode, on the small shape of
    tests/test_torch_poa_ops.py: codes, coverages and lengths equal on every
    window."""
    tr = trajectory("small")
    state = jax.tree_util.tree_map(jnp.asarray, tr["state"])
    rank = tr["final_topsort"][2]
    want = _consensus_pallas(tr["bs"], True, state, jnp.asarray(rank))
    ps = poa_state_from_reference(tr["state"])
    got = poa_consensus.consensus_torch(
        ps.npred, ps.pred, ps.predw, ps.base, ps.cov,
        torch.from_numpy(np.array(rank)), ps.node_count,
        port_bs("small").max_consensus_size)
    for g, w, n in zip(got, want, ("codes", "covs", "length")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=n)


@pytest.mark.parametrize("N, MC, plan", [
    (256, 256, ("warp-shared", 4)),      # the MSA shape
    (384, 512, ("warp-shared", 4)),      # the correction shape
    (1_024, 1_024, ("warp-shared", 4)),  # the deep shape
    (2_176, 1_450, ("warp-shared", 4)),  # cli poa, 725-base sequences
    (2_184, 1_452, ("warp-shared", 2)),  # 726
    (4_352, 2_900, ("warp-shared", 2)),  # 1,450
    (4_360, 2_902, ("warp-shared", 1)),  # 1,451
    (8_712, 5_808, ("warp-shared", 1)),  # 2,904
    (8_720, 5_810, ("warp-device", 4)),  # 2,905: the tables in scratch
    (27_000, 18_000, ("warp-device", 4)),  # cli poa of 9,000 bases
])
def test_consensus_plan(N, MC, plan):
    assert poa_consensus.consensus_table_bytes(N, MC) == 4 * (6 * N + MC)
    for W, P in ((1, 4), (4_096, 16)):
        assert poa_consensus.consensus_plan(W, N, P, MC) == plan
    variant, n = plan
    fits = n * poa_consensus.consensus_table_bytes(N, MC) \
        <= _build.SMEM_PER_BLOCK
    assert fits == (variant == "warp-shared")


@pytest.mark.parametrize("S, plan", [(725, ("warp-shared", 4)),
                                     (726, ("warp-shared", 2)),
                                     (2_904, ("warp-shared", 1)),
                                     (2_905, ("warp-device", 4))])
def test_consensus_plan_at_cli_poa_sizes(S, plan):
    """cli poa sizes a batch from its longest sequence S: N = 3S (padded
    to 8), P = 4, MC = 2S."""
    bs = BatchSize(max_sequence_size=S, max_sequences_per_poa=3)
    assert poa_consensus.consensus_plan(
        3, bs.padded_nodes, bs.max_pred_per_node,
        bs.max_consensus_size) == plan


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_card():
    """B8 in each plan (4, 2 and 1 windows a block, the tables in device
    scratch) against the plain version on the card: lockstep windows of
    each small shape, a cyclic window and ranks that are no permutation."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cases = [shape_args(name) for name in SHAPES]
    npred, pred, predw, base, cov, rank, nc, MC = (
        a.copy() if isinstance(a, np.ndarray) else a for a in cases[0])
    pred[0, 5, 0], pred[0, 9, 0] = 9, 5
    npred[0, [5, 9]] = np.maximum(npred[0, [5, 9]], 1)
    rank[1, 3] = rank[1, 4]
    cases.append((npred, pred, predw, base, cov, rank, nc, MC))
    for args in cases:
        d = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for a in args[:7]]
        N, P = args[1].shape[1:]
        want = poa_consensus.consensus_torch(*d, args[7])
        per = poa_consensus.consensus_table_bytes(N, args[7])
        for limit, plan in ((None, ("warp-shared", 4)),
                            (2 * per, ("warp-shared", 2)),
                            (per, ("warp-shared", 1)),
                            (per - 1, ("warp-device", 4))):
            saved = _build.SMEM_PER_BLOCK
            if limit is not None:
                _build.SMEM_PER_BLOCK = limit
            try:
                assert poa_consensus.consensus_plan(
                    len(args[6]), N, P, args[7]) == plan
                got = poa_consensus.consensus(*d, args[7])
                torch.cuda.synchronize()
            finally:
                _build.SMEM_PER_BLOCK = saved
            for g, w in zip(got, want):
                assert torch.equal(g, w), plan
