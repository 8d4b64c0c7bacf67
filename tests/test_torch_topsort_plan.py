"""The port's POA topsort kernel (claragenomicsanalysis_tpu_torch/csrc/
poa_topsort.cuh ``topsort_warp``, B7, also B10's topsort): its plan chooser
at every threshold, and a numpy replay of its algorithm held against the
plain PyTorch version (``ops/poa_topsort.py topsort_torch``) and the JAX
package's ``poa_ops.topsort``.

The replay follows the kernel step by step: the visit order (old nodes by
their carried (level, id), each new node after its anchor through
first-pred links, whole chains), ordered sweeps of 32 positions at a time
with a pred earlier among the same 32 resolved in position order, the
confirming sweep, the Jacobi sweeps from the starting levels where the
ordered ones do not reach a fixpoint, and the rank by a counting sort (by a
count where the levels did not converge).  The visit order is a hint: it
changes the sweeps run, never an output, so the graphs include hints that
are wrong on purpose, a cycle, and preds that point nowhere.  The CUDA
kernel itself runs only on the card (the ``cuda`` test and
``chip_smoke.py``); every comparison is exact."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.ops import poa_ops
from claragenomicsanalysis_tpu_torch.core.config import BatchSize, PoaScores
from claragenomicsanalysis_tpu_torch.ops import _build, poa_topsort, poa_window

#: the kernel's ordered sweeps before the Jacobi ones (poa_topsort.cuh)
ORDERED_SWEEPS = 3
INT_MAX = 2**31 - 1


def pulled(lv, npred, pred, u, N, P):
    m = -1
    for p in range(min(int(npred[u]), P)):
        q = int(pred[u, p])
        m = max(m, int(lv[q]) if 0 <= q < N else -1)
    return max(m + 1, 0)


def counting_sort(ids, key):
    """A stable counting sort of ``ids`` (in id order) by key: positions."""
    return {u: r for r, u in enumerate(sorted(ids, key=lambda u: (key(u), u)))}


def replay_window(level, npred, pred, nc, nc_pre):
    """topsort_warp on one window -> (level, order, rank, ok, ordered
    sweeps, Jacobi sweeps)."""
    N, P = pred.shape
    nce = min(max(int(nc), 0), N)
    nold = min(max(int(nc_pre), 0), nce)
    start_lv = np.where(np.arange(N) < nce, np.maximum(level, 0), 0)
    lv = start_lv.astype(np.int64).copy()

    def pred0(u):
        return int(pred[u, 0]) if P > 0 and npred[u] > 0 else -1

    # the visit order
    ro = counting_sort(range(nold), lambda u: min(int(lv[u]), nce))
    weight = [1] * nold
    vpos, start, anchor, roots = {}, {}, {}, []
    s = -1
    for u in range(nold, nce):
        if not (pred0(u) == u - 1 and u - 1 >= nold):
            s = u                                   # a chain's head
        start[u] = s
        a0 = pred0(s)
        if 0 <= a0 < nold:
            anchor[u] = a0
            weight[ro[a0]] += 1
        else:
            vpos[u] = len(roots)
            roots.append(u)
    excl = np.concatenate([[0], np.cumsum(weight)[:-1]]).astype(int)
    for u in range(nold):
        vpos[u] = len(roots) + int(excl[ro[u]])
    for u, a0 in anchor.items():
        vpos[u] = vpos[a0] + u - start[u] + 1
    vis = [-1] * nce
    for u in range(nce):
        if 0 <= vpos[u] < nce:
            vis[vpos[u]] = u

    ordered, changed = 0, True
    while changed and ordered < ORDERED_SWEEPS:
        for c0 in range(0, nce, 32):
            val, mask = {}, {}
            for lane in range(32):
                i = c0 + lane
                u = vis[i] if i < nce else -1
                if u < 0:
                    val[lane], mask[lane] = 0, 0
                    continue
                m, bits = -1, 0
                for p in range(min(int(npred[u]), P)):
                    q = int(pred[u, p])
                    if q < 0 or q >= N:
                        continue
                    vq = vpos[q] if q < nce else INT_MAX
                    if c0 <= vq < i:
                        bits |= 1 << (vq - c0)
                    else:
                        m = max(m, int(lv[q]))
                val[lane], mask[lane] = max(m + 1, 0), bits
            todo = 0
            for b in mask.values():
                todo |= b
            for j in range(32):
                if todo >> j & 1:
                    for lane in range(32):
                        if mask[lane] >> j & 1:
                            val[lane] = max(val[lane], val[j] + 1)
            for lane in range(32):
                i = c0 + lane
                if i < nce and vis[i] >= 0:
                    lv[vis[i]] = val[lane]
        ordered += 1
        changed = any(pulled(lv, npred, pred, u, N, P) != lv[u]
                      for u in range(nce))
    jacobi = 0
    if changed:                     # the Jacobi sweeps from the start
        lv = start_lv.astype(np.int64).copy()
        while changed and jacobi < N + 2:
            new = lv.copy()
            for u in range(nce):
                new[u] = pulled(lv, npred, pred, u, N, P)
            changed = bool((new != lv).any())
            lv = new
            jacobi += 1
    rank = np.arange(N)
    if not changed:
        rank[:nce] = [r for _, r in sorted(
            counting_sort(range(nce), lambda u: int(lv[u])).items())]
    else:                           # the count of smaller int32 keys
        key = ((lv[:nce] * N + np.arange(nce)) & 0xFFFFFFFF).astype(
            np.uint32).view(np.int32)
        rank[:nce] = [(key < key[u]).sum() for u in range(nce)]
    order = np.empty(N, np.int64)
    order[rank] = np.arange(N)
    return lv, order, rank, not changed, ordered, jacobi


def replay(level, npred, pred, nc, nc_pre):
    outs = [replay_window(level[w], npred[w], pred[w], nc[w], nc_pre[w])
            for w in range(len(nc))]
    return tuple(np.stack([o[k] for o in outs]) for k in range(6))


Graph = collections.namedtuple("Graph", "pred npred node_count")


def jax_topsort(level, npred, pred, nc):
    N = level.shape[1]
    fn = jax.jit(jax.vmap(lambda g, lv: poa_ops.topsort(g, lv, N + 2)))
    return tuple(map(np.asarray, fn(Graph(jnp.asarray(pred),
                                          jnp.asarray(npred),
                                          jnp.asarray(nc)),
                                    jnp.asarray(level))))


def held(level, npred, pred, nc, nc_pre, jax_too=True):
    """The replay against topsort_torch and (``jax_too``) poa_ops.topsort,
    exactly -> the replay's ordered and Jacobi sweeps."""
    lv, order, rank, ok, ordered, jacobi = replay(level, npred, pred, nc,
                                                  nc_pre)
    want = poa_topsort.topsort_torch(
        *(torch.from_numpy(np.ascontiguousarray(x, np.int32))
          for x in (level, npred, pred, nc, nc_pre)))
    for g, w, n in zip((lv, order, rank, ok), want,
                       ("level", "order", "rank", "ok")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=n)
    if jax_too:
        for g, w, n in zip((lv, order, rank, ok),
                           jax_topsort(level, npred, pred, nc),
                           ("level", "order", "rank", "ok")):
            np.testing.assert_array_equal(g, w, err_msg=f"jax {n}")
    return ordered, jacobi


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
    return seqs, (seqs >= 0).astype(np.int32), lens, \
        np.full(n, depth, np.int32)


def topsort_calls(bs, banded, arrays, msa, monkeypatch):
    """Every topsort call of a plain lockstep run (run_windows on the CPU):
    its (level, npred, pred, node_count, nc_pre) as numpy arrays."""
    calls = []
    real = poa_window.topsort_torch

    def spy(*args):
        calls.append(tuple(a.numpy().copy() for a in args))
        return real(*args)

    monkeypatch.setattr(poa_window, "topsort_torch", spy)
    poa_window.run_windows(bs, PoaScores(), banded,
                           *(torch.from_numpy(a) for a in arrays), msa,
                           plain=True)
    return calls


#: small shapes of the three main paths: (BatchSize keywords, banded, MSA,
#: backbone length, edits)
SHAPES = {
    "correction": (dict(max_sequence_size=48, max_sequences_per_poa=8,
                        max_pred_per_node=8), False, False, 40, 3),
    "deep": (dict(max_sequence_size=64, max_sequences_per_poa=10,
                  max_pred_per_node=16, max_aligned_per_node=8,
                  band_width=24), True, False, 56, 5),
    "msa": (dict(max_sequence_size=40, max_sequences_per_poa=8), False, True,
            32, 3),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_replay_on_lockstep_windows(name, monkeypatch):
    """Every topsort call of a lockstep run at a small shape of each main
    path: equal outputs, and the hint right: one ordered sweep (and its
    confirming sweep) a window, no Jacobi sweep."""
    kw, banded, msa, blen, edits = SHAPES[name]
    bs = BatchSize(**kw)
    arrays = windows(6, blen, bs.max_sequences_per_poa, edits,
                     bs.padded_seq, seed=len(name))
    calls = topsort_calls(bs, banded, arrays, msa, monkeypatch)
    assert len(calls) == bs.max_sequences_per_poa
    new_nodes = 0
    for i, (level, npred, pred, nc, nc_pre) in enumerate(calls):
        ordered, jacobi = held(level, npred, pred, nc, nc_pre,
                               jax_too=i in (1, len(calls) - 1))
        assert (ordered == 1).all() and (jacobi == 0).all(), (i, ordered)
        new_nodes += int((nc - nc_pre).sum())
    assert new_nodes > 0


def dag(seed, N=64, P=4, nc=50):
    """A seeded DAG on nodes 0..nc-1 (preds of lower id, some pointing at
    inactive nodes, out of range or past npred), levels of its old part."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(-3, N + 5, (N, P)).astype(np.int32)  # junk slots
    npred = np.zeros(N, np.int32)
    for u in range(1, nc):
        k = int(rng.integers(1, P + 1))
        pred[u, :k] = rng.integers(max(0, u - 6), u, k)
        npred[u] = k
    return pred, npred


EDGE_CASES = ("inactive preds", "out of range", "npred past P",
              "node_count <= 0", "node_count past N", "nc_pre 0",
              "nc_pre past nc", "random nc_pre")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_replay_on_edge_graphs(case):
    """Preds that point at inactive nodes, out of range or past npred,
    npred > P, node counts outside 0..N, hints wrong on purpose: the outputs
    still equal the Jacobi sweeps'."""
    N, P = 64, 4
    W = 4
    rng = np.random.default_rng(EDGE_CASES.index(case))
    level = rng.integers(-2, 30, (W, N)).astype(np.int32)
    preds, npreds = zip(*(dag(w, N, P) for w in range(W)))
    pred, npred = np.stack(preds), np.stack(npreds)
    nc = np.array([50, 40, 64, 30], np.int32)
    nc_pre = nc - np.array([5, 0, 9, 12], np.int32)
    if case == "inactive preds":
        pred[:, 20, 0] = 55                       # past node_count
    elif case == "out of range":
        pred[:, 10:14, 0] = np.array([-5, N, N + 7, -1])
    elif case == "npred past P":
        npred[:, 5:25] = P + 3
    elif case == "node_count <= 0":
        nc[:2] = [0, -4]
    elif case == "node_count past N":
        nc[1:3] = N + 9
    elif case == "nc_pre 0":
        nc_pre[:] = 0
    elif case == "nc_pre past nc":
        nc_pre = nc + 7
    else:
        nc_pre = rng.integers(-5, N + 5, W).astype(np.int32)
    held(level, npred, pred, nc, nc_pre)


def test_long_new_chain_converges_in_one_sweep():
    """A chain of 12 new nodes (the JAX guess resolves 4) hung from an old
    node and joining the graph further on, on the old graph's own levels:
    the hint is right and one ordered sweep converges."""
    N, P = 96, 4
    pred, npred = dag(7, N, P, nc=60)
    old = torch.from_numpy
    lv0 = poa_topsort.topsort_torch(
        old(np.zeros((1, N), np.int32)), old(npred[None]), old(pred[None]),
        old(np.array([60], np.int32)))[0].numpy()
    a = 20                                         # the anchor
    b = next(v for v in range(a + 6, 60) if lv0[0, v] > lv0[0, a])
    for u in range(60, 72):
        pred[u, 0], npred[u] = (a if u == 60 else u - 1), 1
    pred[b, npred[b] - 1] = 71 if npred[b] == P else pred[b, npred[b] - 1]
    if npred[b] < P:
        pred[b, npred[b]] = 71
        npred[b] += 1
    ordered, jacobi = held(lv0, npred[None], pred[None],
                           np.array([72], np.int32),
                           np.array([60], np.int32))
    assert ordered[0] == 1 and jacobi[0] == 0


def test_cyclic_window_runs_jacobi_and_is_not_ok():
    """A cycle among the active nodes: no fixpoint, so the ordered sweeps
    fail and the window's levels are those of N + 2 Jacobi sweeps from its
    starting levels; ok is False, and the rank is the count's."""
    N, P = 48, 4
    pred, npred = dag(3, N, P, nc=40)
    pred[10, 0], npred[10] = 30, max(npred[10], 1)   # 30 reaches 10
    pred[30, 0], npred[30] = 29, max(npred[30], 1)
    for u in range(11, 30):
        pred[u, 0], npred[u] = u - 1, max(npred[u], 1)
    level = np.zeros((2, N), np.int32)
    pred2 = np.stack([pred, dag(4, N, P, nc=40)[0]])
    npred2 = np.stack([npred, dag(4, N, P, nc=40)[1]])
    nc = np.array([40, 40], np.int32)
    lv, _, _, ok, ordered, jacobi = replay(level, npred2, pred2, nc, nc)
    assert not ok[0] and ok[1]
    assert ordered[0] == ORDERED_SWEEPS and jacobi[0] == N + 2
    held(level, npred2, pred2, nc, nc)


@pytest.mark.parametrize("N, plan", [
    (256, ("warp-shared", 4)),       # the MSA shape
    (384, ("warp-shared", 4)),       # the correction shape
    (1_024, ("warp-shared", 4)),     # the deep shape
    (2_905, ("warp-shared", 4)),     # 4 x 4 (5 N + 2) <= 232,448
    (2_906, ("warp-shared", 2)),
    (5_810, ("warp-shared", 2)),
    (5_811, ("warp-shared", 1)),
    (11_622, ("warp-shared", 1)),
    (11_623, ("warp-device", 4)),    # the tables in device scratch
    (27_000, ("warp-device", 4)),    # cli poa of 9,000-base sequences
])
def test_topsort_plan(N, plan):
    assert poa_topsort.topsort_table_bytes(N) == 4 * (5 * N + 2)
    assert poa_topsort.topsort_plan(N) == plan
    variant, n = plan
    fits = n * poa_topsort.topsort_table_bytes(N) <= _build.SMEM_PER_BLOCK
    assert fits == (variant == "warp-shared")


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_card(monkeypatch):
    """B7 in both plans against the plain version on the card, on lockstep
    windows with the right hint and a wrong one, and on a cyclic window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    kw, banded, msa, blen, edits = SHAPES["deep"]
    bs = BatchSize(**kw)
    arrays = windows(6, blen, bs.max_sequences_per_poa, edits,
                     bs.padded_seq, seed=9)
    cases = topsort_calls(bs, banded, arrays, msa, monkeypatch)
    level, npred, pred, nc, _ = cases[-1]
    cases.append((level, npred, pred, nc, np.zeros_like(nc)))
    N, P = 48, 4
    cp, cn = dag(3, N, P, nc=40)
    cp[10, 0], cp[30, 0], cn[10], cn[30] = 30, 10, max(cn[10], 1), \
        max(cn[30], 1)
    c40 = np.array([40], np.int32)
    cases.append((np.zeros((1, N), np.int32), cn[None], cp[None], c40, c40))
    for args in cases:
        d = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args]
        want = poa_topsort.topsort_torch(*d)
        for limit in (None, 64):
            saved = _build.SMEM_PER_BLOCK
            if limit is not None:
                _build.SMEM_PER_BLOCK = limit
            try:
                got = poa_topsort.topsort(*d)
                torch.cuda.synchronize()
            finally:
                _build.SMEM_PER_BLOCK = saved
            for g, w in zip(got, want):
                assert torch.equal(g, w), limit
