"""The port's POA operations (claragenomicsanalysis_tpu_torch.ops.poa_*)
against the JAX package's ``poa_ops``, applied per window through
``jax.vmap``, on the same evolved graph states carried across by
``ops.convert``.  Integer DP: every comparison is exact.

Three shapes: a small batch, the same with the static band, and the tight
caps under which node, clique and edge overflows all hit.  Each batch also
holds an empty window, a window whose first sequence is empty, N bases
inside sequences, a first sequence longer than ``max_nodes_per_window`` and
a 2-base graph against a 60-base sequence (banded: cells that are sums on
NEG).  The MSA is compared on the windows of status SUCCESS whose graph
leaves node N - 1 unused: ``poa_ops``' drop-mode scatters wrap an id of -1
onto that node, which the port (as the TPU kernel) does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core.config import BatchSize as JaxBatchSize
from claragenomicsanalysis_tpu.core.config import PoaScores as JaxPoaScores
from claragenomicsanalysis_tpu.core.status import StatusType
from claragenomicsanalysis_tpu.ops import poa_ops
from claragenomicsanalysis_tpu.ops.poa_pallas2 import _msa_pallas
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.core.config import BatchSize, PoaScores
from claragenomicsanalysis_tpu_torch.ops import (poa_add, poa_consensus,
                                                 poa_msa, poa_nwtb, poa_state,
                                                 poa_topsort)
from claragenomicsanalysis_tpu_torch.ops.convert import (
    poa_state_from_reference, poa_state_to_reference)

#: name -> (BatchSize keyword arguments, banded, edits per sequence)
SHAPES = {
    "small": (dict(max_sequence_size=48, max_sequences_per_poa=4,
                   max_pred_per_node=4, max_aligned_per_node=4,
                   max_nodes_per_window=96), False, 4),
    "banded": (dict(max_sequence_size=48, max_sequences_per_poa=4,
                    max_pred_per_node=4, max_aligned_per_node=4,
                    max_nodes_per_window=96, band_width=16), True, 6),
    "overflow": (dict(max_sequence_size=32, max_sequences_per_poa=6,
                      max_pred_per_node=2, max_aligned_per_node=2,
                      max_nodes_per_window=40), False, 8),
}
SC = PoaScores()


def edge_batch(bs: JaxBatchSize, n_mut: int, seed: int):
    """(seqs, weights (W, S, L), lens (W, S), n_seqs (W,)) int32: seeded
    windows (weights 1-3), one of them with N bases, one with a 2-base
    first and a 60-base second sequence, one with two sequences, an empty
    window, one whose first sequence is empty and one whose first sequence
    overflows max_nodes_per_window."""
    rng = np.random.default_rng(seed)
    S, L = bs.max_sequences_per_poa, bs.padded_seq
    W = 8
    seqs = np.full((W, S, L), -1, np.int32)
    weights = np.zeros((W, S, L), np.int32)
    lens = np.zeros((W, S), np.int32)
    n_seqs = np.full(W, S, np.int32)

    def put(wi, si, s):
        seqs[wi, si, :len(s)] = encode(s)
        weights[wi, si, :len(s)] = rng.integers(1, 4, size=len(s))
        lens[wi, si] = len(s)

    base_len = bs.max_sequence_size - 8
    for wi in range(W):
        base = generate_random_genome(base_len, rng)
        for si in range(S):
            s = mutate_sequence(base, n_mut, rng)[:bs.max_sequence_size]
            if wi == 1 and si in (1, 2):
                s = s[:10] + "NN" + s[12:]
            if wi == 6 and si == 0:
                s = ""
            put(wi, si, s)
    n_seqs[3] = 2
    n_seqs[5] = 0
    lens[5] = 0
    seqs[5] = -1
    long_first = generate_random_genome(bs.max_nodes_per_window + 4, rng)
    put(7, 0, long_first)
    # a 2-node graph against 60 bases: with a band, row 2's band lies wholly
    # right of row 1's, so its cells are sums on NEG
    put(4, 0, generate_random_genome(2, rng))
    put(4, 1, generate_random_genome(60, rng))
    return seqs, weights, lens, n_seqs


@functools.lru_cache(maxsize=None)
def jax_step(name: str):
    kw, banded, _ = SHAPES[name]
    bs, sc = JaxBatchSize(**kw), JaxPoaScores()
    N, TL = bs.padded_nodes, bs.padded_nodes + bs.padded_seq
    bw = bs.band_width if banded else 0

    def step(state, level, seq, w, slen, s_idx):
        new_level, order, rank, ok = poa_ops.topsort(state, level, N + 2)
        smat = poa_ops.graph_nw(state, order, rank, seq, slen, sc,
                                band_width=bw)
        pn, pp, k0, band_ok = poa_ops.nw_traceback(state, order, rank, smat,
                                                   seq, slen, sc, TL)
        added = poa_ops.add_alignment(state, pn, pp, seq, w, s_idx, bs,
                                      path_start=k0)
        return new_level, order, rank, ok, pn, pp, k0, band_ok, added, smat

    return jax.jit(jax.vmap(step, in_axes=(0, 0, 0, 0, 0, None)))


@functools.lru_cache(maxsize=None)
def trajectory(name: str):
    """The JAX pipeline of models/poa._graph_scan on edge_batch, step by
    step: each step's input state and its outputs, then the final topsort
    and consensus."""
    kw, _, n_mut = SHAPES[name]
    bs = JaxBatchSize(**kw)
    N, S, MC = bs.padded_nodes, bs.max_sequences_per_poa, bs.max_consensus_size
    seqs, weights, lens, n_seqs = edge_batch(bs, n_mut, seed=len(name))
    state = jax.vmap(lambda a, b, c: poa_ops.init_state(bs, a, b, c))(
        seqs[:, 0], weights[:, 0], lens[:, 0])
    state = jax.tree_util.tree_map(np.asarray, state)
    level = np.where(np.arange(N)[None] < lens[:, :1], np.arange(N)[None],
                     0).astype(np.int32)
    steps = []
    for s in range(1, S):
        alive = (s < n_seqs) & (state.status == StatusType.SUCCESS)
        out = jax_step(name)(state, level, seqs[:, s], weights[:, s],
                             lens[:, s], jnp.int32(s))
        nl, order, rank, ok, pn, pp, k0, band_ok = map(np.asarray, out[:8])
        added = jax.tree_util.tree_map(np.asarray, out[8])
        steps.append(dict(state=state, level=level, s=s, alive=alive,
                          topsort=(nl, order, rank, ok),
                          nwtb=(pn, pp, k0, band_ok), added=added,
                          smat=np.asarray(out[9])))
        # the status and gating rules of _graph_scan
        new = added._replace(status=np.where(
            ok, added.status,
            int(StatusType.LOOP_COUNT_EXCEEDED_UPPER_BOUND)).astype(np.int32))
        failed = state._replace(status=np.full_like(
            state.status, StatusType.EXCEEDED_BAND_WIDTH))

        def pick(mask, a, b):
            return np.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        new = jax.tree_util.tree_map(functools.partial(pick, band_ok), new,
                                     failed)
        state = jax.tree_util.tree_map(functools.partial(pick, alive), new,
                                       state)
        level = np.where(alive[:, None], nl, level).astype(np.int32)
    fin = jax.jit(jax.vmap(lambda st, lv: poa_ops.topsort(st, lv, N + 2)))(
        state, level)
    cons = jax.jit(jax.vmap(lambda st, r: poa_ops.consensus(st, None, r, MC)))(
        state, fin[2])

    def msa(st, order, rank):
        col, n_cols = poa_ops.msa_columns(st, order, rank)
        return poa_ops.msa_rows(st, col, n_cols, N), n_cols
    rows = jax.jit(jax.vmap(msa))(state, fin[1], fin[2])
    return dict(bs=bs, arrays=(seqs, weights, lens, n_seqs), steps=steps,
                state=state, level=level,
                final_topsort=tuple(map(np.asarray, fin)),
                consensus=tuple(map(np.asarray, cons)),
                msa=tuple(map(np.asarray, rows)))


def port_bs(name: str) -> BatchSize:
    return BatchSize(**SHAPES[name][0])


def t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def eq(got, want, msg=""):
    np.testing.assert_array_equal(got.cpu().numpy() if torch.is_tensor(got)
                                  else got, np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("name", list(SHAPES))
def test_overflow_and_band_statuses_are_exercised(name):
    """The batches reach the statuses the kernels must reproduce."""
    tr = trajectory(name)
    final = set(tr["state"].status.tolist())
    assert StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE in final
    assert StatusType.EXCEEDED_BAND_WIDTH in final      # empty first sequence
    assert StatusType.SUCCESS in final
    if name == "overflow":
        assert StatusType.EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE in final


@pytest.mark.parametrize("name", list(SHAPES))
def test_init_state_matches_poa_ops(name):
    tr = trajectory(name)
    seqs, weights, lens, _ = tr["arrays"]
    st = poa_state.init_state(port_bs(name), t(seqs[:, 0]), t(weights[:, 0]),
                              t(lens[:, 0]), msa=True)
    want = tr["steps"][0]["state"]
    got = poa_state_to_reference(st)
    assert set(got) == set(want._fields)
    for field, g in got.items():
        eq(g, getattr(want, field), field)
    # a consensus-only state carries no paths, and nothing else differs
    lean = poa_state.init_state(port_bs(name), t(seqs[:, 0]),
                                t(weights[:, 0]), t(lens[:, 0]))
    assert lean.paths is None
    assert set(poa_state_to_reference(lean)) == set(want._fields) - {"paths"}
    eq(poa_state.init_level(port_bs(name).padded_nodes, t(lens[:, 0])),
       tr["steps"][0]["level"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_topsort_matches_poa_ops(name):
    tr = trajectory(name)
    cases = [(st["state"], st["level"], st["topsort"]) for st in tr["steps"]]
    cases.append((tr["state"], tr["level"], tr["final_topsort"]))
    for i, (state, level, want) in enumerate(cases):
        ps = poa_state_from_reference(state)
        got = poa_topsort.topsort(t(level), ps.npred, ps.pred, ps.node_count)
        for g, w, n in zip(got, want, ("level", "order", "rank", "ok")):
            eq(g, w, f"step {i}: {n}")


@pytest.mark.parametrize("name", list(SHAPES))
def test_graph_nw_traceback_matches_poa_ops(name):
    """On live windows the path, its start and band_ok equal poa_ops'; a
    window that is not alive or fails the band gets the inert path."""
    tr = trajectory(name)
    seqs, _, lens, _ = tr["arrays"]
    banded = SHAPES[name][1]
    bw = port_bs(name).band_width if banded else 0
    TL = port_bs(name).padded_nodes + port_bs(name).padded_seq
    n_walked = 0
    for st in tr["steps"]:
        s, alive = st["s"], st["alive"]
        _, order, rank, _ = st["topsort"]
        ps = poa_state_from_reference(st["state"])
        pn, pp, k0, band_ok = poa_nwtb.graph_nw_traceback(
            t(seqs[:, s]), t(order), t(rank), ps.npred, ps.base, ps.nsucc,
            ps.pred, t(lens[:, s]), ps.node_count, t(alive), SC, bw)
        wpn, wpp, wk0, wok = st["nwtb"]
        eq(band_ok, alive & wok, f"seq {s}: band_ok")
        walk = alive & wok
        n_walked += int(walk.sum())
        eq(pn[walk], wpn[walk], f"seq {s}: pn")
        eq(pp[walk], wpp[walk], f"seq {s}: pp")
        eq(k0[walk], wk0[walk], f"seq {s}: k0")
        assert (pn[~walk] == -2).all() and (pp[~walk] == -2).all()
        assert (k0[~walk] == TL).all()
    assert n_walked > 0


@pytest.mark.parametrize("name", list(SHAPES))
def test_score_plane_matches_poa_ops(name):
    """C5: the plain version's score plane equals poa_ops.graph_nw's cell
    for cell on live windows; in banded windows that includes cells derived
    from NEG by plain int32 sums (a saturating sentinel would differ)."""
    tr = trajectory(name)
    seqs, _, lens, _ = tr["arrays"]
    bw = port_bs(name).band_width if SHAPES[name][1] else 0
    neg_derived = 0
    for st in tr["steps"]:
        s, alive = st["s"], st["alive"]
        _, order, rank, _ = st["topsort"]
        ps = poa_state_from_reference(st["state"])
        plane = poa_nwtb.score_plane_torch(
            t(seqs[:, s]), t(order), t(rank), ps.npred, ps.base, ps.pred,
            t(lens[:, s]), ps.node_count, t(alive), SC, bw).numpy()
        eq(plane[alive], st["smat"][alive], f"seq {s}: plane")
        live = plane[alive]
        neg_derived += int(((live < poa_state.NEG // 2)
                            & (live != poa_state.NEG)).sum())
    assert (neg_derived > 0) == bool(bw)


@pytest.mark.parametrize("name", list(SHAPES))
def test_add_alignment_matches_poa_ops(name):
    """Every field of the state poa_ops.add_alignment returns (overflowed
    windows and their clipped writes included, and ``paths`` with this
    sequence's row) on the windows the add touches; the others stay as
    they were, their ``paths`` row too.  Without ``paths`` in the state the
    other fields come out the same."""
    tr = trajectory(name)
    seqs, weights, _, _ = tr["arrays"]
    bs = port_bs(name)
    for st in tr["steps"]:
        s = st["s"]
        pn, pp, k0, band_ok = st["nwtb"]
        act = st["alive"] & band_ok
        before = poa_state_from_reference(st["state"])
        args = (t(pn), t(pp), t(seqs[:, s]), t(weights[:, s]), t(k0), t(act),
                bs.max_nodes_per_window)
        got = poa_state_to_reference(poa_add.add_alignment(before, *args, s))
        keep = poa_state_to_reference(before)
        assert set(got) == set(st["added"]._fields)
        for field, g in got.items():
            eq(g[act], getattr(st["added"], field)[act], f"seq {s}: {field}")
            eq(g[~act], keep[field][~act], f"seq {s}: {field} (untouched)")
        eq(keep["paths"], st["state"].paths, "the input state is left alone")
        lean = poa_add.add_alignment(before._replace(paths=None), *args)
        assert lean.paths is None
        for field, g in poa_state_to_reference(lean).items():
            eq(g, got[field], f"seq {s}: {field} without paths")
    with pytest.raises(ValueError, match="seq_idx"):
        poa_add.add_alignment(before, *args)


@pytest.mark.parametrize("name", list(SHAPES))
def test_consensus_matches_poa_ops(name):
    tr = trajectory(name)
    ps = poa_state_from_reference(tr["state"])
    got = poa_consensus.consensus(ps.npred, ps.pred, ps.predw, ps.base,
                                  ps.cov, t(tr["final_topsort"][2]),
                                  ps.node_count,
                                  port_bs(name).max_consensus_size)
    for g, w, n in zip(got, tr["consensus"], ("codes", "covs", "length")):
        eq(g, w, n)


def comparable_msa_windows(tr) -> np.ndarray:
    """Windows of status SUCCESS whose graph leaves node N - 1 unused."""
    state = tr["state"]
    return (state.status == StatusType.SUCCESS) & (
        state.node_count < tr["bs"].padded_nodes)


@pytest.mark.parametrize("name", list(SHAPES))
def test_msa_matches_poa_ops(name):
    """rows and n_cols equal vmapped msa_columns + msa_rows(max_cols=N) on
    the final states; every other window's values stay inside their
    ranges."""
    tr = trajectory(name)
    N = tr["bs"].padded_nodes
    ps = poa_state_from_reference(tr["state"])
    rows, n_cols = poa_msa.msa(ps, t(tr["final_topsort"][1]))
    want_rows, want_cols = tr["msa"]
    ok = comparable_msa_windows(tr)
    assert ok.sum() >= 2 and (~ok).sum() >= 2
    eq(n_cols[ok], want_cols[ok], "n_cols")
    eq(rows[ok], want_rows[ok], "rows")
    assert rows.shape == want_rows.shape and rows.dtype == torch.int32
    assert int(rows.min()) >= -1 and int(rows.max()) <= 3
    assert int(n_cols.min()) >= 0 and int(n_cols.max()) <= N
    # a row, its gaps removed, is its sequence wherever the columns grow
    # along the sequence's path (a clique can get its column before a pred
    # of one member has one, and then two positions share a column: the
    # reference's rule, kept); an N base holds -1 like a gap
    col, _ = poa_msa.msa_columns_torch(ps, t(tr["final_topsort"][1]))
    seqs, _, lens, n_seqs = tr["arrays"]
    n_rows = n_whole = 0
    for w in np.flatnonzero(ok):
        for si in range(int(n_seqs[w])):
            path = tr["state"].paths[w, si, :lens[w, si]]
            n_rows += 1
            if (np.diff(col[w].numpy()[path]) <= 0).any():
                continue
            n_whole += 1
            row = rows[w, si, :int(n_cols[w])].numpy()
            want = seqs[w, si, :lens[w, si]]
            eq(row[row >= 0], want[want >= 0], f"window {w} sequence {si}")
    assert n_whole >= n_rows // 2 > 0
    with pytest.raises(ValueError, match="paths"):
        poa_msa.msa(ps._replace(paths=None), t(tr["final_topsort"][1]))


def test_msa_matches_the_pallas_kernel_interpreted():
    """The function of the TPU kernel itself, run in interpret mode, on the
    small shape: rows and n_cols equal on every window (neither wraps an
    out-of-range id)."""
    tr = trajectory("small")
    state = jax.tree_util.tree_map(jnp.asarray, tr["state"])
    want_rows, want_cols = _msa_pallas(tr["bs"], True, state,
                                       jnp.asarray(tr["final_topsort"][1]))
    ps = poa_state_from_reference(tr["state"])
    rows, n_cols = poa_msa.msa(ps, t(tr["final_topsort"][1]))
    eq(n_cols, np.asarray(want_cols), "n_cols")
    eq(rows, np.asarray(want_rows), "rows")


def test_state_round_trip_and_checks():
    tr = trajectory("small")
    ps = poa_state_from_reference(tr["state"])
    back = poa_state_to_reference(ps)
    assert set(back) == set(poa_state.PoaState._fields)
    for field, a in back.items():
        eq(a, getattr(tr["state"], field), field)
    bad = tr["state"]._replace(base=tr["state"].base.astype(np.int64))
    with pytest.raises(ValueError, match="int32"):
        poa_state_from_reference(bad)
    with pytest.raises(ValueError):
        poa_topsort.topsort(ps.base, ps.npred, ps.pred[:1], ps.node_count)


def test_state_without_paths_round_trips():
    """A consensus-only state (paths None) crosses both ways without the
    field; a reference object without paths converts too."""
    tr = trajectory("small")
    lean = poa_state_from_reference(tr["state"]._replace(paths=None))
    assert lean.paths is None and len(lean.tensors()) == 10
    back = poa_state_to_reference(lean)
    assert set(back) == set(poa_state.PoaState._fields) - {"paths"}
    for field, a in back.items():
        eq(a, getattr(tr["state"], field), field)
    assert lean.clone().paths is None
    full = poa_state_from_reference(tr["state"])
    copy = full.clone()
    assert copy.paths.data_ptr() != full.paths.data_ptr()
    eq(copy.paths, tr["state"].paths)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernels_match_plain_versions_on_card(name, cuda_device):
    """B7, B5, B6 (with and without ``paths``), B8 and B9 against their
    plain versions on the card, on every evolved state of the trajectory,
    arrays equal."""
    tr = trajectory(name)
    seqs, weights, lens, _ = tr["arrays"]
    bs = port_bs(name)
    bw = bs.band_width if SHAPES[name][1] else 0
    d = cuda_device
    for st in tr["steps"]:
        s = st["s"]
        ps = poa_state_from_reference(st["state"], device=d)
        lv = t(st["level"], d)
        k = poa_topsort.topsort(lv, ps.npred, ps.pred, ps.node_count)
        p = poa_topsort.topsort_torch(lv, ps.npred, ps.pred, ps.node_count)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        _, order, rank, _ = k
        args = (t(seqs[:, s], d), order, rank, ps.npred, ps.base, ps.nsucc,
                ps.pred, t(lens[:, s], d), ps.node_count, t(st["alive"], d),
                SC, bw)
        k = poa_nwtb.graph_nw_traceback(*args)
        p = poa_nwtb.graph_nw_traceback_torch(*args)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        pn, pp, k0, band_ok = k
        args = (ps, pn, pp, t(seqs[:, s], d), t(weights[:, s], d), k0,
                t(st["alive"], d) & band_ok, bs.max_nodes_per_window, s)
        for a, b in zip(poa_add.add_alignment(*args),
                        poa_add.add_alignment_torch(*args)):
            assert torch.equal(a, b)
        lean = (ps._replace(paths=None),) + args[1:-1]
        for a, b in zip(poa_add.add_alignment(*lean).tensors(),
                        poa_add.add_alignment_torch(*lean).tensors()):
            assert torch.equal(a, b)
    ps = poa_state_from_reference(tr["state"], device=d)
    args = (ps.npred, ps.pred, ps.predw, ps.base, ps.cov,
            t(tr["final_topsort"][2], d), ps.node_count,
            bs.max_consensus_size)
    for a, b in zip(poa_consensus.consensus(*args),
                    poa_consensus.consensus_torch(*args)):
        assert torch.equal(a, b)
    order = t(tr["final_topsort"][1], d)
    for a, b in zip(poa_msa.msa(ps, order), poa_msa.msa_torch(ps, order)):
        assert torch.equal(a, b)
