"""Fold one traceback path per window into its POA graph (counterpart of
``_add_pallas`` in ``claragenomicsanalysis_tpu/ops/poa_pallas2.py``; spec
``poa_ops.add_alignment``).

The walk goes along the path from ``k0`` to its end, one step per entry,
and applies the canonical rules of ``poa_ops.add_alignment``:

- an inert entry (-2, or node and position both -1) and a deletion (node,
  no position) change nothing;
- a consumed base lands on the path's node when the bases agree, else on
  the first aligned candidate with that base, else on a new node at
  ``clip(node_count, 0, N - 1)``; a new node beside an existing one joins
  its aligned clique (members sorted ascending, the new id appended to
  each member's list);
- coverage grows by the base's weight; the edge from the previous consumed
  node gets ``min(w[prev_pos], w)``, added to an existing slot or inserted
  in ascending pred order;
- overflows set a sticky status, node over clique over edge, and their
  clipped writes still happen: the consensus then reads that state;
- where the state carries ``paths`` (the MSA is asked for), row
  ``clip(seq_idx, 0, S - 1)`` becomes this sequence's walk: -1 everywhere,
  then ``row[clip(pos, 0, L - 1)] = target`` per consumed base.

Only windows with ``act`` set change (a window without it keeps its
``paths`` row too).  The function is pure: it returns a new state and
leaves its input as it was.

- :func:`add_alignment` is the entry point (kernel ``csrc/poa_add.cu`` for
  CUDA tensors, counted in ``launch.poa_add``; the plain version
  for CPU tensors).
- :func:`add_alignment_torch` is the plain PyTorch version, vectorised over
  windows with a Python loop over path steps.
"""

import torch

from ..core.status import StatusType
from ..utils.profiling import kernel_span
from . import _build
from .poa_state import PoaState

_NODE_OVF = int(StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE)
_EDGE_OVF = int(StatusType.EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE)
_OK = int(StatusType.SUCCESS)
_BIG = 2**30
#: largest aligned-clique capacity A the kernel takes (it ranks A + 1
#: members in registers, two a lane)
MAX_ALIGNED = 63


def _check(state: PoaState, pn, pp, seq, weights, k0, act, seq_idx):
    W, N = state.base.shape
    L = seq.shape[1]
    if pn.shape != (W, N + L) or pp.shape != pn.shape \
            or weights.shape != seq.shape or seq.shape[0] != W \
            or k0.shape != (W,) or act.shape != (W,):
        raise ValueError("want pn/pp (W, N + L), seq/weights (W, L), "
                         "k0/act (W,)")
    if state.paths is not None and (
            seq_idx is None or state.paths.dim() != 3
            or state.paths.shape[0] != W or state.paths.shape[2] != L):
        raise ValueError("a state with paths wants paths (W, S, L) and a "
                         "seq_idx")
    tensors = state.tensors() + (pn, pp, seq, weights, k0)
    if any(t.dtype != torch.int32 for t in tensors) \
            or act.dtype != torch.bool:
        raise ValueError("add_alignment takes int32 tensors and a bool act")
    if len({t.device for t in tensors + (act,)}) != 1:
        raise ValueError("add_alignment's tensors must be on one device")
    if state.alig.shape[2] > MAX_ALIGNED:
        raise ValueError(f"max_aligned_per_node > {MAX_ALIGNED}")


def add_alignment_torch(state: PoaState, pn, pp, seq, weights, k0, act,
                        max_nodes: int, seq_idx: int | None = None
                        ) -> PoaState:
    """Plain PyTorch version of :func:`add_alignment`: the same output."""
    _check(state, pn, pp, seq, weights, k0, act, seq_idx)
    st = state.clone()
    (base, cov, npred, pred, predw, nsucc, nalig, alig, node_count, status,
     paths) = st
    W, N, P = pred.shape
    A = alig.shape[2]
    L = seq.shape[1]
    TL = N + L
    dev, i32 = seq.device, torch.int32
    arA = torch.arange(A, device=dev)
    arP = torch.arange(P, device=dev)
    prev = torch.full((W,), -1, dtype=i32, device=dev)
    prev_pos = torch.full((W,), -1, dtype=i32, device=dev)
    path_row = torch.full((W, L), -1, dtype=i32, device=dev)

    def at(arr, rows, idx, fill):
        """arr[rows, idx], ``fill`` where idx is outside [0, arr.shape[1])."""
        ok = (idx >= 0) & (idx < arr.shape[1])
        return torch.where(ok, arr[rows, idx.clamp(0, arr.shape[1] - 1)
                                   .long()], fill)

    steps = int((TL - k0[act]).max()) if bool(act.any()) else 0
    for t in range(steps):
        ix = k0 + t
        g = (act & (ix < TL)).nonzero()[:, 0]
        if g.numel() == 0:
            break
        ixg = ix[g].long()
        node, pos = pn[g, ixg], pp[g, ixg]
        inert = (node == -2) | ((node == -1) & (pos == -1))
        is_del = (node >= 0) & (pos == -1)
        consume = ~inert & ~is_del
        b = at(seq, g, pos, -1)
        w = at(weights, g, pos, 0)

        # choose or create the target node
        node_c = node.clamp(0, N - 1).long()
        same = (base[g, node_c] == b) & (b >= 0) & (node >= 0)
        cands = alig[g, node_c]                                  # (n, A)
        nal = nalig[g, node_c]
        cand_ok = (arA[None, :] < nal[:, None]) & (b >= 0)[:, None]
        cb = at(base, g[:, None], cands, -2)
        cand_match = cand_ok & (cb == b[:, None])
        any_cand = cand_match.any(1)
        cand_sel = cands.gather(1, cand_match.to(i32).argmax(1)[:, None])[:, 0]
        need_new = consume & ~((node >= 0) & (same | any_cand))
        nc = node_count[g]
        new_id = nc.clamp(0, N - 1)
        nid = new_id.long()
        overflow_node = need_new & (nc >= max_nodes)
        target = torch.where(~consume, -1, torch.where(
            (node >= 0) & same, node,
            torch.where((node >= 0) & any_cand, cand_sel, new_id)))
        tc = target.clamp(0, N - 1).long()

        base[g[need_new], nid[need_new]] = b[need_new]
        # a new node beside an existing one joins its aligned clique
        link = need_new & (node >= 0)
        group_sz = nal + 1
        overflow_clique = link & (group_sz > A)
        members = torch.cat([node_c[:, None].to(i32),
                             torch.where(arA[None, :] < nal[:, None], cands,
                                         -1)], 1)                # (n, A+1)
        srt = torch.where(members >= 0, members, _BIG).sort(1).values[:, :A]
        new_alig = torch.where(srt >= _BIG, -1, srt).to(i32)
        gl = g[link]
        alig[gl, nid[link]] = new_alig[link]
        nalig[gl, nid[link]] = torch.clamp(group_sz[link], max=A)
        mc = members.clamp(0, N - 1).long()
        cur = nalig[g[:, None], mc]                              # after set
        mdo = link[:, None] & (members >= 0) & (cur < A)
        rows = g[:, None].expand_as(mc)[mdo]
        alig[rows, mc[mdo], cur.clamp(0, A - 1)[mdo].long()] = \
            new_id[:, None].expand_as(mc)[mdo]
        nalig.index_put_((rows, mc[mdo]),
                         torch.ones_like(rows, dtype=i32), accumulate=True)

        cov[g[consume], tc[consume]] += w[consume]
        node_count[g] = nc + (need_new & ~overflow_node).to(i32)

        # the edge prev -> target
        ew = torch.minimum(at(weights, g, prev_pos[g], 0), w)
        pv = prev[g]
        has_edge_from = (pv >= 0) & consume
        prev_c = pv.clamp(0, N - 1)
        plist = pred[g, tc]                                      # (n, P)
        np_t = npred[g, tc]
        slot_ok = arP[None, :] < np_t[:, None]
        exist = slot_ok & (plist == prev_c[:, None])
        any_exist = exist.any(1) & has_edge_from
        ex_slot = exist.to(i32).argmax(1)
        ge = any_exist
        predw[g[ge], tc[ge], ex_slot[ge]] += ew[ge]
        ins = has_edge_from & ~any_exist
        overflow_edge = ins & (np_t >= P)
        pos_ins = (slot_ok & (plist < prev_c[:, None])).sum(1)
        old_w = predw[g, tc]
        shift_p = torch.cat([torch.full_like(plist[:, :1], -1),
                             plist[:, :-1]], 1)
        shift_w = torch.cat([torch.zeros_like(old_w[:, :1]), old_w[:, :-1]], 1)
        before = arP[None, :] < pos_ins[:, None]
        here = arP[None, :] == pos_ins[:, None]
        new_p = torch.where(before, plist,
                            torch.where(here, prev_c[:, None], shift_p))
        new_w = torch.where(before, old_w,
                            torch.where(here, ew[:, None], shift_w))
        do = ins & ~overflow_edge
        pred[g[do], tc[do]] = new_p[do]
        predw[g[do], tc[do]] = new_w[do]
        npred[g[do], tc[do]] = np_t[do] + 1
        nsucc[g[do], prev_c[do].long()] += 1

        s = status[g]
        for ovf, code in ((overflow_node, _NODE_OVF),
                          (overflow_clique, _NODE_OVF),
                          (overflow_edge, _EDGE_OVF)):
            s = torch.where((s == _OK) & ovf, code, s)
        status[g] = s
        path_row[g[consume], pos.clamp(0, L - 1)[consume].long()] = \
            target[consume].to(i32)
        prev[g] = torch.where(consume, target, pv).to(i32)
        prev_pos[g] = torch.where(consume, pos, prev_pos[g])
    if paths is not None:
        s_row = min(max(seq_idx, 0), paths.shape[1] - 1)
        paths[:, s_row] = torch.where(act[:, None], path_row, paths[:, s_row])
    return st


def add_alignment(state: PoaState, pn, pp, seq, weights, k0, act,
                  max_nodes: int, seq_idx: int | None = None) -> PoaState:
    """The graph of every window with ``act`` set, with the path
    ``pn[k0:], pp[k0:]`` of ``seq`` (weights ``weights``) folded in.

    Args:
      state: the graphs (ops.poa_state.PoaState), left unchanged.
      pn, pp: (W, N + L) int32 path from graph_nw_traceback; k0 (W,) int32.
      seq, weights: (W, L) int32.
      act: (W,) bool, the windows to change.
      max_nodes: BatchSize.max_nodes_per_window.
      seq_idx: which sequence of the window this is, the ``paths`` row it
        writes; needed only when the state carries ``paths``.

    Returns:
      the new PoaState.
    """
    if seq.device.type == "cpu":
        return add_alignment_torch(state, pn, pp, seq, weights, k0, act,
                                   max_nodes, seq_idx)
    _check(state, pn, pp, seq, weights, k0, act, seq_idx)
    if seq.device.type != "cuda":
        raise ValueError(f"no kernel for device {seq.device}")
    pn, pp, seq, weights, k0 = (t.contiguous()
                                for t in (pn, pp, seq, weights, k0))
    out = state.clone()
    W, N, P = out.pred.shape
    A, L = out.alig.shape[2], seq.shape[1]
    if W == 0:
        return out
    # the kernel writes this sequence's row of paths, or none (S = 0)
    S, s_row = 0, 0
    if out.paths is not None:
        S = out.paths.shape[1]
        s_row = min(max(seq_idx, 0), S - 1)
    act_i = act.to(torch.int32)
    lib = _build.load()
    with torch.cuda.device(seq.device), kernel_span(
            "poa_add", (state, pn, pp, seq, weights, k0, act, max_nodes,
                        seq_idx), W * (N + L)):
        err = lib.cga_poa_add(
            pn.data_ptr(), pp.data_ptr(), seq.data_ptr(), weights.data_ptr(),
            k0.data_ptr(), act_i.data_ptr(),
            *(t.data_ptr() for t in out[:10]),
            out.paths.data_ptr() if S else None,
            W, N, P, A, L, S, s_row, max_nodes,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_add")
    return out
