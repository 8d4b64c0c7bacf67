"""Multiple sequence alignment of each window's POA graph (counterpart of
``_msa_pallas`` in ``claragenomicsanalysis_tpu/ops/poa_pallas2.py``; spec
``poa_ops.msa_columns`` then ``poa_ops.msa_rows(max_cols=N)``).

Columns: the nodes are visited in topological order (``order[r]`` for
``r < node_count``).  A node that has no column yet gets one together with
its aligned clique (the ``nalig[u]`` members of ``alig[u]``):
``c = 1 + max`` over the columns of every filled pred slot of every member
(-1 where there is none), written to every member whose id lies in
``[0, N)``.  ``n_cols`` is ``1 + max`` column over the active nodes.

Rows: sequence s puts ``base[paths[s, j]]`` into column
``col[paths[s, j]]`` for every position j whose path entry is ``>= 0`` and
whose column lies in ``[0, N)``; every other entry of a row is -1, a gap.

Out-of-range ids, which only an overflowed window's clipped writes can
leave, read as "no node" and are never written, as in the TPU kernel; and
where two positions of one sequence land on one column (again only in an
overflowed window) the later position wins, in the kernel and in the plain
version alike, so the two agree on every window.  ``poa_ops`` itself wraps
an id of -1 to node ``N - 1`` in its drop-mode scatters, so on a window
whose graph fills all ``N`` slots its column of that node can differ; the
tests compare with it on windows of status SUCCESS, the only ones whose
rows ``Batch.get_msa`` shows.

- :func:`msa` is the entry point (kernel ``csrc/poa_msa.cu`` for CUDA
  tensors, counted in ``launch.poa_msa``; the plain version for CPU tensors).
- :func:`msa_torch` is the plain PyTorch version, vectorised over windows
  with Python loops over ranks and over sequence positions.
- :func:`msa_plan` chooses where the kernel keeps a window's tables.
"""

import torch

from ..utils.profiling import kernel_span
from . import _build
from .poa_state import PoaState, padget_cols

#: windows a block of the kernel (one a warp) where the tables fit
MSA_WINDOWS = 4
#: plan -> the launcher's code for it
_PLAN_CODES = {"warp-shared": 0, "warp-cols-shared": 1, "warp-device": 2}


def msa_gather_ranks(P: int, A: int) -> int:
    """Ranks one gather lists, a lane each (``csrc/poa_msa.cuh``
    msa_gather_ranks): 32, or as many as 8,192 int32 hold at (A + 1)
    (P + 1) a rank, its members and their pred slots (at least one)."""
    return min(32, max(1, 8192 // ((A + 1) * (P + 1))))


def msa_list_ints(P: int, A: int) -> int:
    """int32 of a window's rank lists: :func:`msa_gather_ranks` ranks of
    (A + 1) (P + 1) each."""
    return msa_gather_ranks(P, A) * (A + 1) * (P + 1)


def msa_table_bytes(N: int, P: int, A: int) -> int:
    """The tables the kernel keeps a window: the columns (N int32) and the
    rank lists (:func:`msa_list_ints`)."""
    return 4 * (N + msa_list_ints(P, A))


def msa_plan(W: int, N: int, P: int, A: int, S: int, L: int) -> tuple:
    """-> (variant, windows a block) of a launch of W windows of N nodes, P
    pred slots, A aligned slots and S sequences of L positions: a warp a
    window, ``"warp-shared"`` with the most windows (MSA_WINDOWS, 2 or 1)
    whose :func:`msa_table_bytes` fit a block (``_build.SMEM_PER_BLOCK``);
    else ``"warp-cols-shared"`` (one a block) where the columns alone fit,
    the rank lists in a device scratch slice, so that every window whose
    columns the first design held in shared memory keeps them there (C10:
    4N bytes, N <= 58,112); else ``"warp-device"`` (MSA_WINDOWS a block,
    both in the scratch slice).  W, S and L enter no table: the rows and
    paths are read and written where they lie."""
    for n in (MSA_WINDOWS, 2, 1):
        if n * msa_table_bytes(N, P, A) <= _build.SMEM_PER_BLOCK:
            return "warp-shared", n
    if 4 * N <= _build.SMEM_PER_BLOCK:
        return "warp-cols-shared", 1
    return "warp-device", MSA_WINDOWS


def msa_scratch_ints(variant: str, N: int, P: int, A: int) -> int:
    """int32 of device scratch the kernel takes a window in ``variant``:
    none, the rank lists, or the columns and the lists."""
    return {"warp-shared": 0, "warp-cols-shared": msa_list_ints(P, A),
            "warp-device": N + msa_list_ints(P, A)}[variant]


def _check(state: PoaState, order):
    W, N = state.base.shape
    if state.paths is None:
        raise ValueError("msa needs a state that carries paths")
    if order.shape != (W, N) or state.paths.dim() != 3 \
            or state.paths.shape[0] != W:
        raise ValueError("want order (W, N) and paths (W, S, L)")
    tensors = state.tensors() + (order,)
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError("msa takes int32 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("msa's tensors must be on one device")


def msa_columns_torch(state: PoaState, order):
    """(col (W, N) int32, n_cols (W,) int32): the column of every node (-1
    where it has none) and the count of columns."""
    W, N, P = state.pred.shape
    A = state.alig.shape[2]
    dev, i32 = order.device, torch.int32
    wi = torch.arange(W, device=dev)
    arA = torch.arange(A, device=dev)
    arP = torch.arange(P, device=dev)
    nc = state.node_count
    col = torch.full((W, N), -1, dtype=i32, device=dev)
    n_rows = min(N, max(int(nc.max()), 0)) if W else 0
    for r in range(n_rows):
        u = order[:, r].clamp(0, N - 1).long()
        do = (r < nc) & (col[wi, u] < 0)
        group = torch.cat([u[:, None].to(i32), state.alig[wi, u]], 1)
        gok = torch.cat([torch.ones((W, 1), dtype=torch.bool, device=dev),
                         arA[None, :] < state.nalig[wi, u][:, None]], 1)
        in_rng = (group >= 0) & (group < N)
        gc = group.clamp(0, N - 1).long()
        gp = torch.where(in_rng[:, :, None], state.pred[wi[:, None], gc], -1)
        gnp = torch.where(in_rng, state.npred[wi[:, None], gc], 0)
        pok = (arP[None, None, :] < gnp[:, :, None]) & gok[:, :, None]
        pcols = torch.where(
            pok, padget_cols(col, gp.reshape(W, -1), -1).reshape(gp.shape),
            -1)
        c = (pcols.reshape(W, -1).max(1).values + 1).to(i32)
        put = gok & do[:, None] & in_rng
        col[wi[:, None].expand_as(gc)[put], gc[put]] = \
            c[:, None].expand_as(gc)[put]
    active = torch.arange(N, device=dev)[None, :] < nc[:, None]
    n_cols = torch.where(active, col, -1).max(1).values + 1 if N else \
        torch.zeros(W, dtype=i32, device=dev)
    return col, n_cols.to(i32)


def msa_torch(state: PoaState, order):
    """Plain PyTorch version of :func:`msa`: the same outputs."""
    _check(state, order)
    W, N = state.base.shape
    S, L = state.paths.shape[1:]
    dev, i32 = order.device, torch.int32
    col, n_cols = msa_columns_torch(state, order)
    rows = torch.full((W, S, N), -1, dtype=i32, device=dev)
    ws = torch.arange(W, device=dev)[:, None].expand(W, S)
    ss = torch.arange(S, device=dev)[None, :].expand(W, S)
    for j in range(L):               # in position order: the later one wins
        p = state.paths[:, :, j]
        c = padget_cols(col, p, -1)
        put = (p >= 0) & (c >= 0) & (c < N)
        rows[ws[put], ss[put], c[put].long()] = padget_cols(state.base, p,
                                                            -1)[put]
    return rows, n_cols


def msa(state: PoaState, order):
    """The gapped rows of every window's sequences.

    Args:
      state: the final graphs with their ``paths`` (W, S, L).
      order: (W, N) int32, the final topological order
        (:func:`..poa_topsort.topsort`).

    Returns:
      rows (W, S, N) int32, base codes with -1 for a gap (a code of -1 is
      also what an N base holds); n_cols (W,) int32, the columns in use.
    """
    if order.device.type == "cpu":
        return msa_torch(state, order)
    _check(state, order)
    if order.device.type != "cuda":
        raise ValueError(f"no kernel for device {order.device}")
    ins = tuple(t.contiguous() for t in (
        order, state.npred, state.nalig, state.base, state.pred, state.alig,
        state.paths, state.node_count))
    W, N, P = state.pred.shape
    A = state.alig.shape[2]
    S, L = state.paths.shape[1:]
    dev = order.device
    rows = torch.empty((W, S, N), dtype=torch.int32, device=dev)
    n_cols = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return rows, n_cols
    variant, windows = msa_plan(W, N, P, A, S, L)
    per = msa_scratch_ints(variant, N, P, A)
    scratch = torch.empty(W * per, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev), kernel_span("poa_msa", (state, order),
                                             W * (N + S * L)):
        err = lib.cga_poa_msa(
            *(t.data_ptr() for t in ins), rows.data_ptr(), n_cols.data_ptr(),
            scratch.data_ptr() if per else None, W, N, P, A, S, L,
            _PLAN_CODES[variant], windows,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_msa")
    return rows, n_cols
