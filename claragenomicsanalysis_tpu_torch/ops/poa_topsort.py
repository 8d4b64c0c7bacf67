"""Topological order of each window's POA graph (counterpart of
``_topsort_pallas`` in ``claragenomicsanalysis_tpu/ops/poa_pallas2.py``,
spec ``poa_ops.topsort``).

Levels are longest-path depths, found by Jacobi sweeps from the carried
levels (edges are only ever added, so levels only grow and a warm start
converges in few sweeps): ``level[u] = max(level[pred] + 1, 0)`` over u's
pred slots, at most ``N + 2`` sweeps, ``ok`` when the last sweep changed
nothing.  Then ``order`` is the stable sort of the nodes by
``(level, id)``, inactive nodes (``u >= node_count``) last in id order, and
``rank`` its inverse.

- :func:`topsort` is the entry point: it launches ``csrc/poa_topsort.cu``
  for CUDA tensors (counted in ``launch.poa_topsort``, timed inside a
  ``utils.profiling.kernel_times()`` block) and runs the plain version for
  CPU tensors.  The kernel reaches the same levels by relaxing each
  window's nodes in a visit order built from the carried levels and
  ``nc_pre`` (the node count those levels were computed for), confirms the
  fixpoint, and runs the Jacobi sweeps only where that fails; it ranks by a
  counting sort.  ``nc_pre`` changes no output.
- :func:`topsort_torch` is the plain PyTorch version, vectorised over
  windows with a Python loop over sweeps.
- :func:`topsort_plan` chooses where the kernel keeps a window's tables.
"""

import torch

from ..utils.profiling import kernel_span
from . import _build
from .poa_state import padget_cols


#: windows a block of the kernel (one a warp) where the tables fit
TOPSORT_WINDOWS = 4


def topsort_table_bytes(N: int) -> int:
    """The tables the kernel keeps a window (``csrc/poa_topsort.cuh``
    topsort_table_ints): levels, a second level buffer, the visit positions
    and the visit order (N int32 each) and a histogram of N + 2 bins."""
    return 4 * (5 * N + 2)


def topsort_plan(N: int) -> tuple:
    """-> (variant, windows a block) of a launch at N nodes a window: a warp
    a window, ``"warp-shared"`` with the most windows (TOPSORT_WINDOWS, 2 or
    1) whose :func:`topsort_table_bytes` fit a block
    (``_build.SMEM_PER_BLOCK``), else ``"warp-device"`` (TOPSORT_WINDOWS a
    block, the tables in a device scratch slice a window).  No table
    depends on the pred slots: the pred lists are read where they lie."""
    per = topsort_table_bytes(N)
    for n in (TOPSORT_WINDOWS, 2, 1):
        if n * per <= _build.SMEM_PER_BLOCK:
            return "warp-shared", n
    return "warp-device", TOPSORT_WINDOWS


def _check(level, npred, pred, node_count, nc_pre=None):
    W, N = level.shape
    if pred.dim() != 3 or pred.shape[:2] != (W, N) or npred.shape != (W, N) \
            or node_count.shape != (W,):
        raise ValueError("want level, npred (W, N), pred (W, N, P), "
                         "node_count (W,)")
    if nc_pre is not None and nc_pre.shape != (W,):
        raise ValueError("want nc_pre (W,)")
    tensors = [t for t in (level, npred, pred, node_count, nc_pre)
               if t is not None]
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError("topsort takes int32 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("topsort's tensors must be on one device")


def topsort_torch(level: torch.Tensor, npred: torch.Tensor,
                  pred: torch.Tensor, node_count: torch.Tensor,
                  nc_pre: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`topsort`: the same outputs (the
    Jacobi sweeps need no hint: ``nc_pre`` is only checked)."""
    _check(level, npred, pred, node_count, nc_pre)
    W, N, P = pred.shape
    dev = level.device
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(W, N)
    active = idx < node_count[:, None]
    slot_ok = torch.arange(P, device=dev)[None, None, :] < npred[:, :, None]
    lvl = torch.where(active, level.clamp(min=0), 0)
    changed = torch.ones(W, dtype=torch.bool, device=dev)
    for _ in range(N + 2):
        # a window that has converged stays at its fixpoint, so sweeping all
        # windows together equals sweeping each on its own
        pl = padget_cols(lvl, pred, -1)
        pl = torch.where(slot_ok, pl, -1)
        new = (pl.max(2).values + 1).clamp(min=0) if P else \
            torch.zeros_like(lvl)
        new = torch.where(active, new, lvl)
        changed = (new != lvl).any(1)
        lvl = new
        if not bool(changed.any()):
            break
    key = torch.where(active, lvl.long() * N + idx, 2**30 + idx.long())
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    rank = torch.empty_like(order)
    rank.scatter_(1, order.long(), idx.contiguous())
    return lvl.to(torch.int32), order, rank, ~changed


def topsort(level: torch.Tensor, npred: torch.Tensor, pred: torch.Tensor,
            node_count: torch.Tensor, nc_pre: torch.Tensor | None = None):
    """Levels and topological order of every window's graph.

    Args:
      level: (W, N) int32 levels of the last topsort (warm start).
      npred: (W, N) int32 in-degrees; pred (W, N, P) int32 pred lists.
      node_count: (W,) int32.
      nc_pre: (W,) int32, the node count of the graph ``level`` was
        computed for (the nodes past it are the last add's), or None (every
        node old).  A hint: no value changes an output.

    Returns:
      (level, order, rank) (W, N) int32 and ok (W,) bool.
    """
    if level.device.type == "cpu":
        return topsort_torch(level, npred, pred, node_count, nc_pre)
    _check(level, npred, pred, node_count, nc_pre)
    if level.device.type != "cuda":
        raise ValueError(f"no kernel for device {level.device}")
    level, npred, pred, node_count = (
        t.contiguous() for t in (level, npred, pred, node_count))
    if nc_pre is not None:
        nc_pre = nc_pre.contiguous()
    W, N, P = pred.shape
    out_level = torch.empty_like(level)
    order = torch.empty_like(level)
    rank = torch.empty_like(level)
    ok = torch.empty(W, dtype=torch.int32, device=level.device)
    if W == 0:
        return out_level, order, rank, ok.bool()
    variant, windows = topsort_plan(N)
    device = variant == "warp-device"
    scratch = torch.empty(W * topsort_table_bytes(N) // 4 if device else 0,
                          dtype=torch.int32, device=level.device)
    lib = _build.load()
    with torch.cuda.device(level.device), kernel_span(
            "poa_topsort", (level, npred, pred, node_count, nc_pre),
            W * N * P):
        err = lib.cga_poa_topsort(
            level.data_ptr(), npred.data_ptr(), pred.data_ptr(),
            node_count.data_ptr(),
            None if nc_pre is None else nc_pre.data_ptr(),
            out_level.data_ptr(), order.data_ptr(), rank.data_ptr(),
            ok.data_ptr(), scratch.data_ptr() if device else None, W, N, P,
            windows, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_topsort")
    return out_level, order, rank, ok.bool()
