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
  for CUDA tensors (counted in ``topsort.launches``, timed inside a
  ``utils.profiling.kernel_times()`` block) and runs the plain version for
  CPU tensors.
- :func:`topsort_torch` is the plain PyTorch version, vectorised over
  windows with a Python loop over sweeps.
"""

import torch

from ..utils.profiling import kernel_span
from . import _build
from .poa_state import padget_cols


def topsort_smem_bytes(N: int, P: int) -> int:
    """Shared memory a block of the kernel's shared variant takes: two level
    buffers, the in-degrees and the pred lists, ``4 N (3 + P)`` bytes.  Past
    ``_build.SMEM_PER_BLOCK`` the device variant runs, with the two level
    buffers (8N bytes a window) in device scratch."""
    return 4 * N * (3 + P)


def topsort_variant(N: int, P: int) -> str:
    """``"shared"`` where :func:`topsort_smem_bytes` fits a block, else
    ``"device"``."""
    fits = topsort_smem_bytes(N, P) <= _build.SMEM_PER_BLOCK
    return "shared" if fits else "device"


def _check(level, npred, pred, node_count):
    W, N = level.shape
    if pred.dim() != 3 or pred.shape[:2] != (W, N) or npred.shape != (W, N) \
            or node_count.shape != (W,):
        raise ValueError("want level, npred (W, N), pred (W, N, P), "
                         "node_count (W,)")
    if any(t.dtype != torch.int32 for t in (level, npred, pred, node_count)):
        raise ValueError("topsort takes int32 tensors")
    if len({t.device for t in (level, npred, pred, node_count)}) != 1:
        raise ValueError("topsort's tensors must be on one device")


def topsort_torch(level: torch.Tensor, npred: torch.Tensor,
                  pred: torch.Tensor, node_count: torch.Tensor):
    """Plain PyTorch version of :func:`topsort`: the same outputs."""
    _check(level, npred, pred, node_count)
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
            node_count: torch.Tensor):
    """Levels and topological order of every window's graph.

    Args:
      level: (W, N) int32 levels of the last topsort (warm start).
      npred: (W, N) int32 in-degrees; pred (W, N, P) int32 pred lists.
      node_count: (W,) int32.

    Returns:
      (level, order, rank) (W, N) int32 and ok (W,) bool.
    """
    if level.device.type == "cpu":
        return topsort_torch(level, npred, pred, node_count)
    _check(level, npred, pred, node_count)
    if level.device.type != "cuda":
        raise ValueError(f"no kernel for device {level.device}")
    level, npred, pred, node_count = (
        t.contiguous() for t in (level, npred, pred, node_count))
    W, N, P = pred.shape
    out_level = torch.empty_like(level)
    order = torch.empty_like(level)
    rank = torch.empty_like(level)
    ok = torch.empty(W, dtype=torch.int32, device=level.device)
    if W == 0:
        return out_level, order, rank, ok.bool()
    device = topsort_variant(N, P) == "device"
    scratch = torch.empty(2 * W * N if device else 0, dtype=torch.int32,
                          device=level.device)
    lib = _build.load()
    with torch.cuda.device(level.device), kernel_span(
            "poa_topsort", (level, npred, pred, node_count), W * N * P):
        err = lib.cga_poa_topsort(
            level.data_ptr(), npred.data_ptr(), pred.data_ptr(),
            node_count.data_ptr(), out_level.data_ptr(), order.data_ptr(),
            rank.data_ptr(), ok.data_ptr(),
            scratch.data_ptr() if device else None, W, N, P,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_topsort")
    topsort.launches += 1
    return out_level, order, rank, ok.bool()


topsort.launches = 0
