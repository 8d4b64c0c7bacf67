"""Heaviest-bundle consensus of each window's POA graph (counterpart of
``_consensus_pallas`` in ``claragenomicsanalysis_tpu/ops/poa_pallas2.py``;
spec ``poa_ops.consensus``).

A node's score is its heaviest in-edge weight ``wmax`` plus the largest
score among the preds whose edge weighs ``wmax``; a source scores 0 and an
inactive node NEG.  The scores are the fixpoint of Jacobi sweeps over all
nodes (at most ``N + 2``), the relaxation of ``poa_ops.consensus``; on a
DAG it equals one pass in topological order.  ``best_pred`` is the first
pred slot reaching that score.  The path ends at the best-scoring node
(ties to the smallest rank) and is walked back through ``best_pred``,
written from the end of an ``MC``-long buffer, so an overlong path keeps its
``MC`` nodes nearest the end, then moved to the front: ``codes`` (-1 pad),
``covs`` (0 pad) and ``length``.

- :func:`consensus` is the entry point (kernel ``csrc/poa_consensus.cu``
  for CUDA tensors, counted in ``launch.poa_consensus``; the plain version for
  CPU tensors).  The kernel visits each window's nodes once in rank order,
  confirms the fixpoint, and runs the Jacobi sweeps only where that fails
  (a rank that is not a topological permutation of the active nodes).
- :func:`consensus_torch` is the plain PyTorch version, vectorised over
  windows with Python loops over sweeps and backtrack steps.
- :func:`consensus_plan` chooses where the kernel keeps a window's tables.
"""

import torch

from ..utils.profiling import kernel_span
from . import _build
from .poa_state import NEG, padget_cols


#: windows a block of the kernel (one a warp) where the tables fit
CONSENSUS_WINDOWS = 4


def consensus_table_bytes(N: int, MC: int) -> int:
    """The tables the kernel keeps a window (``csrc/poa_consensus.cuh``
    consensus_table_ints): the scores, a second buffer (the visit order,
    Jacobi's second score buffer, the best preds), the heaviest in-edge
    weights, the first tied preds, the tie counts and the ranks (N int32
    each) and the walk back (MC int32)."""
    return 4 * (6 * N + MC)


def consensus_plan(W: int, N: int, P: int, MC: int) -> tuple:
    """-> (variant, windows a block) of a launch of W windows of N nodes, P
    pred slots and MC consensus bases: a warp a window, ``"warp-shared"``
    with the most windows (CONSENSUS_WINDOWS, 2 or 1) whose
    :func:`consensus_table_bytes` fit a block (``_build.SMEM_PER_BLOCK``),
    else ``"warp-device"`` (CONSENSUS_WINDOWS a block, the tables in a
    device scratch slice a window).  No table depends on W or P: a node's
    tied preds past its first are read from pred and predw where they
    lie."""
    per = consensus_table_bytes(N, MC)
    for n in (CONSENSUS_WINDOWS, 2, 1):
        if n * per <= _build.SMEM_PER_BLOCK:
            return "warp-shared", n
    return "warp-device", CONSENSUS_WINDOWS


def _check(npred, pred, predw, base, cov, rank, node_count):
    W, N = npred.shape
    if pred.dim() != 3 or pred.shape[:2] != (W, N) \
            or predw.shape != pred.shape \
            or any(t.shape != (W, N) for t in (base, cov, rank)) \
            or node_count.shape != (W,):
        raise ValueError("want npred/base/cov/rank (W, N), pred/predw "
                         "(W, N, P), node_count (W,)")
    tensors = (npred, pred, predw, base, cov, rank, node_count)
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError("consensus takes int32 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("consensus's tensors must be on one device")


def consensus_torch(npred, pred, predw, base, cov, rank, node_count,
                    max_cons: int):
    """Plain PyTorch version of :func:`consensus`: the same outputs."""
    _check(npred, pred, predw, base, cov, rank, node_count)
    W, N, P = pred.shape
    dev, i32 = npred.device, torch.int32
    MC = max_cons
    idx = torch.arange(N, device=dev)[None, :]
    act = idx < node_count[:, None]
    slot_ok = (torch.arange(P, device=dev)[None, None, :]
               < npred[:, :, None]) & act[:, :, None]
    predc = pred.clamp(0, N - 1)
    w = torch.where(slot_ok, predw, NEG)
    wmax = w.max(2).values
    tie1 = slot_ok & (w == wmax[:, :, None])
    has = npred > 0

    def lex(score):
        ps = torch.where(tie1, padget_cols(score, predc, NEG), NEG)
        smax = ps.max(2).values
        new = torch.where(has, wmax + smax, 0)
        return torch.where(act, new, NEG).to(i32), ps, smax

    score = torch.where(act & ~has, 0, NEG).to(i32)
    for _ in range(N + 2):
        new = lex(score)[0]
        changed = bool((new != score).any())
        score = new
        if not changed:
            break
    _, ps, smax = lex(score)
    tie2 = tie1 & (ps == smax[:, :, None])
    sel = tie2.to(i32).argmax(2)
    best_pred = torch.where(act & has,
                            pred.gather(2, sel[:, :, None])[:, :, 0], -1)

    smax_all = torch.where(act, score, NEG).max(1).values
    tie_end = act & (score == smax_all[:, None])
    end = torch.where(tie_end, rank, 2**30).argmin(1).to(i32)

    u = torch.where(node_count > 0, end, -1)
    k = torch.full((W,), MC, dtype=i32, device=dev)
    buf = torch.full((W, MC), -1, dtype=i32, device=dev)
    wi = torch.arange(W, device=dev)
    while True:
        going = (u >= 0) & (k > 0)
        if not bool(going.any()):
            break
        gw = going.nonzero()[:, 0]
        buf[gw, (k[gw] - 1).long()] = u[gw]
        u = torch.where(going, padget_cols(best_pred, u[:, None], -1)[:, 0], u)
        k = torch.where(going, k - 1, k)
    length = MC - k
    ar = torch.arange(MC, device=dev)[None, :]
    valid = ar < length[:, None]
    node = buf[wi[:, None], (ar + k[:, None]).clamp(max=MC - 1)]
    codes = torch.where(valid, padget_cols(base, node, -1), -1).to(i32)
    covs = torch.where(valid, padget_cols(cov, node, 0), 0).to(i32)
    return codes, covs, length.to(i32)


def consensus(npred, pred, predw, base, cov, rank, node_count,
              max_cons: int):
    """Consensus of every window's graph.

    Args:
      npred, base, cov: (W, N) int32; pred, predw (W, N, P) int32.
      rank: (W, N) int32 topological ranks (from the final topsort).
      node_count: (W,) int32.
      max_cons: MC, BatchSize.max_consensus_size.

    Returns:
      codes (W, MC) int32 bases (-1 pad), covs (W, MC) int32 coverages
      (0 pad), length (W,) int32.
    """
    if npred.device.type == "cpu":
        return consensus_torch(npred, pred, predw, base, cov, rank,
                               node_count, max_cons)
    _check(npred, pred, predw, base, cov, rank, node_count)
    if npred.device.type != "cuda":
        raise ValueError(f"no kernel for device {npred.device}")
    ins = tuple(t.contiguous() for t in (npred, pred, predw, base, cov, rank,
                                         node_count))
    W, N, P = pred.shape
    dev = npred.device
    codes = torch.empty((W, max_cons), dtype=torch.int32, device=dev)
    covs = torch.empty_like(codes)
    length = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return codes, covs, length
    variant, windows = consensus_plan(W, N, P, max_cons)
    device = variant == "warp-device"
    scratch = torch.empty(
        W * consensus_table_bytes(N, max_cons) // 4 if device else 0,
        dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev), kernel_span(
            "poa_consensus", ins + (max_cons,), W * N * P):
        err = lib.cga_poa_consensus(
            *(t.data_ptr() for t in ins), codes.data_ptr(), covs.data_ptr(),
            length.data_ptr(), scratch.data_ptr() if device else None, W, N,
            P, max_cons, windows, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_consensus")
    return codes, covs, length
