"""The POA of a launch of windows, by either of two routes with the same
outputs (counterparts of ``poa_batch_pallas2`` in
``claragenomicsanalysis_tpu/ops/poa_pallas2.py`` and of ``poa_batch_pallas``
in ``claragenomicsanalysis_tpu/ops/poa_pallas.py``; spec
``models/poa._build_program``).

- :func:`run_windows` is the lockstep route: all windows go through each
  step together.  Per added sequence the host enqueues topsort -> graph NW
  and traceback -> add-alignment (plus a few elementwise status updates)
  with no sync in between; after the last one, topsort once more, the
  consensus and, when asked for, the MSA.  Each step is its own kernel
  (``ops/poa_{topsort,nwtb,add,consensus,msa}.py``), and the graphs live in
  device memory between them.
- :func:`poa_window` is the one-kernel-per-window route: kernel
  ``csrc/poa_window.cu`` runs every phase of a window in one block, the graph
  in shared memory for the life of the window (counted in
  ``poa_window.launches``).  A plan whose shared memory passes what a block
  can have (``SMEM_LIMIT``) raises ``ValueError`` with the sizes; it never
  switches route by itself.  For CPU tensors it runs its plain version.
- :func:`poa_window_torch`, the plain version of that kernel, is the
  lockstep loop over the plain PyTorch versions of the five steps
  (``run_windows(..., plain=True)``).

The status rules are those of the JAX package: a window takes sequence s
while ``s < n_seqs`` and its status is SUCCESS; a sequence whose best end
cell lies outside the band leaves the graph as it was and sets
EXCEEDED_BAND_WIDTH; a topsort that did not converge sets
LOOP_COUNT_EXCEEDED_UPPER_BOUND; overflows come from the add.
"""

import torch

from ..core.config import BatchSize, PoaScores
from ..core.status import StatusType
from ..utils.profiling import kernel_span, trace_range
from . import _build
from .poa_add import MAX_ALIGNED, add_alignment, add_alignment_torch
from .poa_consensus import consensus, consensus_torch
from .poa_msa import msa as msa_rows
from .poa_msa import msa_torch
from .poa_nwtb import graph_nw_traceback, graph_nw_traceback_torch
from .poa_state import init_level, init_state
from .poa_topsort import topsort, topsort_torch

_LOOP = int(StatusType.LOOP_COUNT_EXCEEDED_UPPER_BOUND)
_BAND = int(StatusType.EXCEEDED_BAND_WIDTH)
_OK = int(StatusType.SUCCESS)
#: shared memory a block can have on Hopper (227 KB), less 1 KB for the
#: kernels' few static words
SMEM_LIMIT = 232_448 - 1024


def run_windows(bs: BatchSize, sc: PoaScores, banded: bool, seqs, weights,
                lens, n_seqs, msa: bool = False, plain: bool = False):
    """The lockstep route on one launch of windows, all tensors on one
    device.

    seqs, weights: (W, S, L) int32; lens: (W, S) int32; n_seqs: (W,) int32.
    ``plain`` runs the plain PyTorch version of every step whatever the
    device (what the kernels are held against).
    Returns (codes (W, MC), covs (W, MC), length (W,), rows (W, S, N),
    n_cols (W,), status (W,), state): ``rows`` is (W, S, 1) zeros and
    ``n_cols`` zeros without ``msa``; ``state`` is the final
    :class:`..poa_state.PoaState`."""
    fns = (topsort_torch, graph_nw_traceback_torch, add_alignment_torch,
           consensus_torch, msa_torch) if plain else \
        (topsort, graph_nw_traceback, add_alignment, consensus, msa_rows)
    f_topsort, f_nwtb, f_add, f_consensus, f_msa = fns
    W, S = seqs.shape[:2]
    bw = bs.band_width if banded else 0
    state = init_state(bs, seqs[:, 0], weights[:, 0], lens[:, 0], msa)
    level = init_level(bs.padded_nodes, lens[:, 0])
    for s in range(1, S):
        alive = (s < n_seqs) & (state.status == _OK)
        with trace_range("poa.topsort"):
            new_level, order, rank, ok = f_topsort(
                level, state.npred, state.pred, state.node_count)
        with trace_range("poa.nwtb"):
            pn, pp, k0, band_ok = f_nwtb(
                seqs[:, s], order, rank, state.npred, state.base,
                state.nsucc, state.pred, lens[:, s], state.node_count, alive,
                sc, bw)
        act = alive & band_ok
        with trace_range("poa.add"):
            new = f_add(state, pn, pp, seqs[:, s], weights[:, s], k0, act,
                        bs.max_nodes_per_window, s)
        status = torch.where(act & ~ok, _LOOP, new.status)
        status = torch.where(alive & ~band_ok, _BAND, status)
        state = new._replace(status=status.to(torch.int32))
        level = torch.where(alive[:, None], new_level, level)
    with trace_range("poa.topsort"):
        _, order, rank, _ = f_topsort(level, state.npred, state.pred,
                                      state.node_count)
    with trace_range("poa.consensus"):
        codes, covs, length = f_consensus(
            state.npred, state.pred, state.predw, state.base, state.cov,
            rank, state.node_count, bs.max_consensus_size)
    if msa:
        with trace_range("poa.msa"):
            rows, n_cols = f_msa(state, order)
    else:
        rows = torch.zeros((W, S, 1), dtype=torch.int32, device=seqs.device)
        n_cols = torch.zeros(W, dtype=torch.int32, device=seqs.device)
    return codes, covs, length, rows, n_cols, state.status, state


def window_smem_bytes(bs: BatchSize) -> int:
    """Shared memory one window's block takes in ``csrc/poa_window.cu``: the
    graph (5 node fields, pred and predw, alig), level, order and rank, then
    one scratch region sized for the largest phase (topsort's two level
    buffers, the graph NW's staging ``L + 3N + NP``, the consensus's tables
    ``6N + NP + MC``)."""
    N, L, MC = bs.padded_nodes, bs.padded_seq, bs.max_consensus_size
    P, A = bs.max_pred_per_node, bs.max_aligned_per_node
    scratch = max(2 * N, L + 3 * N + N * P, 6 * N + N * P + MC)
    return 4 * (N * (8 + 2 * P + A) + scratch)


def _check(seqs, weights, lens, n_seqs, bs: BatchSize):
    W = seqs.shape[0]
    S, L = bs.max_sequences_per_poa, bs.padded_seq
    if seqs.shape != (W, S, L) or weights.shape != seqs.shape \
            or lens.shape != (W, S) or n_seqs.shape != (W,):
        raise ValueError(f"want seqs/weights (W, {S}, {L}), lens (W, {S}), "
                         "n_seqs (W,)")
    tensors = (seqs, weights, lens, n_seqs)
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError("poa_window takes int32 tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("poa_window's tensors must be on one device")
    if bs.max_aligned_per_node > MAX_ALIGNED:
        raise ValueError(f"max_aligned_per_node > {MAX_ALIGNED}")


def poa_window_torch(seqs, weights, lens, n_seqs, bs: BatchSize,
                     sc: PoaScores, banded: bool = False, msa: bool = False):
    """Plain PyTorch version of :func:`poa_window`: the same outputs."""
    _check(seqs, weights, lens, n_seqs, bs)
    return run_windows(bs, sc, banded, seqs, weights, lens, n_seqs, msa,
                       plain=True)[:6]


def poa_window(seqs, weights, lens, n_seqs, bs: BatchSize, sc: PoaScores,
               banded: bool = False, msa: bool = False):
    """Consensus (and MSA) of one launch of windows, each window's whole POA
    in one block.

    Args:
      seqs, weights: (W, S, L) int32 codes (-1 pad) and weights.
      lens: (W, S) int32; n_seqs: (W,) int32.
      bs, sc: the batch's sizes and scores; banded: the static band of
        ``bs.band_width``; msa: also compute the gapped rows.

    Returns:
      (codes (W, MC), covs (W, MC), length (W,), rows (W, S, N), n_cols (W,),
      status (W,)) int32, as :func:`run_windows`' first six.
    """
    if seqs.device.type == "cpu":
        return poa_window_torch(seqs, weights, lens, n_seqs, bs, sc, banded,
                                msa)
    _check(seqs, weights, lens, n_seqs, bs)
    if seqs.device.type != "cuda":
        raise ValueError(f"no kernel for device {seqs.device}")
    smem = window_smem_bytes(bs)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the one-kernel-per-window POA keeps a window's graph in shared "
            f"memory and needs {smem} B a block for N={bs.padded_nodes}, "
            f"P={bs.max_pred_per_node}, A={bs.max_aligned_per_node}, "
            f"L={bs.padded_seq}, MC={bs.max_consensus_size}, more than the "
            f"{SMEM_LIMIT} B a block can have; use kernel=\"lockstep\" or a "
            f"smaller BatchSize")
    seqs, weights, lens, n_seqs = (t.contiguous()
                                   for t in (seqs, weights, lens, n_seqs))
    W, S, L = seqs.shape
    N, MC = bs.padded_nodes, bs.max_consensus_size
    P, A = bs.max_pred_per_node, bs.max_aligned_per_node
    dev, i32 = seqs.device, torch.int32
    codes = torch.empty((W, MC), dtype=i32, device=dev)
    covs = torch.empty_like(codes)
    length = torch.empty(W, dtype=i32, device=dev)
    status = torch.empty(W, dtype=i32, device=dev)
    if msa:
        rows = torch.empty((W, S, N), dtype=i32, device=dev)
        n_cols = torch.empty(W, dtype=i32, device=dev)
    else:
        rows = torch.zeros((W, S, 1), dtype=i32, device=dev)
        n_cols = torch.zeros(W, dtype=i32, device=dev)
    if W == 0:
        return codes, covs, length, rows, n_cols, status
    plane = torch.empty((W, N + 1, L + 1), dtype=i32, device=dev)
    pn = torch.empty((W, N + L), dtype=i32, device=dev)
    pp = torch.empty_like(pn)
    paths = torch.empty((W, S, L), dtype=i32, device=dev) if msa else None
    lib = _build.load()
    with torch.cuda.device(dev), kernel_span(
            "poa_window", (seqs, weights, lens, n_seqs, bs, sc, banded, msa),
            W * (S - 1) * N * (L + 1)):
        err = lib.cga_poa_window(
            seqs.data_ptr(), weights.data_ptr(), lens.data_ptr(),
            n_seqs.data_ptr(), plane.data_ptr(), pn.data_ptr(),
            pp.data_ptr(), paths.data_ptr() if msa else None,
            codes.data_ptr(), covs.data_ptr(), length.data_ptr(),
            status.data_ptr(), rows.data_ptr() if msa else None,
            n_cols.data_ptr() if msa else None, W, N, P, A, S, L, MC,
            bs.max_nodes_per_window, sc.match_score, sc.mismatch_score,
            sc.gap_score, bs.band_width if banded else 0, smem,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_window")
    poa_window.launches += 1
    return codes, covs, length, rows, n_cols, status


poa_window.launches = 0

