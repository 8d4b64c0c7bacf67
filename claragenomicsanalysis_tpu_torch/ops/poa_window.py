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
  ``csrc/poa_window.cu`` runs every phase of a window in one warp (a launch
  of many windows) or one block (:func:`window_plan`), the graph in the
  window's slice of a device scratch buffer (:func:`window_scratch_bytes`)
  and only the graph NW's ring, row facts and sequence in shared memory
  (:func:`window_smem_bytes`); counted in ``launch.poa_window``.  A window
  whose shared memory passes what a block can have raises ``ValueError``
  with the sizes; it never switches route by itself.  For CPU tensors it
  runs its plain version.
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
from ..utils.mathutils import round_up
from ..utils.profiling import kernel_span, trace_range
from . import _build
from .poa_add import MAX_ALIGNED, add_alignment, add_alignment_torch
from .poa_consensus import consensus, consensus_table_bytes, consensus_torch
from .poa_msa import msa as msa_rows
from .poa_msa import msa_table_bytes, msa_torch
from .poa_nwtb import (BLOCK_WINDOWS, RING_ROWS, graph_nw_traceback,
                       graph_nw_traceback_torch, group_plan, nwtb_smem_bytes,
                       nwtb_word_bytes, ring_width)
from .poa_state import init_level, init_state
from .poa_topsort import topsort, topsort_table_bytes, topsort_torch

_LOOP = int(StatusType.LOOP_COUNT_EXCEEDED_UPPER_BOUND)
_BAND = int(StatusType.EXCEEDED_BAND_WIDTH)
_OK = int(StatusType.SUCCESS)


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
    with trace_range("poa.state"):
        state = init_state(bs, seqs[:, 0], weights[:, 0], lens[:, 0], msa)
        level = init_level(bs.padded_nodes, lens[:, 0])
    # the node count of the graph `level` was computed for: topsort's hint
    level_nc = state.node_count
    for s in range(1, S):
        alive = (s < n_seqs) & (state.status == _OK)
        nc_at_topsort = state.node_count    # the add returns a new state
        with trace_range("poa.topsort"):
            new_level, order, rank, ok = f_topsort(
                level, state.npred, state.pred, nc_at_topsort, level_nc)
        with trace_range("poa.nwtb"):
            pn, pp, k0, band_ok = f_nwtb(
                seqs[:, s], order, rank, state.npred, state.base,
                state.nsucc, state.pred, lens[:, s], state.node_count, alive,
                sc, bw)
        act = alive & band_ok
        with trace_range("poa.add"):
            new = f_add(state, pn, pp, seqs[:, s], weights[:, s], k0, act,
                        bs.max_nodes_per_window, s)
        with trace_range("poa.state"):
            status = torch.where(act & ~ok, _LOOP, new.status)
            status = torch.where(alive & ~band_ok, _BAND, status)
            state = new._replace(status=status.to(torch.int32))
            level = torch.where(alive[:, None], new_level, level)
            level_nc = torch.where(alive, nc_at_topsort, level_nc)
    with trace_range("poa.topsort"):
        _, order, rank, _ = f_topsort(level, state.npred, state.pred,
                                      state.node_count, level_nc)
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


def window_smem_bytes(bs: BatchSize, band_width: int = 0,
                      ring_rows: int = RING_ROWS, word: int = 4) -> int:
    """Shared memory one window takes in ``csrc/poa_window.cu``: the graph
    NW's (:func:`..poa_nwtb.nwtb_smem_bytes`: a ring of ``ring_rows`` rows,
    two rows' facts, the sequence as bytes) and four int32 of state (an
    even count of int32 in all for 8-byte words)."""
    ints = nwtb_smem_bytes(bs.padded_nodes, bs.max_pred_per_node,
                           bs.padded_seq, band_width, ring_rows, word) // 4
    ints += 4
    return 4 * (round_up(ints, 2) if word == 8 else ints)


def window_scratch_bytes(bs: BatchSize) -> int:
    """Device scratch one window takes in ``csrc/poa_window.cu``: the graph
    (5 node fields, level, order, rank, pred and predw, alig), the path
    (``pn``, ``pp``: N + L each) and the phases' tables, sized for the
    largest of topsort's (:func:`..poa_topsort.topsort_table_bytes`), the
    consensus's (:func:`..poa_consensus.consensus_table_bytes`) and the
    MSA's (:func:`..poa_msa.msa_table_bytes`).  The score plane comes on
    top (:func:`..poa_nwtb.plane_bytes`)."""
    N, L, MC = bs.padded_nodes, bs.padded_seq, bs.max_consensus_size
    P, A = bs.max_pred_per_node, bs.max_aligned_per_node
    tables = max(topsort_table_bytes(N), consensus_table_bytes(N, MC),
                 msa_table_bytes(N, P, A))
    return 4 * (N * (8 + 2 * P + A) + 2 * (N + L)) + tables


def window_plan(W: int, bs: BatchSize, band_width: int = 0,
                word: int = 4) -> tuple:
    """-> (variant, threads, ring) of a launch of W windows of ``bs``:
    :func:`..poa_nwtb.group_plan` with this module's BLOCK_WINDOWS and
    RING_ROWS (the graph NW's own, unless a caller sets them here) and one
    window's shared memory :func:`window_smem_bytes`.  So a warp a window
    where a graph-NW row has at most WARP_COLUMNS columns and the launch
    has more than BLOCK_WINDOWS windows, else a block a window.  Raises
    ValueError where not even a block a window without a ring fits (two
    rows of pred facts and the sequence past 227 KB: P past about 9,600 or
    L past about 232,000)."""
    plan = group_plan(W, ring_width(bs.padded_seq, band_width),
                      lambda ring: window_smem_bytes(bs, band_width, ring,
                                                     word),
                      BLOCK_WINDOWS, RING_ROWS)
    if plan is None:
        raise ValueError(
            f"the one-kernel-per-window POA keeps a window's graph-NW ring, "
            f"row facts and sequence in shared memory and needs "
            f"{window_smem_bytes(bs, band_width, 0, word)} B a block "
            f"without a ring for N={bs.padded_nodes}, "
            f"P={bs.max_pred_per_node}, L={bs.padded_seq}, more than the "
            f"{_build.SMEM_PER_BLOCK - 128} B a block can have; use "
            f"kernel=\"lockstep\" or a smaller BatchSize")
    return plan


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
    in one warp or one block (:func:`window_plan`; no plan changes a
    result).

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
    bw = bs.band_width if banded else 0
    word = nwtb_word_bytes(N, L, sc)
    variant, threads, ring = window_plan(W, bs, bw, word)
    graphs = torch.empty(W * window_scratch_bytes(bs) // 4, dtype=i32,
                         device=dev)
    plane = torch.empty((W, N + 1, L + 1), device=dev,
                        dtype=torch.int64 if word == 8 else i32)
    paths = torch.empty((W, S, L), dtype=i32, device=dev) if msa else None
    lib = _build.load()
    with torch.cuda.device(dev), kernel_span(
            "poa_window", (seqs, weights, lens, n_seqs, bs, sc, banded, msa),
            W * (S - 1) * N * (L + 1)):
        err = lib.cga_poa_window(
            seqs.data_ptr(), weights.data_ptr(), lens.data_ptr(),
            n_seqs.data_ptr(), graphs.data_ptr(), plane.data_ptr(),
            paths.data_ptr() if msa else None,
            codes.data_ptr(), covs.data_ptr(), length.data_ptr(),
            status.data_ptr(), rows.data_ptr() if msa else None,
            n_cols.data_ptr() if msa else None, W, N, P, A, S, L, MC,
            bs.max_nodes_per_window, sc.match_score, sc.mismatch_score,
            sc.gap_score, bw, int(variant == "block"), threads, ring,
            ring_width(L, bw), word, window_smem_bytes(bs, bw, ring, word),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_window")
    return codes, covs, length, rows, n_cols, status

