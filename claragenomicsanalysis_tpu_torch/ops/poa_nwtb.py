"""Sequence-to-graph Needleman-Wunsch and its canonical traceback, for one
added sequence per window (counterpart of ``_nwtb_pallas`` in
``claragenomicsanalysis_tpu/ops/poa_pallas2.py``; spec ``poa_ops.graph_nw``
and ``poa_ops.nw_traceback``).

The score plane S has N + 1 rows of L + 1 columns per window: row 0 is the
virtual source (``S[0, j] = j * gap``), row r + 1 the node of rank r.  Row
r + 1 takes, per column, the max over u's pred rows (row 0 for a source),
then ``diag``/``vert`` and the in-row gap chain in closed form:
``row[j] = j*g + cummax(vals[j] - j*g)``.  With a band (``band_width`` > 0)
row r keeps only the columns ``|j - ((r+1)*slen)//(node_count+1)| <=
band_width // 2``.  Unreachable cells hold ``NEG``, and sums on them are
plain int32 arithmetic, never saturated, as in the JAX package: the plane
equals ``poa_ops.graph_nw``'s cell for cell, NEG-derived cells of banded
rows included (C5 in ROADMAP.md).  The traceback tests ``pv + sub == here``
and ``pv + g == here`` only from a real end cell (``band_ok``), and a real
cell never equals one derived from NEG.

The traceback starts at the best sink (``nsucc == 0``) in column ``slen``
(ties to the smallest rank) and moves, in priority, along the virtual row,
diagonally, vertically, else horizontally; pred slots are tried in order.
The path is written backwards from ``TL = N + L``: ``pn`` holds the node of
each step (-1 for an insertion), ``pp`` the sequence position (-1 for a
deletion), both -2 before ``k0``.  ``band_ok`` is ``vmax > NEG // 2`` at
the end cell.

A window that is not ``alive``, or whose ``band_ok`` is False, gets an
inert path (``k0 = TL``, all -2) and no traceback; one that is not alive
also gets ``band_ok`` False.  The caller ignores both.

- :func:`graph_nw_traceback` is the entry point (kernel
  ``csrc/poa_nwtb.cu`` for CUDA tensors, counted in
  ``launch.poa_nwtb``; the plain version for CPU tensors).
- :func:`graph_nw_traceback_torch` is the plain PyTorch version, vectorised
  over windows with Python loops over rows (:func:`score_plane_torch`, the
  plane itself) and traceback steps.
"""

import torch

from ..core.config import PoaScores
from ..utils.mathutils import round_up
from ..utils.profiling import kernel_span
from . import _build
from .poa_state import NEG, padget_cols


def nwtb_word_bytes(N: int, L: int, scores: PoaScores) -> int:
    """Bytes of the kernel's plane word: 4 (an int32 holding the value in
    24 bits above the move byte) where every real cell fits, |score| x
    (N + L + 1) < 2^22, else 8 (an int64 holding the int32 value whole)."""
    top = max(abs(scores.match_score), abs(scores.mismatch_score),
              abs(scores.gap_score))
    return 4 if top * (N + L + 1) < 1 << 22 else 8


def plane_bytes(N: int, L: int, scores: PoaScores | None = None) -> int:
    """Bytes of one window's score plane, in the kernel's words."""
    word = nwtb_word_bytes(N, L, scores or PoaScores())
    return word * (N + 1) * (L + 1)


#: the widest row a warp takes, the windows of a block of the warp variant,
#: the ring's deepest rows, the threads of a block a window for rows a warp
#: could take, and the most windows a launch gives a block each (8 an SM of
#: 132)
WARP_COLUMNS, WARP_WINDOWS, RING_ROWS = 512, 4, 8
BLOCK_THREADS, BLOCK_WINDOWS = 128, 8 * 132


def ring_width(L: int, band_width: int) -> int:
    """Columns of a ring row: the band's 2 (band_width // 2) + 1 when
    banded, else all L + 1."""
    if band_width > 0:
        return min(2 * (band_width // 2) + 1, L + 1)
    return L + 1


def nwtb_smem_bytes(N: int, P: int, L: int, band_width: int,
                    ring_rows: int = RING_ROWS, word: int = 4) -> int:
    """Shared memory one window takes in ``csrc/poa_nwtb.cu``: a ring of
    ``ring_rows`` rows of :func:`ring_width` words of ``word`` bytes, the
    facts of two rows (in-degree, base, band, and each pred slot's plane
    row and band: 4 + 3P int32 each) and the sequence as bytes, in int32
    (an even count of them for 8-byte words).  The graph is read where it
    lies, through L1, so no node count is refused."""
    ints = (ring_rows * ring_width(L, band_width) * word // 4
            + 2 * (4 + 3 * P) + -(-L // 4))
    return 4 * (round_up(ints, 2) if word == 8 else ints)


def group_plan(W: int, RW: int, smem_of, block_windows: int,
               ring_rows: int) -> tuple | None:
    """-> (variant, threads, ring) of a launch of W windows whose rows have
    RW columns, where ``smem_of(ring)`` is one window's shared memory with
    a ring of that many rows; None where not even a block a window without
    a ring fits.  Shared by B5 (:func:`nwtb_plan`) and B10
    (``ops.poa_window.window_plan``), each with its own thresholds.

    ``"warp"`` (a warp a window, WARP_WINDOWS windows a block: many windows
    fill the card by themselves) where a row has at most WARP_COLUMNS
    columns, the launch has more than ``block_windows`` windows and
    WARP_WINDOWS windows fit a block; else ``"block"`` (a block a window:
    BLOCK_THREADS threads, a row's columns spread over four warps, which a
    window's chain of rows needs when few windows share the card, or about
    four columns a thread, up to 1,024 threads, for wider rows).  The ring
    is the deepest power of two up to ``ring_rows`` whose rings fit a
    block, 0 when not even two rows do."""
    limit = _build.SMEM_PER_BLOCK - 128      # the warp totals are static

    def fits(windows, ring):
        return windows * smem_of(ring) <= limit

    if RW <= WARP_COLUMNS and W > block_windows and fits(WARP_WINDOWS, 0):
        variant, threads, windows = "warp", 32 * WARP_WINDOWS, WARP_WINDOWS
    else:
        variant, windows = "block", 1
        threads = BLOCK_THREADS if RW <= WARP_COLUMNS else \
            min(1024, round_up(-(-RW // 4), 32))
        if not fits(1, 0):
            return None
    ring = ring_rows
    while ring >= 2 and not fits(windows, ring):
        ring //= 2
    return variant, threads, (ring if ring >= 2 else 0)


def nwtb_plan(W: int, N: int, P: int, L: int, band_width: int,
              word: int = 4) -> tuple:
    """-> (variant, threads, ring) of a launch of W windows (:func:`group_plan`
    with BLOCK_WINDOWS and RING_ROWS, one window's shared memory
    :func:`nwtb_smem_bytes`).  Raises ValueError where not even a block a
    window without a ring fits (two rows of pred facts and the sequence
    past 227 KB: P past about 9,600 or L past about 232,000)."""
    plan = group_plan(W, ring_width(L, band_width),
                      lambda ring: nwtb_smem_bytes(N, P, L, band_width, ring,
                                                   word),
                      BLOCK_WINDOWS, RING_ROWS)
    if plan is None:
        raise ValueError(
            f"graph NW: a window's pred facts and sequence take "
            f"{nwtb_smem_bytes(N, P, L, band_width, 0, word)} B of "
            f"shared memory, past a block's {_build.SMEM_PER_BLOCK - 128} "
            f"(P={P}, L={L})")
    return plan


def _check(seq, order, rank, npred, base, nsucc, pred, slen, node_count,
           alive):
    W, L = seq.shape
    N = order.shape[1]
    two = (order, rank, npred, base, nsucc)
    if any(t.shape != (W, N) for t in two) or pred.dim() != 3 \
            or pred.shape[:2] != (W, N) \
            or any(t.shape != (W,) for t in (slen, node_count, alive)):
        raise ValueError("want seq (W, L), order/rank/npred/base/nsucc "
                         "(W, N), pred (W, N, P), slen/node_count/alive (W,)")
    if any(t.dtype != torch.int32 for t in (seq, pred, slen, node_count)
           + two) or alive.dtype != torch.bool:
        raise ValueError("graph_nw_traceback takes int32 tensors and a bool "
                         "alive")
    if len({t.device for t in (seq, pred, slen, node_count, alive)
            + two}) != 1:
        raise ValueError("graph_nw_traceback's tensors must be on one device")


def score_plane_torch(seq, order, rank, npred, base, pred, slen, node_count,
                      alive, scores: PoaScores, band_width: int = 0):
    """The score plane S (W, N + 1, L + 1) of the plain version, equal to
    ``poa_ops.graph_nw``'s on every window that is ``alive`` (rows of the
    others past the live windows' node counts stay NEG)."""
    W, L = seq.shape
    N, P = pred.shape[1], pred.shape[2]
    dev, i32 = seq.device, torch.int32
    g, ma, mi = scores.gap_score, scores.match_score, scores.mismatch_score
    jj = torch.arange(L + 1, dtype=i32, device=dev)
    wi = torch.arange(W, device=dev)
    arP = torch.arange(P, device=dev)
    nc = node_count
    S = torch.full((W, N + 1, L + 1), NEG, dtype=i32, device=dev)
    S[:, 0] = jj * g
    seq_valid = jj[None, :L] < slen[:, None]
    live = alive & (nc > 0)
    n_rows = min(N, int(nc[live].max())) if bool(live.any()) else 0
    for r in range(n_rows):
        u = order[:, r].long()
        act = r < nc
        np_u = npred[wi, u]
        slot_ok = arP[None, :] < np_u[:, None]
        prow = torch.where(slot_ok, padget_cols(rank, pred[wi, u], -1) + 1, 0)
        prows = S[wi[:, None], prow.clamp(0, N).long()]          # (W, P, L+1)
        prows = torch.where(slot_ok[:, :, None], prows, NEG)
        pmax = prows.max(1).values if P else S[:, 0].clone()
        pmax = torch.where((np_u == 0)[:, None], S[:, 0], pmax)
        b_u = base[wi, u][:, None]
        sub = torch.where((seq == b_u) & (seq >= 0), ma, mi)
        sub = torch.where(seq_valid, sub, mi)
        tmp = torch.maximum(pmax[:, :-1] + sub, pmax[:, 1:] + g)
        vals = torch.cat([pmax[:, :1] + g, tmp], 1)
        if band_width > 0:
            c = torch.div((r + 1) * slen, nc + 1, rounding_mode="floor")
            in_band = (jj[None, :] - c[:, None]).abs() <= band_width // 2
            vals = torch.where(in_band, vals, NEG)
        row = torch.cummax(vals - jj * g, dim=1).values + jj * g
        if band_width > 0:
            row = torch.where(in_band, row, NEG)
        S[:, r + 1] = torch.where(act[:, None], row, NEG)
    return S


def graph_nw_traceback_torch(seq, order, rank, npred, base, nsucc, pred,
                             slen, node_count, alive, scores: PoaScores,
                             band_width: int = 0):
    """Plain PyTorch version of :func:`graph_nw_traceback`: the same
    outputs."""
    _check(seq, order, rank, npred, base, nsucc, pred, slen, node_count,
           alive)
    W, L = seq.shape
    N, P = pred.shape[1], pred.shape[2]
    TL = N + L
    dev, i32 = seq.device, torch.int32
    g, ma, mi = scores.gap_score, scores.match_score, scores.mismatch_score
    wi = torch.arange(W, device=dev)
    arP = torch.arange(P, device=dev)
    nc = node_count
    S = score_plane_torch(seq, order, rank, npred, base, pred, slen, nc,
                          alive, scores, band_width)

    # end cell: best sink at column slen, ties to the smallest rank
    act_r = torch.arange(N, device=dev)[None, :] < nc[:, None]
    sink = (padget_cols(nsucc, order, 1) == 0) & act_r
    val = S[wi, 1:, slen.clamp(0, L).long()]                     # (W, N)
    vmax = torch.where(sink, val, NEG).max(1).values
    r_end = (sink & (val == vmax[:, None])).to(i32).argmax(1).to(i32)
    band_ok = alive & (vmax > NEG // 2)

    pn = torch.full((W, TL), -2, dtype=i32, device=dev)
    pp = torch.full((W, TL), -2, dtype=i32, device=dev)
    r = torch.where(nc > 0, r_end, -1)
    j = slen.clone()
    k = torch.full((W,), TL, dtype=i32, device=dev)
    while True:
        going = band_ok & ((r >= 0) | (j > 0)) & (k > 0)
        if not bool(going.any()):
            break
        u = torch.where((r >= 0) & (r < N),
                        order[wi, r.clamp(0, N - 1).long()], -1)
        jc = j.clamp(0, L).long()
        here = S[wi, (r + 1).clamp(0, N).long(), jc]
        sc = padget_cols(seq, (j - 1)[:, None], -1)[:, 0]
        sub = torch.where((sc == padget_cols(base, u[:, None], -2)[:, 0])
                          & (sc >= 0), ma, mi)
        uc = u.clamp(0, N - 1).long()
        preds = torch.where((u >= 0)[:, None], pred[wi, uc], -1)
        nslots = torch.where(u >= 0, npred[wi, uc], 0)
        slot_ok = arP[None, :] < nslots[:, None]
        prow = torch.where(slot_ok, padget_cols(rank, preds, -1) + 1, -1)
        virt = (arP[None, :] == 0) & (nslots == 0)[:, None]
        prow = torch.where(virt, 0, prow)
        slot_ok = slot_ok | virt
        prc = prow.clamp(0, N).long()
        pv_jm1 = S[wi[:, None], prc, (j - 1).clamp(0, L).long()[:, None]]
        pv_j = S[wi[:, None], prc, jc[:, None]]
        diag_ok = slot_ok & (j > 0)[:, None] & (pv_jm1 + sub[:, None]
                                                == here[:, None])
        vert_ok = slot_ok & (pv_j + g == here[:, None])
        at_virtual = r < 0
        any_diag = diag_ok.any(1) & ~at_virtual
        any_vert = vert_ok.any(1) & ~at_virtual
        sel_d = diag_ok.to(i32).argmax(1)
        sel_v = vert_ok.to(i32).argmax(1)
        move = torch.where(at_virtual, 3, torch.where(
            any_diag, 0, torch.where(any_vert, 1, 3)))
        new_r = torch.where(move == 0, prow[wi, sel_d] - 1,
                            torch.where(move == 1, prow[wi, sel_v] - 1, r))
        new_j = torch.where((move == 0) | (move == 3), j - 1, j)
        node_e = torch.where(move == 3, -1, u)
        pos_e = torch.where(move == 1, -1, j - 1)
        k2 = k - 1
        gw = going.nonzero()[:, 0]
        pn[gw, k2[gw].long()] = node_e[gw].to(i32)
        pp[gw, k2[gw].long()] = pos_e[gw].to(i32)
        r = torch.where(going, new_r, r).to(i32)
        j = torch.where(going, new_j, j).to(i32)
        k = torch.where(going, k2, k)
    return pn, pp, k, band_ok


def graph_nw_traceback(seq, order, rank, npred, base, nsucc, pred, slen,
                       node_count, alive, scores: PoaScores,
                       band_width: int = 0):
    """Graph NW and traceback of one sequence per window.

    Args:
      seq: (W, L) int32 codes, -1 past slen.
      order, rank: (W, N) int32 from :func:`..poa_topsort.topsort`.
      npred, base, nsucc: (W, N) int32; pred (W, N, P) int32.
      slen, node_count: (W,) int32; alive: (W,) bool.
      scores: the match, mismatch and gap scores.
      band_width: 0 for the full DP, else the static band's width.

    The kernel's variant, ring depth and plane word come from
    :func:`nwtb_plan` and :func:`nwtb_word_bytes`; none changes a result.

    Returns:
      pn, pp: (W, N + L) int32 path; k0: (W,) int32 its first entry;
      band_ok: (W,) bool.
    """
    if seq.device.type == "cpu":
        return graph_nw_traceback_torch(seq, order, rank, npred, base, nsucc,
                                        pred, slen, node_count, alive, scores,
                                        band_width)
    _check(seq, order, rank, npred, base, nsucc, pred, slen, node_count,
           alive)
    if seq.device.type != "cuda":
        raise ValueError(f"no kernel for device {seq.device}")
    ins = tuple(t.contiguous() for t in (seq, order, rank, npred, base, nsucc,
                                         pred, slen, node_count))
    alive_i = alive.to(torch.int32)
    W, L = seq.shape
    N, P = pred.shape[1], pred.shape[2]
    word = nwtb_word_bytes(N, L, scores)
    variant, threads, ring = nwtb_plan(W, N, P, L, band_width, word)
    TL = N + L
    dev = seq.device
    pn = torch.empty((W, TL), dtype=torch.int32, device=dev)
    pp = torch.empty_like(pn)
    k0 = torch.empty(W, dtype=torch.int32, device=dev)
    band_ok = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return pn, pp, k0, band_ok.bool()
    plane = torch.empty((W, N + 1, L + 1), device=dev,
                        dtype=torch.int64 if word == 8 else torch.int32)
    lib = _build.load()
    with torch.cuda.device(dev), kernel_span(
            "poa_nwtb", ins + (alive, scores, band_width),
            W * N * (L + 1)):
        err = lib.cga_poa_nwtb(
            *(t.data_ptr() for t in ins), alive_i.data_ptr(),
            plane.data_ptr(), pn.data_ptr(), pp.data_ptr(), k0.data_ptr(),
            band_ok.data_ptr(), W, N, P, L, scores.match_score,
            scores.mismatch_score, scores.gap_score, band_width,
            int(variant == "block"), threads, ring,
            ring_width(L, band_width), word,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "poa_nwtb")
    return pn, pp, k0, band_ok.bool()
