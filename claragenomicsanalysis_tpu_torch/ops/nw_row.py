"""Banded global edit distance swept by query row, with a 2-bit packed
traceback (counterpart of ``claragenomicsanalysis_tpu/ops/nw_band_pallas.py``).

Row i (1..Lq) keeps W = round_up(2r + 1, 8) band lanes; lane k holds cell
(i, j = i + k - r), so the band |i - j| <= r is k <= 2r.  A cell depends on
the row above (diagonal at lane k, up at lane k + 1) and on its left
neighbour in the same row: the deletion chain is a min-plus prefix over the
lanes, ``cur[k] = k + min_{l <= k}(tmp[l] - l)``.  Move codes are
AlignmentState values with the package's tie-break (diagonal, then
DELETION, else INSERTION), packed four rows per byte into
``tb (round_up(Lq, 16) / 4, B, W)`` int8, row i at bits ``2 * ((i - 1) % 4)``
of row ``(i - 1) // 4`` — the JAX function's array, so either package's
traceback decodes with either package's decoder.  The DP is int32 with
``INF = 2^30`` and no saturation, as in the JAX kernel.

- :func:`banded_nw_row` is the entry point.  For CUDA tensors it launches
  ``csrc/nw_row.cu``, counts the launch in ``launch.nw_row``
  (``utils.profiling.kernel_span``) and times it inside a
  ``utils.profiling.kernel_times()`` block; for CPU tensors it runs the
  plain version.
- :func:`banded_nw_row_torch` is the plain PyTorch version, vectorised over
  the batch and the band with a Python loop over rows.

The kernel's plan comes from :func:`nw_row_plan`: a warp a problem where
the row has at most 256 band lanes (K = 1 to 8 lanes a thread in
registers, several problems a block, q and t in shared memory where
:func:`..nw_diag.nw_diag_stage_bytes` of them fit a block, else read
through L1); for wider bands a block a problem, which keeps its row, query
and target in shared memory where :func:`nw_row_smem_bytes` fits a block
(``_build.SMEM_PER_BLOCK``), and otherwise keeps the row in a device
scratch buffer (``4 (W + 1)`` bytes a problem) and reads the bases through
L1; a thread of it owns ``cpt x groups`` contiguous lanes, so no band width
is refused.

A problem's rows end at ``round_up(qlen, 4)``; the traceback rows past that
are zero.  Where ``|qlen - tlen| > r`` the score is INF and the problem's
traceback is not a path.
"""

import torch

from ..core.status import AlignmentState
from ..utils.mathutils import round_up
from ..utils.profiling import kernel_span
from . import _build
from .nw_diag import (INF, WARP_PROBLEMS, WARP_SLOTS, _check,
                      nw_diag_stage_bytes)


def band_width_row(band_radius: int) -> int:
    """W: band lanes per query row."""
    return round_up(2 * band_radius + 1, 8)


def tb_rows(Lq: int) -> int:
    """Packed traceback rows of a batch of padded query length Lq (four DP
    rows per byte, the query padded to 16 as the JAX kernel pads it)."""
    return round_up(Lq, 16) // 4


#: lanes a thread owns in one lane group, at most (the widest instance of
#: the kernel), and threads a block
MAX_CPT, MAX_THREADS = 8, 1024


def nw_row_smem_bytes(Lq: int, Lt: int, band_radius: int) -> int:
    """Shared memory a block of the shared variant needs for a (Lq, Lt)
    batch at radius r: the row (W + 1 int32), the 32 warp totals, q and t."""
    return 4 * (band_width_row(band_radius) + 1) + 4 * 32 + Lq + Lt


def nw_row_plan(Lq: int, Lt: int, band_radius: int) -> tuple:
    """-> (variant, lanes a thread, problems or lane groups, threads) of a
    (Lq, Lt) batch at radius r.

    Where W = :func:`band_width_row` is at most 32 x 8: a warp a problem, K
    the fewest band lanes a thread that cover W (``ceil(W / 32)``, 1 to 8),
    ``problems`` a block; ``"warp-shared"`` with the most problems (4, 2 or
    1) whose copies of q and t (:func:`..nw_diag.nw_diag_stage_bytes`) fit
    a block, else ``"warp-device"`` (4 a block, q and t read through L1).
    Wider bands: a block a problem, ``"block-shared"`` where
    :func:`nw_row_smem_bytes` fits a block and W is at most MAX_CPT x
    MAX_THREADS (the shared variant keeps a lane's codes in registers, one
    lane group), else ``"block-device"``; a thread owns ``cpt x groups``
    contiguous lanes: cpt is the least power of two up to MAX_CPT that
    covers W with MAX_THREADS threads; the device variant adds lane groups
    of MAX_CPT past that."""
    W = band_width_row(band_radius)
    if W <= 32 * WARP_SLOTS:
        K = -(-W // 32)
        stage = nw_diag_stage_bytes(Lq, Lt)
        for n in (WARP_PROBLEMS, 2, 1):
            if n * stage <= _build.SMEM_PER_BLOCK:
                return "warp-shared", K, n, 32 * n
        return "warp-device", K, WARP_PROBLEMS, 32 * WARP_PROBLEMS
    shared = (nw_row_smem_bytes(Lq, Lt, band_radius) <= _build.SMEM_PER_BLOCK
              and W <= MAX_CPT * MAX_THREADS)
    cpt = 1
    while cpt < MAX_CPT and cpt * MAX_THREADS < W:
        cpt *= 2
    groups = -(-W // (cpt * MAX_THREADS))
    threads = round_up(-(-W // (cpt * groups)), 32)
    return ("block-shared" if shared else "block-device"), cpt, groups, \
        threads


def nw_row_scratch_bytes(Lq: int, Lt: int, band_radius: int) -> int:
    """Device scratch one problem takes: its row, 4 (W + 1) bytes, for the
    block-device plan; 0 for the others."""
    if nw_row_plan(Lq, Lt, band_radius)[0] != "block-device":
        return 0
    return 4 * (band_width_row(band_radius) + 1)


def banded_nw_row_torch(q: torch.Tensor, qlen: torch.Tensor,
                        t: torch.Tensor, tlen: torch.Tensor,
                        band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`banded_nw_row`: the same outputs,
    computed with tensor ops on the tensors' own device."""
    _check(q, qlen, t, tlen, band_radius)
    B, Lq = q.shape
    Lt = t.shape[1]
    r = band_radius
    W = band_width_row(r)
    R4 = tb_rows(Lq)
    dev = q.device
    i32 = torch.int32
    k = torch.arange(W, dtype=i32, device=dev)
    delta = k - r                                    # j - i per lane
    in_band = k <= 2 * r
    ql = qlen[:, None]
    tl = tlen[:, None]
    # t with a -1 column past the end: out-of-range bases read it
    tx = torch.cat([t.to(i32), torch.full((B, 1), -1, dtype=i32,
                                          device=dev)], 1)
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)
    prev = torch.where((delta >= 0) & (delta <= tl) & in_band, delta, INF)
    final = prev.clone()                             # row 0: qlen == 0
    acc = torch.zeros((B, W), dtype=i32, device=dev)
    tb = torch.zeros((R4, B, W), dtype=torch.uint8, device=dev)
    rows_end = (qlen.to(torch.int64) + 3) // 4 * 4   # rows each problem needs

    for i in range(1, int(rows_end.max()) + 1 if B else 1):
        jv = i + delta
        valid = (jv >= 0) & (jv <= tl) & (i <= ql) & in_band
        qc = (q[:, i - 1].to(i32) if i <= Lq
              else torch.full((B,), -1, dtype=i32, device=dev))[:, None]
        tidx = torch.where((jv >= 1) & (jv <= Lt), jv - 1, Lt).long()
        tc = tx[:, tidx]
        sub = ((qc != tc) | (qc < 0)).to(i32)
        up = torch.cat([prev[:, 1:], inf_col], 1)
        diag = prev + sub
        tmp = torch.minimum(diag, up + 1)
        tmp = torch.where(jv == 0, i, tmp)
        tmp = torch.where(valid, tmp, INF)
        c = torch.cummin(tmp - k, 1).values
        cur = torch.where(valid, c + k, INF)
        left = torch.cat([inf_col, cur[:, :-1]], 1)
        code = torch.where(
            cur == diag, sub,
            torch.where(cur == left + 1, int(AlignmentState.DELETION),
                        int(AlignmentState.INSERTION)))
        acc |= code << (2 * ((i - 1) & 3))
        if (i - 1) & 3 == 3:
            tb[(i - 1) >> 2] = acc.to(torch.uint8)
            acc.zero_()
        final = torch.where(i == ql, cur, final)
        prev = cur

    rows = torch.arange(R4, device=dev)[:, None]
    tb.masked_fill_((rows >= (rows_end // 4)[None, :])[:, :, None], 0)
    lane = (r + tlen - qlen).long()
    hit = final.gather(1, lane.clamp(0, W - 1)[:, None])[:, 0]
    band_ok = (qlen - tlen).abs() <= r
    scores = torch.where(band_ok, hit, INF).to(i32)
    return scores, tb.view(torch.int8)


def banded_nw_row(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor,
                  tlen: torch.Tensor,
                  band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched banded NW, query-row sweep.

    Args:
      q: (B, Lq) int8 base codes, -1 PAD (and N) past qlen.
      qlen, tlen: (B,) int32 lengths, 0 <= qlen <= Lq, 0 <= tlen <= Lt.
      t: (B, Lt) int8 codes.
      band_radius: r, the band |i - j| <= r.

    Returns:
      scores: (B,) int32 edit distances, INF where |qlen - tlen| > r.
      tb: (round_up(Lq, 16) / 4, B, W) int8 traceback on the inputs'
        device.
    """
    if q.device.type == "cpu":
        return banded_nw_row_torch(q, qlen, t, tlen, band_radius)
    _check(q, qlen, t, tlen, band_radius)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    q, qlen, t, tlen = (x.contiguous() for x in (q, qlen, t, tlen))
    B, Lq = q.shape
    Lt = t.shape[1]
    W = band_width_row(band_radius)
    R4 = tb_rows(Lq)
    scores = torch.empty(B, dtype=torch.int32, device=q.device)
    tb = torch.empty((R4, B, W), dtype=torch.int8, device=q.device)
    if B == 0:
        return scores, tb
    variant, lanes, n, _ = nw_row_plan(Lq, Lt, band_radius)
    warp = variant.startswith("warp")
    per = nw_row_scratch_bytes(Lq, Lt, band_radius)
    scratch = torch.empty(B * per // 4, dtype=torch.int32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device), kernel_span(
            "nw_row", (q, qlen, t, tlen, band_radius), B * 4 * R4 * W):
        err = lib.cga_nw_row(
            q.data_ptr(), qlen.data_ptr(), t.data_ptr(), tlen.data_ptr(),
            scores.data_ptr(), tb.data_ptr(),
            scratch.data_ptr() if variant == "block-device" else None, B,
            Lq, Lt, band_radius, W, R4, lanes if warp else 0,
            0 if warp else lanes, n, int(variant.endswith("shared")),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "nw_row")
    return scores, tb
