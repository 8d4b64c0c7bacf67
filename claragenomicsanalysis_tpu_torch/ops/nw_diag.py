"""Banded global edit distance swept by anti-diagonal, with a 2-bit packed
traceback (counterpart of ``claragenomicsanalysis_tpu/ops/nw_diag_pallas.py``).

Cell (i, j) lies on anti-diagonal d = i + j, in half-band slot
u' = (j - i + r - par) / 2 with par = (d + r) & 1; the band |i - j| <= r is
u' <= r - par, and W = round_up(r + 1, 8) slots are kept per diagonal.
Every dependency of a cell points at diagonal d - 1 or d - 2, so the cells of
a diagonal are independent.  Move codes are AlignmentState values with the
package's tie-break (diagonal, then DELETION, else INSERTION), packed four
diagonals per byte into ``tb (Dpad / 4, B, W)`` int8,
``Dpad = round_up(Lq + Lt + 1, 16)`` — the same shapes as the JAX function,
so either package's traceback decodes with either package's decoder.

- :func:`banded_nw_diag` is the entry point.  For CUDA tensors it launches
  ``csrc/nw_diag.cu``, counts the launch in ``launch.nw_diag``
  (``utils.profiling.kernel_span``) and times it inside a
  ``utils.profiling.kernel_times()`` block; for CPU tensors it runs the
  plain version.
- :func:`banded_nw_diag_torch` is the plain PyTorch version, vectorised over
  the batch and the band with a Python loop over diagonals.
- :func:`traceback_paths_diag` decodes a traceback on the host with NumPy.

The kernel's plan comes from :func:`nw_diag_plan`: a warp a problem where
the band has at most 256 slots (K = 1 to 8 slots a lane, several
problems a block, q and t in shared memory where
:func:`nw_diag_stage_bytes` of them fit a block, else read through L1);
for wider bands a block a problem, which keeps its two diagonals, code
bytes, query and target in shared memory where :func:`nw_diag_smem_bytes`
fits a block (``_build.SMEM_PER_BLOCK``), and otherwise keeps the diagonals
and codes in a device scratch buffer of :func:`nw_diag_scratch_bytes` a
problem and reads the bases through L1.

A problem's diagonals end at ``round_up(qlen + tlen + 1, 4)``; the traceback
rows past that are zero.  Where ``|qlen - tlen| > r`` the score is INF and
the problem's traceback is not a path.
"""

import numpy as np
import torch

from ..core.status import AlignmentState
from ..utils.mathutils import round_up
from ..utils.profiling import kernel_span
from . import _build

#: score of a problem whose band cannot hold a global path (as ops/nw_band.py)
INF = 2**30


def band_slots(band_radius: int) -> int:
    """W: half-band slots per anti-diagonal."""
    return round_up(band_radius + 1, 8)


def padded_diagonals(Lq: int, Lt: int) -> int:
    """Dpad: diagonals covered by the traceback of a (Lq, Lt) batch."""
    return round_up(Lq + Lt + 1, 16)


def nw_diag_smem_bytes(Lq: int, Lt: int, band_radius: int) -> int:
    """Shared memory a block of the shared variant needs for a (Lq, Lt)
    batch at radius r: two int32 diagonals and a code byte a slot, then q
    and t."""
    return 9 * band_slots(band_radius) + Lq + Lt


#: the most slots a lane of the warp plan holds, and the problems a block of
#: it runs (one a warp)
WARP_SLOTS = 8
WARP_PROBLEMS = 4


def nw_diag_stage_bytes(Lq: int, Lt: int) -> int:
    """Shared memory one problem of the warp plan takes for its copy of q
    and t: each rounded up to 16 bytes, at least 16."""
    return max(round_up(Lq, 16), 16) + max(round_up(Lt, 16), 16)


def nw_diag_plan(Lq: int, Lt: int, band_radius: int) -> tuple:
    """-> (variant, K, problems) of a (Lq, Lt) batch at radius r.

    Where W = :func:`band_slots` is at most 32 x 8: a warp a problem, K the
    fewest slots a lane that cover W (``ceil(W / 32)``, 1 to 8),
    ``problems`` a block;
    ``"warp-shared"`` with the most problems (4, 2 or 1) whose copies of q
    and t fit a block, else ``"warp-device"`` (4 a block, q and t read
    through L1).  Wider bands: a block a problem (K = 0, problems = 1),
    ``"block-shared"`` where :func:`nw_diag_smem_bytes` fits a block, else
    ``"block-device"``."""
    W = band_slots(band_radius)
    if W <= 32 * WARP_SLOTS:
        K = -(-W // 32)
        stage = nw_diag_stage_bytes(Lq, Lt)
        for n in (WARP_PROBLEMS, 2, 1):
            if n * stage <= _build.SMEM_PER_BLOCK:
                return "warp-shared", K, n
        return "warp-device", K, WARP_PROBLEMS
    fits = nw_diag_smem_bytes(Lq, Lt, band_radius) <= _build.SMEM_PER_BLOCK
    return ("block-shared" if fits else "block-device"), 0, 1


def nw_diag_scratch_bytes(Lq: int, Lt: int, band_radius: int) -> int:
    """Device scratch one problem takes: 9W bytes (two int32 diagonals and a
    code byte a slot) for the block-device plan, 0 for the others."""
    if nw_diag_plan(Lq, Lt, band_radius)[0] != "block-device":
        return 0
    return 9 * band_slots(band_radius)


def _check(q, qlen, t, tlen, band_radius):
    if q.dim() != 2 or t.dim() != 2 or q.dtype != torch.int8 \
            or t.dtype != torch.int8:
        raise ValueError("q and t must be (B, L) int8 code tensors")
    B = q.shape[0]
    if t.shape[0] != B or qlen.shape != (B,) or tlen.shape != (B,) \
            or qlen.dtype != torch.int32 or tlen.dtype != torch.int32:
        raise ValueError("qlen and tlen must be (B,) int32 tensors")
    if len({x.device for x in (q, qlen, t, tlen)}) != 1:
        raise ValueError("q, qlen, t and tlen must be on one device")
    if band_radius < 0:
        raise ValueError(f"band_radius must be >= 0, got {band_radius}")


def banded_nw_diag_torch(q: torch.Tensor, qlen: torch.Tensor,
                         t: torch.Tensor, tlen: torch.Tensor,
                         band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`banded_nw_diag`: the same outputs,
    computed with tensor ops on the tensors' own device."""
    _check(q, qlen, t, tlen, band_radius)
    B, Lq = q.shape
    Lt = t.shape[1]
    r = band_radius
    W = band_slots(r)
    Dpad = padded_diagonals(Lq, Lt)
    dev = q.device
    i32 = torch.int32
    # one -1 column past the end: out-of-range bases read it
    pad = torch.full((B, 1), -1, dtype=i32, device=dev)
    qx = torch.cat([q.to(i32), pad], 1)
    tx = torch.cat([t.to(i32), pad], 1)
    ql = qlen[:, None]
    tl = tlen[:, None]
    u = torch.arange(W, dtype=i32, device=dev)
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)
    prev1 = torch.full((B, W), INF, dtype=i32, device=dev)
    prev2 = prev1.clone()
    acc = torch.zeros((B, W), dtype=i32, device=dev)
    sacc = torch.zeros(B, dtype=torch.int64, device=dev)
    tb = torch.zeros((Dpad // 4, B, W), dtype=torch.uint8, device=dev)
    d_end = ((qlen.to(torch.int64) + tlen + 4) // 4 * 4).clamp(0, Dpad)

    for d in range(int(d_end.max()) if B else 0):
        par = (d + r) & 1
        i = (d + r) // 2 - u
        j = d - i
        qidx = torch.where((i >= 1) & (i <= Lq), i - 1, Lq).long()
        tidx = torch.where((j >= 1) & (j <= Lt), j - 1, Lt).long()
        qc = qx[:, qidx]
        tc = tx[:, tidx]
        sub = ((qc != tc) | (qc < 0)).to(i32)
        if par:
            up = torch.cat([prev1[:, 1:], inf_col], 1)
            left = prev1
        else:
            up = prev1
            left = torch.cat([inf_col, prev1[:, :-1]], 1)
        diag = prev2 + sub
        cur = torch.minimum(diag, torch.minimum(up, left) + 1)
        cur = torch.where(i == 0, j, cur)
        valid = ((i >= 0) & (i <= ql) & (j >= 0) & (j <= tl)
                 & (u <= r - par))
        cur = torch.where(valid, cur, INF)
        code = torch.where(
            cur == diag, sub,
            torch.where(cur == left + 1, int(AlignmentState.DELETION),
                        int(AlignmentState.INSERTION)))
        acc |= code << (2 * (d & 3))
        if d & 3 == 3:
            tb[d >> 2] = acc.to(torch.uint8)
            acc.zero_()
        sacc += torch.where(valid & (i == ql) & (j == tl), cur, 0).sum(1)
        prev2, prev1 = prev1, cur

    rows = torch.arange(Dpad // 4, device=dev)[:, None]
    tb.masked_fill_((rows >= (d_end // 4)[None, :])[:, :, None], 0)
    band_ok = (qlen - tlen).abs() <= r
    scores = torch.where(band_ok, sacc, INF).to(i32)
    return scores, tb.view(torch.int8)


def banded_nw_diag(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor,
                   tlen: torch.Tensor,
                   band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched banded NW, anti-diagonal sweep.

    Args:
      q: (B, Lq) int8 base codes, -1 PAD (and N) past qlen.
      qlen, tlen: (B,) int32 lengths, 0 <= qlen <= Lq, 0 <= tlen <= Lt.
      t: (B, Lt) int8 codes.
      band_radius: r, the band |i - j| <= r; any value a caller's bucket
        makes.

    The kernel's plan comes from :func:`nw_diag_plan`; none changes a
    result.

    Returns:
      scores: (B,) int32 edit distances, INF where |qlen - tlen| > r.
      tb: (Dpad / 4, B, W) int8 traceback on the inputs' device.
    """
    if q.device.type == "cpu":
        return banded_nw_diag_torch(q, qlen, t, tlen, band_radius)
    _check(q, qlen, t, tlen, band_radius)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    q, qlen, t, tlen = (x.contiguous() for x in (q, qlen, t, tlen))
    B, Lq = q.shape
    Lt = t.shape[1]
    W = band_slots(band_radius)
    Dpad = padded_diagonals(Lq, Lt)
    scores = torch.empty(B, dtype=torch.int32, device=q.device)
    tb = torch.empty((Dpad // 4, B, W), dtype=torch.int8, device=q.device)
    if B == 0:
        return scores, tb
    variant, K, problems = nw_diag_plan(Lq, Lt, band_radius)
    per = nw_diag_scratch_bytes(Lq, Lt, band_radius)
    scratch = torch.empty(B * per if per else 0, dtype=torch.uint8,
                          device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device), kernel_span(
            "nw_diag", (q, qlen, t, tlen, band_radius), B * Dpad * W):
        err = lib.cga_nw_diag(
            q.data_ptr(), qlen.data_ptr(), t.data_ptr(), tlen.data_ptr(),
            scores.data_ptr(), tb.data_ptr(),
            scratch.data_ptr() if per else None, B, Lq, Lt, band_radius, W,
            Dpad, K, problems, int(variant.endswith("shared")),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "nw_diag")
    return scores, tb


def traceback_paths_diag(tb: np.ndarray, qlen: np.ndarray, tlen: np.ndarray,
                         band_radius: int) -> list[list[int]]:
    """Host decode of the anti-diagonal traceback into edit paths: forward
    AlignmentState code lists, row 0 a pure deletion tail.  The bytes are
    read as uint8 so the shifts are logical."""
    tb = np.asarray(tb).view(np.uint8)
    qlen = np.asarray(qlen).astype(np.int64)
    tlen = np.asarray(tlen).astype(np.int64)
    B = tb.shape[1]
    r = band_radius
    i = qlen.copy()
    j = tlen.copy()
    max_steps = int((qlen + tlen).max()) if B else 0
    code_mat = np.zeros((max_steps, B), dtype=np.uint8)
    act_mat = np.zeros((max_steps, B), dtype=bool)
    active = (i > 0) | (j > 0)
    for s in range(max_steps):
        if not active.any():
            break
        read = active & (i > 0)
        d = i + j
        par = (d + r) & 1
        lanes = np.clip((j - i + r - par) >> 1, 0, tb.shape[2] - 1)
        rows = np.clip(d >> 2, 0, tb.shape[0] - 1)
        byte = tb[rows[read], np.nonzero(read)[0], lanes[read]]
        code = np.zeros(B, dtype=np.uint8)
        code[read] = (byte >> (2 * (d[read] & 3)).astype(np.uint8)) & 3
        code[active & (i == 0)] = AlignmentState.DELETION
        code_mat[s] = code
        act_mat[s] = active
        i -= (active & (code != AlignmentState.DELETION)).astype(np.int64)
        j -= (active & (code != AlignmentState.INSERTION)).astype(np.int64)
        active = (i > 0) | (j > 0)
    return [code_mat[act_mat[:, b], b][::-1].tolist() for b in range(B)]
