"""Decode anti-diagonal tracebacks on the device (counterpart of
``claragenomicsanalysis_tpu/ops/tb_decode_pallas.py`` with ``diag=True``).

Each problem's walk starts at (qlen, tlen) and follows the 2-bit codes of the
``tb (Dpad / 4, B, W)`` array that :func:`ops.nw_diag.banded_nw_diag` wrote,
back to (0, 0).  The path leaves the device packed: ``packed (B, TL / 16)``
int32 holds 16 codes per word, written backwards from slot TL, and
``start (B,)`` int32 is the slot of the first move, with
``TL = round_up(Dpad + 8, 2048)`` — the JAX function's arrays, value for
value.  Lane and row are clipped to the array, so a problem with an INF score
walks bounded garbage; callers drop it by status.

- :func:`decode_diag` launches ``csrc/tb_decode.cu`` for CUDA tensors,
  counts the launch in ``decode_diag.launches`` and times it inside a
  ``utils.profiling.kernel_times()`` block; for CPU tensors it runs the
  plain version.
- :func:`decode_diag_torch` is the plain PyTorch version: the batch walks in
  lockstep, one tensor step per move.
- :func:`traceback_paths_device` returns the paths as code lists.
"""

import numpy as np
import torch

from ..core.status import AlignmentState
from ..utils.mathutils import round_up
from ..utils.profiling import kernel_span
from . import _build


def path_slots(tb_rows: int) -> int:
    """TL: path slots per problem for a traceback of ``tb_rows`` rows (one
    row is four diagonals; a global path has fewer moves than diagonals)."""
    return round_up(4 * tb_rows + 8, 2048)


def _check(tb, qlen, tlen):
    if tb.dim() != 3 or tb.dtype != torch.int8:
        raise ValueError("tb must be a (Dpad / 4, B, W) int8 tensor")
    B = tb.shape[1]
    if qlen.shape != (B,) or tlen.shape != (B,) \
            or qlen.dtype != torch.int32 or tlen.dtype != torch.int32:
        raise ValueError("qlen and tlen must be (B,) int32 tensors")
    if len({x.device for x in (tb, qlen, tlen)}) != 1:
        raise ValueError("tb, qlen and tlen must be on one device")


def decode_diag_torch(tb: torch.Tensor, qlen: torch.Tensor,
                      tlen: torch.Tensor,
                      band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`decode_diag`."""
    _check(tb, qlen, tlen)
    R4, B, W = tb.shape
    TL = path_slots(R4)
    r = band_radius
    dev = tb.device
    tbu = tb.view(torch.uint8)
    b = torch.arange(B, device=dev)
    i = qlen.long()
    j = tlen.long()
    k = torch.full((B,), TL, dtype=torch.int64, device=dev)
    # int64 words; folded to int32 bit patterns at the end
    packed = torch.zeros((B, TL // 16), dtype=torch.int64, device=dev)
    while True:
        active = ((i > 0) | (j > 0)) & (k > 0)
        if not bool(active.any()):
            break
        d = i + j
        par = (d + r) & 1
        lane = ((r + j - i - par) >> 1).clamp(0, W - 1)
        row = (d >> 2).clamp(0, R4 - 1)
        code = (tbu[row, b, lane].long() >> (2 * (d & 3))) & 3
        code = torch.where(i == 0, int(AlignmentState.DELETION), code)
        k = torch.where(active, k - 1, k)
        ba, ka = b[active], k[active]
        packed[ba, ka >> 4] |= code[active] << (2 * (ka & 15))
        i = i - (active & (code != AlignmentState.DELETION)).long()
        j = j - (active & (code != AlignmentState.INSERTION)).long()
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32), k.to(torch.int32)


def decode_diag(tb: torch.Tensor, qlen: torch.Tensor, tlen: torch.Tensor,
                band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk every problem's traceback on the tensors' device.

    Returns ``packed (B, TL / 16)`` int32 and ``start (B,)`` int32 (see the
    module docstring).
    """
    if tb.device.type == "cpu":
        return decode_diag_torch(tb, qlen, tlen, band_radius)
    _check(tb, qlen, tlen)
    if tb.device.type != "cuda":
        raise ValueError(f"no kernel for device {tb.device}")
    tb, qlen, tlen = (x.contiguous() for x in (tb, qlen, tlen))
    R4, B, W = tb.shape
    TL = path_slots(R4)
    packed = torch.zeros((B, TL // 16), dtype=torch.int32, device=tb.device)
    start = torch.empty(B, dtype=torch.int32, device=tb.device)
    if B == 0:
        return packed, start
    lib = _build.load()
    with torch.cuda.device(tb.device), kernel_span(
            "tb_decode", (tb, qlen, tlen, band_radius), B * TL):
        err = lib.cga_tb_decode_diag(
            tb.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            packed.data_ptr(), start.data_ptr(), B, R4, W, band_radius, TL,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "tb_decode")
    decode_diag.launches += 1
    return packed, start


decode_diag.launches = 0


def unpack_paths(packed: np.ndarray, start: np.ndarray) -> list[list[int]]:
    """Host side: 16 2-bit codes per int32 word -> one code list per row,
    from its start slot on."""
    pw = np.ascontiguousarray(packed).view(np.uint32)
    shifts = 2 * np.arange(16, dtype=np.uint32)
    codes = ((pw[:, :, None] >> shifts) & 3).astype(np.uint8)
    codes = codes.reshape(pw.shape[0], -1)
    return [codes[b, int(s):].tolist() for b, s in enumerate(start)]


def traceback_paths_device(tb: torch.Tensor, qlen: torch.Tensor,
                           tlen: torch.Tensor,
                           band_radius: int) -> list[list[int]]:
    """Decode on the device; only the packed path words are copied to the
    host, from the word of the earliest start on (the words before it are
    zero in every row).  Returns forward AlignmentState code lists, one per
    problem."""
    packed, start = decode_diag(tb, qlen, tlen, band_radius)
    start = start.cpu().numpy()
    first = int(start.min()) // 16 if len(start) else 0
    return unpack_paths(packed[:, first:].cpu().numpy(), start - 16 * first)
