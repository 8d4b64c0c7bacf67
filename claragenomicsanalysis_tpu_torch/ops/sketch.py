"""Minimizer sketching as torch ops (counterpart of
``claragenomicsanalysis_tpu/ops/sketch.py``; the JAX package runs it as
plain XLA, so it has no hand-written kernel here either).

For the whole (B, L) read batch at once:

- forward / reverse-complement k-mer values as one 2k-bit int64 word each
  (k <= 31), by k shifted slices;
- central minimizers via the closed form  rep[p] == max over the w window
  minima that contain p;
- prefix / suffix end-minimizers via running minima, exact because
  positions past each read's end hold the INVALID sentinel.

Torch has no ``>>``, ``searchsorted`` or ``cummax`` for uint32 on the CPU,
so the 32-bit values travel as int64 in [0, 2^32): ``INVALID = 0xFFFFFFFF``
stays the largest value, as in uint32.  The hash never lets a product leave
int64 (``_mul32``) and masks to 32 bits before every shift, so no sign bit
is ever shifted in.
"""

import torch

INVALID = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x and c in [0, 2^32), in two 16-bit
    halves of x so that no product passes 2^48 (a product of two 32-bit
    values would overflow int64)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def murmur32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 on int64 values in [0, 2^32): the uint32 result of
    the JAX package's ``murmur32``, as int64."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def sketch_batch(reads: torch.Tensor, lens: torch.Tensor, k: int, w: int,
                 hash_reps: bool = True):
    """Minimizers of a (B, L) int8 batch of encoded reads (-1 = N or pad)
    with lengths ``lens``, on the reads' device.

    Returns (rep (B, Lk) int64 in [0, 2^32) with INVALID at non-k-mers,
    dirs (B, Lk) int32, is_min (B, Lk) bool), Lk = L - k + 1: the arrays
    of the JAX package's ``sketch_batch`` on the same inputs."""
    B, L = reads.shape
    Lk = L - k + 1
    if Lk < 1:
        raise ValueError("reads shorter than k")
    dev = reads.device
    codes = reads.to(torch.int64)
    lens = lens.to(device=dev, dtype=torch.int64)

    # a 2k-bit k-mer fits one int64 word (k <= 31); its low and high 32
    # bits are the JAX package's (lo, hi) uint32 pair
    f = torch.zeros((B, Lk), dtype=torch.int64, device=dev)
    r = torch.zeros((B, Lk), dtype=torch.int64, device=dev)
    valid = torch.ones((B, Lk), dtype=torch.bool, device=dev)
    for i in range(k):
        c = codes[:, i: i + Lk]
        valid &= c >= 0
        cpos = c.clamp(min=0)
        f |= cpos << (2 * (k - 1 - i))
        r |= (3 - cpos) << (2 * i)

    pos = torch.arange(Lk, device=dev)[None, :]
    n = (lens - k + 1)[:, None]                   # k-mers per read
    valid &= pos < n

    f_gt_r = f > r
    c = torch.where(f_gt_r, r, f)
    dirs = f_gt_r.to(torch.int32)
    lo = c & MASK32
    # murmur32(0) == 0, so for k <= 15 this equals murmur32(c)
    rep = murmur32(lo ^ murmur32(c >> 32)) if hash_reps else lo
    rep = torch.where(valid, rep, INVALID)

    # central minimizers
    if Lk >= w:
        # window minima (window starting at i) ...
        wm = torch.nn.functional.pad(rep, (0, w - 1), value=INVALID)
        wm = wm.unfold(1, w, 1).amin(dim=2)
        # ... valid iff 0 <= i <= n - w; 0 is the identity of the max
        wm = torch.where(pos <= n - w, wm, 0)
        cmax = torch.nn.functional.pad(wm, (w - 1, 0), value=0)
        cmax = cmax.unfold(1, w, 1).amax(dim=2)   # max over [p-w+1, p]
        central = (rep == cmax) & (n >= w)
    else:
        central = torch.zeros((B, Lk), dtype=torch.bool, device=dev)

    cmin = torch.cummin(rep, dim=1).values
    rmin = torch.cummin(rep.flip(1), dim=1).values.flip(1)
    pre = (rep == cmin) & (pos <= w - 2)
    suf = (rep == rmin) & (pos >= n - w + 1)

    is_min = valid & (central | pre | suf)
    return rep, dirs, is_min
