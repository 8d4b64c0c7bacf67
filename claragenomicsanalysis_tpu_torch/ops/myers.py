"""Batched Myers bit-vector edit distance, Hyyrö's blocked formulation
(counterpart of ``claragenomicsanalysis_tpu/ops/myers.py`` and of its TPU
kernel ``ops/myers_pallas.py``).

The query is cut into 32-base words; word w of column j holds the vertical
deltas of DP rows 32w+1 .. 32w+32 as two bit masks, Pv (+1) and Mv (-1).
Column j's update of word w needs word w's state after column j - 1 and the
horizontal delta ``hin`` that word w - 1 hands up in column j, so the
(word, column) cells of one anti-diagonal s = w + j are independent: both
versions below sweep that wavefront, Lt + Wq - 1 steps.  The bottom-row
delta of column j is bit (qlen - 1) % 32 of word (qlen - 1) // 32's
pre-shift Ph / Mh; no word above that one affects it.

``myers_bottom_row(q, qlen, t, tlen) -> (rows, scores)``:

- ``rows (B, Lt + 1)`` int32, ``rows[b, j] = D[qlen_b, j]`` for every column,
  those past ``tlen_b`` included (the target is the whole row of ``t``);
  ``rows[:, 0] = qlen``, and a query of length 0 gives ``rows[b, j] = j``;
- ``scores (B,)`` int32, ``rows[b, tlen_b]``;
- a negative code (PAD or N) matches nothing, on either side.

For CUDA tensors the wrapper launches ``csrc/myers.cu``, counts the launch in
``myers_bottom_row.launches`` and times it inside a
``utils.profiling.kernel_times()`` block; for CPU tensors it runs
:func:`myers_bottom_row_torch`, the plain version, which carries the 32-bit
words as int64 and masks to 32 bits after every ``+``, ``<<`` and ``~``
(torch has no ``>>`` for uint32 on the CPU).
"""

import torch

from ..utils.profiling import kernel_span
from . import _build

WORD = 32
_M32 = 0xFFFFFFFF
#: longest query the kernel takes, in words: 4 words a thread, 1024 threads
#: a block (131,072 bases)
MAX_WORDS = 4 * 1024


def num_words(max_query_length: int) -> int:
    """Wq: 32-base words of a (B, Lq) query batch (at least one)."""
    return max(1, -(-max_query_length // WORD))


def build_peq(q: torch.Tensor, Wq: int) -> torch.Tensor:
    """Peq[b, w, sigma]: bit p set iff q[b, 32w + p] == sigma, as int64
    holding 32-bit words; sigma = 4 is an all-zero plane for negative
    codes.  (B, Wq, 5)."""
    B, Lq = q.shape
    qp = torch.full((B, Wq * WORD), -1, dtype=torch.int64, device=q.device)
    qp[:, :Lq] = q
    qw = qp.view(B, Wq, WORD)
    bits = torch.ones(WORD, dtype=torch.int64, device=q.device) \
        << torch.arange(WORD, device=q.device)
    sigma = torch.arange(5, device=q.device)
    return ((qw[..., None] == sigma) * bits[:, None]).sum(2)


def _check(q, qlen, t, tlen):
    if q.dim() != 2 or t.dim() != 2 or q.dtype != torch.int8 \
            or t.dtype != torch.int8:
        raise ValueError("q and t must be (B, L) int8 code tensors")
    B = q.shape[0]
    if t.shape[0] != B or qlen.shape != (B,) or tlen.shape != (B,) \
            or qlen.dtype != torch.int32 or tlen.dtype != torch.int32:
        raise ValueError("qlen and tlen must be (B,) int32 tensors")
    if len({x.device for x in (q, qlen, t, tlen)}) != 1:
        raise ValueError("q, qlen, t and tlen must be on one device")


def myers_bottom_row_torch(q: torch.Tensor, qlen: torch.Tensor,
                           t: torch.Tensor, tlen: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`myers_bottom_row`: the (word,
    column) wavefront, vectorised over the batch and the words."""
    _check(q, qlen, t, tlen)
    B, Lq = q.shape
    Lt = t.shape[1]
    Wq = num_words(Lq)
    dev = q.device
    i64 = torch.int64
    peq = build_peq(q, Wq)
    # one PAD column past the end: words outside the wavefront read it
    tx = torch.cat([t.to(i64), torch.full((B, 1), -1, dtype=i64,
                                          device=dev)], 1)
    ql = qlen.to(i64)
    wlast = (ql - 1).clamp(min=0) // WORD
    bit_last = (ql - 1).clamp(min=0) % WORD
    barange = torch.arange(B, device=dev)
    w = torch.arange(Wq, device=dev)
    Pv = torch.full((B, Wq), _M32, dtype=i64, device=dev)
    Mv = torch.zeros((B, Wq), dtype=i64, device=dev)
    # horizontal deltas each word handed up in the previous step, as 0/1
    up_pos = torch.zeros((B, Wq), dtype=i64, device=dev)
    up_neg = torch.zeros((B, Wq), dtype=i64, device=dev)
    ones = torch.ones((B, 1), dtype=i64, device=dev)  # D[0,j]-D[0,j-1] = +1
    score = ql.clone()
    rows = torch.empty((B, Lt + 1), dtype=i64, device=dev)
    rows[:, 0] = ql

    for s in range(Lt + Wq - 1):
        j = s - w                                     # column of each word
        live = (j >= 0) & (j < Lt)
        c = tx[:, torch.where(live, j, Lt)]           # (B, Wq)
        eq = peq.gather(2, torch.where(c >= 0, c, 4)[..., None])[..., 0]
        hp = torch.cat([ones, up_pos[:, :-1]], 1)
        hn = torch.cat([ones - 1, up_neg[:, :-1]], 1)
        eq2 = eq | hn
        xv = eq | Mv
        xh = ((((eq2 & Pv) + Pv) & _M32) ^ Pv) | eq2
        ph = Mv | (~(xh | Pv) & _M32)
        mh = Pv & xh
        up_pos = ph >> (WORD - 1)
        up_neg = mh >> (WORD - 1)
        # the bottom row: the last word's column moves one step
        jl = s - wlast
        d = (((ph[barange, wlast] >> bit_last) & 1)
             - ((mh[barange, wlast] >> bit_last) & 1))
        at = (jl >= 0) & (jl < Lt)
        score = torch.where(at, score + d, score)
        rows[barange[at], jl[at] + 1] = score[at]
        ph = ((ph << 1) & _M32) | hp
        mh = ((mh << 1) & _M32) | hn
        Pv = torch.where(live, mh | (~(xv | ph) & _M32), Pv)
        Mv = torch.where(live, ph & xv, Mv)

    rows = torch.where((ql == 0)[:, None],
                       torch.arange(Lt + 1, device=dev), rows).to(torch.int32)
    scores = rows.gather(1, tlen.long().clamp(0, Lt)[:, None])[:, 0]
    return rows, scores


def myers_bottom_row(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor,
                     tlen: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bottom DP rows and edit distances of a batch (see the module
    docstring).

    Args:
      q: (B, Lq) int8 base codes, -1 PAD (and N) past qlen.
      qlen, tlen: (B,) int32 lengths, 0 <= qlen <= Lq, 0 <= tlen <= Lt.
      t: (B, Lt) int8 codes.

    Returns ``rows (B, Lt + 1)`` int32 and ``scores (B,)`` int32 on the
    inputs' device.
    """
    if q.device.type == "cpu":
        return myers_bottom_row_torch(q, qlen, t, tlen)
    _check(q, qlen, t, tlen)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Lq = q.shape
    Lt = t.shape[1]
    Wq = num_words(Lq)
    if Wq > MAX_WORDS:
        raise ValueError(f"query length {Lq} > {MAX_WORDS * WORD}, the "
                         f"longest the myers kernel takes")
    q, qlen, t, tlen = (x.contiguous() for x in (q, qlen, t, tlen))
    rows = torch.empty((B, Lt + 1), dtype=torch.int32, device=q.device)
    scores = torch.empty(B, dtype=torch.int32, device=q.device)
    if B == 0:
        return rows, scores
    lib = _build.load()
    with torch.cuda.device(q.device), kernel_span(
            "myers", (q, qlen, t, tlen), B * Wq * Lt):
        err = lib.cga_myers(
            q.data_ptr(), qlen.data_ptr(), t.data_ptr(), tlen.data_ptr(),
            rows.data_ptr(), scores.data_ptr(), B, Lq, Lt, Wq,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "myers")
    myers_bottom_row.launches += 1
    return rows, scores


myers_bottom_row.launches = 0
