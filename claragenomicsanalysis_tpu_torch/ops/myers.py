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
``launch.myers`` and times it inside a
``utils.profiling.kernel_times()`` block; for CPU tensors it runs
:func:`myers_bottom_row_torch`, the plain version, which carries the 32-bit
words as int64 and masks to 32 bits after every ``+``, ``<<`` and ``~``
(torch has no ``>>`` for uint32 on the CPU).

The kernel gives a problem G lanes of K words each (:func:`myers_plan`); a
query of more words than a warp's 32 x 16 runs in passes of G K words, each
pass handing the next the horizontal delta of every column through a device
buffer, so no query length is refused.  The plain version takes the same
split as ``pass_words`` (it never changes a result).
"""

import torch

from ..utils.profiling import kernel_span
from . import _build

WORD = 32
_M32 = 0xFFFFFFFF
#: words a lane takes before a problem gets more lanes, and lanes a problem
#: at most
LANE_WORDS, MAX_G = 8, 32


def num_words(max_query_length: int) -> int:
    """Wq: 32-base words of a (B, Lq) query batch (at least one)."""
    return max(1, -(-max_query_length // WORD))


def myers_plan(Wq: int) -> tuple[int, int, int]:
    """-> (G, K, passes) of a batch of Wq query words: G, the lanes a
    problem, the least power of two up to MAX_G with G x LANE_WORDS >= Wq;
    K, the words a lane holds on a full pass, 16 for a whole warp and
    LANE_WORDS otherwise; passes of G x K words.  (On its last pass a
    problem gives each lane only the words its own query needs.)"""
    G = 1
    while G < MAX_G and G * LANE_WORDS < Wq:
        G *= 2
    K = 16 if G == MAX_G else LANE_WORDS
    return G, K, -(-Wq // (G * K))


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
                           t: torch.Tensor, tlen: torch.Tensor,
                           pass_words: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`myers_bottom_row`: the (word,
    column) wavefront, vectorised over the batch and the words.  With
    ``pass_words`` the words run in passes of that many, as the kernel runs
    long queries: each pass hands the next the horizontal delta of every
    column, and only the pass holding a problem's last word moves its
    bottom row."""
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
    rows = torch.empty((B, Lt + 1), dtype=i64, device=dev)
    rows[:, 0] = ql
    # the delta handed into the first word of a pass, per column: +1 below
    # word 0 (D[0, j] - D[0, j - 1] = 1)
    hin_pos = torch.ones((B, Lt), dtype=i64, device=dev)
    hin_neg = torch.zeros((B, Lt), dtype=i64, device=dev)
    step = pass_words or Wq
    for w0 in range(0, Wq, step):
        hin_pos, hin_neg = _myers_pass(peq[:, w0:w0 + step], tx, Lt, hin_pos,
                                       hin_neg, wlast - w0, bit_last, ql,
                                       rows)
    rows = torch.where((ql == 0)[:, None],
                       torch.arange(Lt + 1, device=dev), rows).to(torch.int32)
    scores = rows.gather(1, tlen.long().clamp(0, Lt)[:, None])[:, 0]
    return rows, scores


def _myers_pass(peq, tx, Lt, hin_pos, hin_neg, wlast, bit_last, ql, rows):
    """The wavefront over one pass's words ``peq (B, n, 5)``, the delta into
    its first word per column ``hin_pos/neg (B, Lt)``; writes the bottom row
    into ``rows`` for the problems whose last word ``wlast`` (relative to the
    pass) it holds, and returns the delta its top word hands up per column."""
    B, n = peq.shape[:2]
    dev, i64 = peq.device, torch.int64
    w = torch.arange(n, device=dev)
    barange = torch.arange(B, device=dev)
    holds = (wlast >= 0) & (wlast < n)
    wl = wlast.clamp(0, max(n - 1, 0))
    Pv = torch.full((B, n), _M32, dtype=i64, device=dev)
    Mv = torch.zeros((B, n), dtype=i64, device=dev)
    # horizontal deltas each word handed up in the previous step, as 0/1
    up_pos = torch.zeros((B, n), dtype=i64, device=dev)
    up_neg = torch.zeros((B, n), dtype=i64, device=dev)
    out_pos = torch.zeros((B, Lt), dtype=i64, device=dev)
    out_neg = torch.zeros((B, Lt), dtype=i64, device=dev)
    score = ql.clone()
    for s in range(Lt + n - 1):
        j = s - w                                     # column of each word
        live = (j >= 0) & (j < Lt)
        c = tx[:, torch.where(live, j, Lt)]           # (B, n)
        eq = peq.gather(2, torch.where(c >= 0, c, 4)[..., None])[..., 0]
        j0 = min(s, Lt - 1)                           # the first word's column
        hp = torch.cat([hin_pos[:, j0:j0 + 1], up_pos[:, :-1]], 1)
        hn = torch.cat([hin_neg[:, j0:j0 + 1], up_neg[:, :-1]], 1)
        eq2 = eq | hn
        xv = eq | Mv
        xh = ((((eq2 & Pv) + Pv) & _M32) ^ Pv) | eq2
        ph = Mv | (~(xh | Pv) & _M32)
        mh = Pv & xh
        up_pos = ph >> (WORD - 1)
        up_neg = mh >> (WORD - 1)
        jt = s - (n - 1)                              # the top word's column
        if 0 <= jt < Lt:
            out_pos[:, jt] = up_pos[:, -1]
            out_neg[:, jt] = up_neg[:, -1]
        # the bottom row: the last word's column moves one step
        jl = s - wl
        d = (((ph[barange, wl] >> bit_last) & 1)
             - ((mh[barange, wl] >> bit_last) & 1))
        at = holds & (jl >= 0) & (jl < Lt)
        score = torch.where(at, score + d, score)
        rows[barange[at], jl[at] + 1] = score[at]
        ph = ((ph << 1) & _M32) | hp
        mh = ((mh << 1) & _M32) | hn
        Pv = torch.where(live, mh | (~(xv | ph) & _M32), Pv)
        Mv = torch.where(live, ph & xv, Mv)
    return out_pos, out_neg


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
    G, K, passes = myers_plan(Wq)
    q, qlen, t, tlen = (x.contiguous() for x in (q, qlen, t, tlen))
    rows = torch.empty((B, Lt + 1), dtype=torch.int32, device=q.device)
    scores = torch.empty(B, dtype=torch.int32, device=q.device)
    if B == 0:
        return rows, scores
    carry = torch.empty(2 * B * (-(-Lt // 4)) if passes > 1 else 0,
                        dtype=torch.uint8, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device), kernel_span(
            "myers", (q, qlen, t, tlen), B * Wq * Lt):
        err = lib.cga_myers(
            q.data_ptr(), qlen.data_ptr(), t.data_ptr(), tlen.data_ptr(),
            rows.data_ptr(), scores.data_ptr(),
            carry.data_ptr() if passes > 1 else None, B, Lq, Lt, G, K,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "myers")
    return rows, scores
