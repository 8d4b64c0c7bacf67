"""Index build, anchor matching and triggered chaining as torch ops
(counterpart of ``claragenomicsanalysis_tpu/ops/map_ops.py``, which runs as
plain XLA: sorts, searchsorted, cumsum and cummax).

Every function runs on its inputs' device and returns the arrays of the JAX
function of the same name on the same inputs.  The 32-bit values travel as
int64 (ops/sketch.py):

- the index sort is ONE stable sort on ``rep``: (read, pos) is the flat
  row-major order, so it equals the JAX package's 3-key sort;
- the chain sort's 4 int32 keys pack into two non-negative int64 words,
  sorted in two passes (the second stable), with the signed key offset by
  2^31 so that its order survives the packing;
- where the JAX package computes in int32 and a product can wrap (the
  ``-F`` and overlap-fraction tests, the end columns of invalid rows), the
  port wraps the same way (``wrap32``).

Left out on purpose: the JAX package's ``with_packed`` side array and
``pack2`` / ``_start_fill16`` chain path, which exist to cut TPU sort
operands and gathers; they give the same arrays as the plain path the port
keeps.  Capacities are the true counts, not pow2 buckets.
"""

import torch

from .sketch import INVALID

I32MAX = 2**31 - 1

#: the chained-overlap fields, in the order of the compacted (8, n) rows
OVERLAP_FIELDS = ("q_read", "t_read", "q_start", "q_end", "t_start", "t_end",
                  "n_res", "dir")


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound, as an int32
    computation of the same value would give."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def build_index(rep, dirs, is_min, first_read_id: int,
                filter_thr_num: int = 1, filter_thr_den: int = 1) -> dict:
    """Flatten and sort the sketch elements of a (B, Lk) sketch.  Returns a
    dict of (B * Lk,) arrays sorted by (rep, read_id, pos), INVALID reps
    last, and ``n_elems`` (0-d int64).

    Reps whose count exceeds (num / den) * n_elems are dropped (num == den
    == 1 disables the filter); the dropped rows become INVALID and sort
    among the padding by their flat position, as in the JAX package."""
    B, Lk = rep.shape
    flat_rep = torch.where(is_min, rep, INVALID).reshape(-1)
    n_elems = is_min.sum()
    srep, perm = torch.sort(flat_rep, stable=True)
    if not (filter_thr_num == 1 and filter_thr_den == 1):
        lo = torch.searchsorted(srep, srep, side="left")
        hi = torch.searchsorted(srep, srep, side="right")
        keep = ((wrap32((hi - lo) * filter_thr_den)
                 <= wrap32(n_elems * filter_thr_num)) & (srep != INVALID))
        keep_flat = torch.zeros_like(keep)
        keep_flat[perm] = keep
        srep, perm = torch.sort(torch.where(keep_flat, flat_rep, INVALID),
                                stable=True)
        n_elems = keep.sum()
    return {"rep": srep,
            "read_id": (first_read_id + perm // Lk).to(torch.int32),
            "pos": (perm % Lk).to(torch.int32),
            "dir": dirs.reshape(-1)[perm].to(torch.int32),
            "n_elems": n_elems}


def match_count(qidx: dict, tidx: dict):
    """Target ranges of each query element: (lo (C,), cum (C+1,), total),
    all int64 on the indices' device; ``total`` is 0-d."""
    qrep, trep = qidx["rep"], tidx["rep"]
    lo = torch.searchsorted(trep, qrep, side="left")
    hi = torch.searchsorted(trep, qrep, side="right")
    cnt = torch.where(qrep != INVALID, hi - lo, 0)
    cum = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
    return lo, cum, cum[-1]


def match_expand(qidx: dict, tidx: dict, lo, cum, cap: int,
                 skip_self: bool = True) -> dict:
    """Cross-product anchor expansion into (cap,) arrays, in (query element,
    target occurrence) order, with a ``valid`` mask: rows past the true
    count, and self-mappings under ``skip_self``, are invalid."""
    dev = cum.device
    C, Ct = cum.shape[0] - 1, tidx["rep"].shape[0]
    a = torch.arange(cap, device=dev)
    src = (torch.searchsorted(cum, a, side="right") - 1).clamp(
        0, max(C - 1, 0))
    tsel = (lo[src] + a - cum[src]).clamp(0, max(Ct - 1, 0))
    valid = a < torch.clamp(cum[-1], max=cap)
    q_read = qidx["read_id"][src]
    t_read = tidx["read_id"][tsel]
    if skip_self:
        valid &= q_read != t_read
    return {"q_read": q_read, "t_read": t_read,
            "q_pos": qidx["pos"][src], "t_pos": tidx["pos"][tsel],
            "dir": qidx["dir"][src] ^ tidx["dir"][tsel],
            "valid": valid}


def match_anchors(qidx: dict, tidx: dict, cap: int, skip_self: bool = True):
    """One-shot matching at a fixed capacity: (anchors, total, overflow)."""
    lo, cum, total = match_count(qidx, tidx)
    anchors = match_expand(qidx, tidx, lo, cum, cap=cap, skip_self=skip_self)
    return anchors, total, total > cap


def _prev(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:1], x[:-1]])


def chain_anchors(anchors: dict, k: int, min_residues: int,
                  min_overlap_len: int, min_bases_per_residue: int,
                  min_overlap_fraction_num: int,
                  min_overlap_fraction_den: int, max_gap: int) -> dict:
    """Triggered chaining.  Returns a dict of (C,) int32 overlap fields with
    a ``valid`` mask, one row per anchor in sorted order, valid at the ends
    of the chains that pass the filters."""
    v = anchors["valid"]
    d_in = anchors["dir"].to(torch.int64)
    tp_in = anchors["t_pos"].to(torch.int64)
    qid = torch.where(v, anchors["q_read"].to(torch.int64), I32MAX)
    tid = torch.where(v, anchors["t_read"].to(torch.int64), I32MAX)
    dqp = torch.where(v, (d_in << 30) | anchors["q_pos"].to(torch.int64),
                      I32MAX)
    st = torch.where(v, torch.where(d_in == 0, tp_in, -tp_in), I32MAX)

    # the sort on (qid, tid, dqp, st): every operand is a key, so equal
    # keys are equal rows and only the second pass needs to be stable
    key1 = (qid << 32) | tid
    key2 = (dqp << 32) | (st + 2**31)
    key2, p = torch.sort(key2)
    key1, p = torch.sort(key1[p], stable=True)
    key2 = key2[p]
    qid, tid = key1 >> 32, key1 & 0xFFFFFFFF
    dqp, st = key2 >> 32, (key2 & 0xFFFFFFFF) - 2**31
    v = qid != I32MAX
    d = torch.where(v, dqp >> 30, I32MAX)
    qp = torch.where(v, dqp & ((1 << 30) - 1), I32MAX)
    tp = torch.where(d == 0, st, -st)      # garbage for invalid rows: masked
    idx = torch.arange(qid.shape[0], device=qid.device)
    same = ((qid == _prev(qid)) & (tid == _prev(tid)) & (d == _prev(d))
            & (idx > 0))
    return _chain_scan(same, qid, tid, d, qp, st, tp, v, k, min_residues,
                       min_overlap_len, min_bases_per_residue,
                       min_overlap_fraction_num, min_overlap_fraction_den,
                       max_gap)


def _chain_scan(same, qid, tid, d, qp, st, tp, v, k, min_residues,
                min_overlap_len, min_bases_per_residue,
                min_overlap_fraction_num, min_overlap_fraction_den, max_gap):
    """The triggered-chain scan over (qid, tid, dir)-grouped, (qp, st)-
    sorted anchors (int64 columns); output columns wrap to int32 as the
    JAX package's int32 arithmetic does."""
    C = qid.shape[0]
    idx = torch.arange(C, device=qid.device)
    dq = qp - _prev(qp)
    dst = st - _prev(st)
    cont = same & (dq > 0) & (dq <= max_gap) & (dst > 0) & (dst <= max_gap)
    new_chain = ~cont
    # each row's chain start, the latest new_chain row at or before it
    # (row 0 always starts one): the chains' numbers by a cumsum, their
    # start rows scattered by number (the other rows into a spare slot C),
    # gathered back; torch's 1-d cummax, the JAX package's way, is a slow
    # scan kernel on the card
    chain_no = torch.cumsum(new_chain, 0) - 1
    starts = torch.zeros(C + 1, dtype=idx.dtype, device=idx.device)
    starts.scatter_(0, torch.where(new_chain, chain_no, C), idx)
    start_idx = starts[chain_no]
    nxt_new = torch.cat([new_chain[1:], new_chain.new_ones(1)])
    is_end = nxt_new & v

    s = start_idx.clamp(0, max(C - 1, 0))
    n_res = idx - s + 1
    q0 = qp[s]
    t_first = tp[s]
    q1 = wrap32(qp + k).to(torch.int64)
    t0 = torch.where(d == 0, t_first, tp)
    t1 = wrap32(torch.where(d == 0, tp, t_first) + k).to(torch.int64)
    qspan = wrap32(q1 - q0).to(torch.int64)
    tspan = wrap32(t1 - t0).to(torch.int64)
    olen = torch.maximum(qspan, tspan)
    ok = (is_end
          & (n_res >= min_residues)
          & (olen >= min_overlap_len)
          & (olen <= wrap32(min_bases_per_residue * n_res))
          & (wrap32(torch.minimum(qspan, tspan) * min_overlap_fraction_den)
             >= wrap32(min_overlap_fraction_num * olen)))
    return {"q_read": wrap32(qid), "t_read": wrap32(tid),
            "q_start": wrap32(q0), "q_end": wrap32(q1),
            "t_start": wrap32(t0), "t_end": wrap32(t1),
            "n_res": wrap32(n_res), "dir": wrap32(d), "valid": ok}


def count_valid(out: dict) -> torch.Tensor:
    return out["valid"].sum()


def _valid_first(valid: torch.Tensor) -> torch.Tensor:
    """Row indices, valid rows first, each part in its order (the stable
    sort on ~valid)."""
    return torch.cat([torch.nonzero(valid).reshape(-1),
                      torch.nonzero(~valid).reshape(-1)])


def compact_overlaps(out: dict):
    """(stacked (8, C) int32 with the valid rows first, in order; n_valid)."""
    order = _valid_first(out["valid"])
    stacked = torch.stack([out[f].to(torch.int32)[order]
                           for f in OVERLAP_FIELDS])
    return stacked, count_valid(out)


def compact_overlaps_gather(out: dict, out_cap: int) -> torch.Tensor:
    """The first ``out_cap`` columns of compact_overlaps' stacked rows."""
    sel = _valid_first(out["valid"])[:out_cap]
    return torch.stack([out[f].to(torch.int32)[sel] for f in OVERLAP_FIELDS])
