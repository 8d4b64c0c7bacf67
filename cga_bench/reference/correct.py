"""Plain reference of read correction's pileup windows (Racon-style), as the
port's ``cli correct`` specifies them, from overlaps and paths the
reference computed itself.

A read is cut into backbone windows of W bases.  For each of the read's
overlaps as the query, in canonical order, the matched and mismatched
columns of its path place the other read's bases against the backbone; a
window takes the other read's substring between its first and last placed
base (reverse-complemented on the ``-`` strand) as a support when at least
``min_matched_bases`` columns fall in the window and the substring is at
most 2W long, up to ``max_support`` supports.  A window with at least
``min_supports_for_poa`` supports is replaced by the POA consensus of
[backbone, supports...], run at the pileup's depth bucket (the next power
of two of its sequence count, at least 4, at most max_support + 1) with the
caps that depth gives; a failed or empty consensus keeps the backbone.
"""

import numpy as np

from . import poa

COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(s: str) -> str:
    return s.translate(COMP)[::-1]


def spans(rows: np.ndarray, seqs: list[str]):
    """(query span, target span) of each overlap row, the target span
    reverse-complemented on the ``-`` strand."""
    out = []
    for q, t, qs, qe, ts, te, _, strand in rows.tolist():
        tspan = seqs[t][ts:te]
        out.append((seqs[q][qs:qe],
                    reverse_complement(tspan) if strand else tspan))
    return out


def within_length(rows: np.ndarray, max_len: int) -> np.ndarray:
    return np.maximum(rows[:, 3] - rows[:, 2], rows[:, 5] - rows[:, 4]) \
        <= max_len


def matched_pairs(path: list[int], row):
    """Read positions (query, forward-strand target) of the path's match
    and mismatch columns."""
    c = np.asarray(path, np.int8)
    if c.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cq, ct = c != 3, c != 2
    qoff = np.cumsum(cq) - cq
    toff = np.cumsum(ct) - ct
    m = c <= 1
    rq = row[2] + qoff[m]
    rt = (row[4] + toff[m]) if row[7] == 0 else (row[5] - 1 - toff[m])
    return rq.astype(np.int64), rt.astype(np.int64)


def supports(rows: np.ndarray, paths, seqs, cfg: dict, windows) -> dict:
    """{window: [support, ...]} for the windows asked for."""
    W = cfg["window_length"]
    out = {wi: [] for wi in windows}
    for row, path in zip(rows.tolist(), paths):
        if not path:
            continue
        rq, rt = matched_pairs(path, row)
        if rq.size == 0:
            continue
        bounds = np.searchsorted(rq, np.array(sorted(out)) * W)
        ends = np.searchsorted(rq, (np.array(sorted(out)) + 1) * W)
        for wi, s, e in zip(sorted(out), bounds, ends):
            if len(out[wi]) >= cfg["max_support"]:
                continue
            if e - s < cfg["min_matched_bases"]:
                continue
            seg_t = rt[s:e]
            lo, hi = int(seg_t.min()), int(seg_t.max()) + 1
            if hi - lo > 2 * W:
                continue
            seg = seqs[row[1]][lo:hi]
            out[wi].append(reverse_complement(seg) if row[7] else seg)
    return out


def depth_bucket(n_seqs: int, max_support: int) -> int:
    return min(max(4, 1 << (n_seqs - 1).bit_length()), max_support + 1)


def piece(backbone: str, sup: list[str], cfg: dict, control: bool = False
          ) -> str:
    """What one window becomes in the corrected read (``control``: the
    consensus tie rule reversed)."""
    if len(sup) < cfg["min_supports_for_poa"] or not backbone:
        return backbone
    seqs = [backbone] + sup
    depth = depth_bucket(len(seqs), cfg["max_support"])
    W = cfg["window_length"]
    cons, ok = poa.consensus(
        seqs, max_nodes=3 * W, max_pred=max(4, depth),
        max_aligned=max(4, depth // 2), max_seqs=depth, max_len=2 * W,
        control=control)
    return cons if ok and cons else backbone
