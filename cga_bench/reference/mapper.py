"""Plain NumPy all-vs-all minimizer mapper: the benchmark's reference for
the overlaps of ``cli map``, ``cli pipeline`` and ``cli correct``.

It follows the mapper's written spec (cudamapper's sketch, index, matcher
and triggered chaining, with the canonical rules of the JAX package's
``cpu/mapper_oracle.py``), written anew with array operations:

- sketch: 2k-bit forward and reverse-complement k-mers, canonical = the
  smaller (forward wins ties), ``murmur32(lo32(c) ^ murmur32(hi32(c)))``;
  minimizers are every position that is the minimum of a full window of w
  k-mers, and the prefix and suffix end-minimizers;
- anchors: every pair of equal representations in two different reads,
  relative strand = XOR of the directions;
- chains: anchors sorted by (query, target, strand, query position, signed
  target position); consecutive anchors chain while both steps lie in
  (0, max_anchor_gap]; a chain of at least ``min_residues`` anchors is an
  overlap if its length, bases a residue and span ratio pass the filters
  (the ratio compared exactly, as a fraction).

Overlaps are returned as an (n, 8) int64 array of (query, target, q_start,
q_end, t_start, t_end, residues, strand01) rows in canonical order.
"""

from fractions import Fraction

import numpy as np

U32 = np.uint32
INVALID = 0xFFFFFFFF
ENC = np.full(256, -1, np.int8)
for _i, _b in enumerate(b"ACGT"):
    ENC[_b] = _i
    ENC[_b + 32] = _i


def encode(seq: str) -> np.ndarray:
    return ENC[np.frombuffer(seq.encode(), np.uint8)]


def murmur32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x ^ (x >> U32(16))
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> U32(13))
    x = x * U32(0xC2B2AE35)
    return x ^ (x >> U32(16))


def sketch(seq: str, k: int, w: int, hashed: bool = True):
    """(positions, representations, directions) of one read's minimizers."""
    codes = encode(seq)
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    win = np.lib.stride_tricks.sliding_window_view(codes.astype(np.int64), k)
    valid = (win >= 0).all(1)
    c = np.maximum(win, 0).astype(np.uint64)
    sh = (2 * np.arange(k - 1, -1, -1)).astype(np.uint64)
    f = np.bitwise_or.reduce(c << sh, axis=1)
    r = np.bitwise_or.reduce((np.uint64(3) - c) << sh[::-1], axis=1)
    can = np.minimum(f, r)
    direction = (f > r).astype(np.int64)
    if hashed:
        rep = murmur32((can & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                       ^ murmur32((can >> np.uint64(32)).astype(np.uint32)))
    else:
        rep = can.astype(np.uint32)
    rep = np.where(valid, rep.astype(np.int64), INVALID)
    is_min = np.zeros(n, bool)
    if n >= w:
        wm = np.lib.stride_tricks.sliding_window_view(rep, w).min(1)
        # the largest minimum of the windows holding p equals rep[p]
        # exactly when p is the minimum of one of them
        pad = np.concatenate([np.full(w - 1, -1, np.int64), wm,
                              np.full(w - 1, -1, np.int64)])
        best = np.lib.stride_tricks.sliding_window_view(pad, w).max(1)
        is_min |= best == rep
    cmin = np.minimum.accumulate(rep)
    rmin = np.minimum.accumulate(rep[::-1])[::-1]
    head = np.arange(n) < min(w - 1, n)
    tail = np.arange(n) >= max(0, n - w + 1)
    is_min |= head & (rep == cmin)
    is_min |= tail & (rep == rmin)
    is_min &= valid
    p = np.flatnonzero(is_min)
    return p.astype(np.int64), rep[p], direction[p]


def anchors(seqs: list[str], k: int, w: int, hashed: bool = True,
            skip_self: bool = True):
    """All-vs-all anchors as (q_read, t_read, q_pos, t_pos, dir) arrays."""
    pos, rep, dirs, rid = [], [], [], []
    for i, s in enumerate(seqs):
        p, r, d = sketch(s, k, w, hashed)
        pos.append(p)
        rep.append(r)
        dirs.append(d)
        rid.append(np.full(len(p), i, np.int64))
    pos, rep, dirs, rid = map(np.concatenate, (pos, rep, dirs, rid))
    order = np.lexsort((pos, rid, rep))
    pos, rep, dirs, rid = pos[order], rep[order], dirs[order], rid[order]
    # groups of equal representation: each element pairs with every
    # element of its group
    first = np.flatnonzero(np.r_[True, rep[1:] != rep[:-1]])
    size = np.diff(np.r_[first, len(rep)])
    gsize = np.repeat(size, size)
    gfirst = np.repeat(first, size)
    qi = np.repeat(np.arange(len(rep)), gsize)
    off = np.arange(len(qi)) - np.repeat(np.cumsum(gsize) - gsize, gsize)
    ti = np.repeat(gfirst, gsize) + off
    keep = rid[qi] != rid[ti] if skip_self else np.ones(len(qi), bool)
    qi, ti = qi[keep], ti[keep]
    return rid[qi], rid[ti], pos[qi], pos[ti], dirs[qi] ^ dirs[ti]


def map_all_vs_all(seqs: list[str], cfg: dict) -> np.ndarray:
    """Canonical (n, 8) overlap rows of the reads ``seqs`` under the mapper
    settings ``cfg`` (the keys of the configuration file's ``mapper``)."""
    k, gap = cfg["kmer_size"], cfg["max_anchor_gap"]
    q, t, qp, tp, d = anchors(seqs, k, cfg["window_size"],
                              cfg.get("hash_representations", True),
                              cfg.get("skip_self_mappings", True))
    st = np.where(d == 0, tp, -tp)
    order = np.lexsort((st, qp, d, t, q))
    q, t, qp, tp, d, st = (a[order] for a in (q, t, qp, tp, d, st))
    n = len(q)
    if n == 0:
        return np.zeros((0, 8), np.int64)
    same = np.r_[False, (q[1:] == q[:-1]) & (t[1:] == t[:-1])
                 & (d[1:] == d[:-1])]
    dq = np.r_[0, np.diff(qp)]
    dst = np.r_[0, np.diff(st)]
    cont = same & (dq > 0) & (dq <= gap) & (dst > 0) & (dst <= gap)
    s = np.flatnonzero(~cont)                 # chain starts
    e = np.r_[s[1:], n] - 1                   # chain ends
    n_res = e - s + 1
    q0, q1 = qp[s], qp[e] + k
    t0 = np.where(d[s] == 0, tp[s], tp[e])
    t1 = np.where(d[s] == 0, tp[e], tp[s]) + k
    qspan, tspan = q1 - q0, t1 - t0
    olen = np.maximum(qspan, tspan)
    frac = Fraction(cfg["min_overlap_fraction"]).limit_denominator(10**6)
    ok = ((n_res >= cfg["min_residues"])
          & (olen >= cfg["min_overlap_len"])
          & (olen <= cfg["min_bases_per_residue"] * n_res)
          & (np.minimum(qspan, tspan) * frac.denominator
             >= frac.numerator * olen))
    rows = np.stack([q[s], t[s], q0, q1, t0, t1, n_res, d[s]], 1)[ok]
    return rows[canonical_order(rows)]


def canonical_order(rows: np.ndarray) -> np.ndarray:
    """The overlaps' canonical order: (query, target, strand, q_start,
    t_start, q_end, t_end)."""
    return np.lexsort((rows[:, 5], rows[:, 3], rows[:, 4], rows[:, 2],
                       rows[:, 7], rows[:, 1], rows[:, 0]))
