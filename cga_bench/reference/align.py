"""Plain PyTorch global alignment: the benchmark's reference for the paths
and CIGARs of the port's aligners.

Unit-cost edit distance of a query against a target (match 0; mismatch,
insertion and deletion 1; a negative code matches nothing).  The paths are
the ones the aligners are specified to give (the JAX package's
``cpu/nw_oracle.py`` and ``align/hirschberg.py``):

- the dense canonical path: traced back from (n, m), a diagonal move
  first, then a deletion (consumes the target), then an insertion;
- Hirschberg's path: a fragment whose query side exceeds 32 bases is cut
  at its middle query row, at the smallest column j that minimises
  forward(j) + reverse(m - j); fragments of at most 32 query bases take
  their dense canonical path;
- which of the two a pair takes is the aligners' routing rule
  (:func:`route`), a function of the pair's padded length and its exact
  distance.

Everything runs as whole-batch tensor operations, a DP row at a time, on
whatever device the tensors are on; nothing of the port is used.
``control=True`` computes the same optimal distances but breaks the
canonical rules (an insertion before a deletion, the largest optimal split
column): the benchmark's control.
"""

import numpy as np
import torch

INSERTION, DELETION = 2, 3      # path codes; 0 match, 1 mismatch
BASE_Q = 32
TB_BYTES_PER_PROBLEM = 1 << 18
ENC = np.full(256, -1, np.int8)
for _i, _b in enumerate(b"ACGT"):
    ENC[_b] = _i


def pow2(x: int) -> int:
    """The least power of two >= x (x >= 1)."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def span_bucket(lq: int, lt: int) -> int:
    """The padded length a pair aligns at: pow2 of its longer side, >= 64."""
    return max(64, pow2(max(lq, lt, 1)))


def routes_to_hirschberg(Lq: int, r: int) -> bool:
    return Lq * (-(-(2 * r + 1) // 128) * 128) > TB_BYTES_PER_PROBLEM


def route(algorithm: str, Lq: int, lq: int, lt: int, dist: int) -> bool:
    """True when a pair of lengths (lq, lt) with exact distance ``dist`` in
    a batch padded to ``Lq`` goes to Hirschberg under ``algorithm``
    (``myers``: radius pow2 of the distance; ``banded-escalate``: radii
    from pow2(max(|lq - lt|, (lq + lt) // 12, 8)), halved while they route,
    doubled until the distance fits)."""
    if algorithm == "myers":
        return routes_to_hirschberg(Lq, max(8, pow2(max(dist, 1))))
    if algorithm != "banded-escalate":
        raise ValueError(algorithm)
    r = pow2(max(abs(lq - lt), (lq + lt) // 12, 8))
    while routes_to_hirschberg(Lq, r) and r > 8:
        r //= 2
    while True:
        if routes_to_hirschberg(Lq, r):
            return True
        if dist <= r:
            return False
        r *= 2


def codes(seqs: list[str], width: int, device, fill: int = -1) -> torch.Tensor:
    out = np.full((len(seqs), max(width, 1)), fill, np.int8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = ENC[np.frombuffer(s.encode(), np.uint8)]
    return torch.from_numpy(out).to(device)


def _row_step(prev, qi, t, i):
    """DP row i from row i - 1 for every problem at once: ``qi`` (F, 1) the
    query base of row i, ``t`` (F, M) the targets."""
    sub = ((qi != t) | (qi < 0) | (t < 0)).to(prev.dtype)
    cand = torch.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)
    row = torch.cat([torch.full_like(prev[:, :1], i), cand], 1)
    ar = torch.arange(row.shape[1], device=row.device, dtype=row.dtype)
    return torch.cummin(row - ar, 1).values + ar


def bottom_rows(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor
                ) -> torch.Tensor:
    """(F, M + 1) int32: row qlen[f] of each problem's DP over the whole of
    its target row (columns past its target length compare against the
    fill, which matches nothing)."""
    F, M = t.shape
    dev = t.device
    row = torch.arange(M + 1, device=dev, dtype=torch.int32).expand(F, -1)
    out = row.clone()
    qlen = qlen.to(dev)
    for i in range(1, int(qlen.max()) + 1 if F else 1):
        row = _row_step(row, q[:, i - 1:i], t, i)
        done = (qlen == i)[:, None]
        out = torch.where(done, row, out)
    return out


def dense_paths(q: torch.Tensor, qlen: np.ndarray, t: torch.Tensor,
                tlen: np.ndarray, control: bool = False
                ) -> tuple[list[list[int]], np.ndarray]:
    """(the dense canonical path, the distance) of each problem
    (``control``: insertion tried before deletion)."""
    F = q.shape[0]
    if F == 0:
        return [], np.zeros(0, np.int64)
    dev = q.device
    n, m = int(qlen.max()), int(tlen.max())
    q, t = q[:, :max(n, 1)], t[:, :max(m, 1)]
    D = torch.empty((F, n + 1, m + 1), dtype=torch.int16, device=dev)
    row = torch.arange(m + 1, device=dev, dtype=torch.int32).expand(F, -1)
    D[:, 0] = row
    for i in range(1, n + 1):
        row = _row_step(row, q[:, i - 1:i], t, i)
        D[:, i] = row
    Df = D.reshape(F, -1)
    W = m + 1
    i = torch.from_numpy(qlen.astype(np.int64)).to(dev)
    j = torch.from_numpy(tlen.astype(np.int64)).to(dev)
    dist = Df[torch.arange(F, device=dev), i * W + j].cpu().numpy()
    steps = int((qlen + tlen).max())
    ops = torch.full((F, max(steps, 1)), -1, dtype=torch.int8, device=dev)
    fid = torch.arange(F, device=dev)
    qpad = torch.cat([q.long(), torch.full((F, 1), -1, device=dev)], 1)
    tpad = torch.cat([t.long(), torch.full((F, 1), -2, device=dev)], 1)
    for s in range(steps):
        active = (i > 0) | (j > 0)
        here = Df[fid, i * W + j].long()
        im, jm = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        qa = qpad[fid, im]
        ta = tpad[fid, jm]
        sub = ((qa != ta) | (qa < 0) | (ta < 0)).long()
        diag = (i > 0) & (j > 0) & (Df[fid, im * W + jm].long() + sub == here)
        dele = (j > 0) & (Df[fid, i * W + jm].long() + 1 == here)
        ins = (i > 0) & (Df[fid, im * W + j].long() + 1 == here)
        if control:
            take_ins = ~diag & ins
            take_del = ~diag & ~ins & dele
        else:
            take_del = ~diag & dele
            take_ins = ~diag & ~dele & ins
        op = torch.where(diag, sub,
                         torch.where(take_del, DELETION, INSERTION))
        op = torch.where(active, op, -1)
        ops[:, s] = op.to(torch.int8)
        i = torch.where(active & (diag | take_ins), i - 1, i)
        j = torch.where(active & (diag | take_del), j - 1, j)
    ops = ops.cpu().numpy()
    out = []
    for f in range(F):
        row = ops[f]
        out.append(row[row >= 0][::-1].astype(int).tolist())
    return out, dist.astype(np.int64)


def _cut(codes_t: torch.Tensor, pair: np.ndarray, lo: np.ndarray,
         length: np.ndarray, width: int, reverse: bool, fill: int):
    dev = codes_t.device
    pair_t = torch.from_numpy(pair).to(dev)[:, None]
    lo_t = torch.from_numpy(lo).to(dev)[:, None]
    len_t = torch.from_numpy(length).to(dev)[:, None]
    k = torch.arange(max(width, 1), device=dev)[None, :]
    inside = k < len_t
    pos = lo_t + (len_t - 1 - k if reverse else k)
    got = codes_t[pair_t, torch.where(inside, pos, 0)]
    return torch.where(inside, got, torch.full_like(got, fill))


def hirschberg_paths(Q: torch.Tensor, qlen: np.ndarray, T: torch.Tensor,
                     tlen: np.ndarray, control: bool = False,
                     base_chunk: int = 4096) -> list[list[int]]:
    """Hirschberg's path of each pair of the packed batch (Q, T)."""
    P = len(qlen)
    frag = (np.arange(P), np.zeros(P, np.int64), qlen.astype(np.int64),
            np.zeros(P, np.int64), tlen.astype(np.int64))
    leaves = []
    while len(frag[0]):
        pair, qlo, qhi, tlo, thi = frag
        base = qhi - qlo <= BASE_Q
        if base.any():
            b = np.flatnonzero(base)
            qs, ts = (qhi - qlo)[b], (thi - tlo)[b]
            # bucket by target width so the DP matrices stay tight
            wb = np.array([pow2(x) for x in np.maximum(ts, 1)])
            for wv in np.unique(wb):
                sel_all = b[wb == wv]
                step = max(1, min(base_chunk,
                                  (1 << 26) // (33 * (int(wv) + 1))))
                for c0 in range(0, len(sel_all), step):
                    sel = sel_all[c0:c0 + step]
                    qq = _cut(Q, pair[sel], qlo[sel], qhi[sel] - qlo[sel],
                              BASE_Q, False, -1)
                    tt = _cut(T, pair[sel], tlo[sel], thi[sel] - tlo[sel],
                              int(wv), False, -2)
                    ps, _ = dense_paths(qq, qhi[sel] - qlo[sel], tt,
                                        thi[sel] - tlo[sel], control)
                    leaves += zip(pair[sel].tolist(), qlo[sel].tolist(), ps)
        keep = ~base
        pair, qlo, qhi, tlo, thi = (a[keep] for a in frag)
        if not len(pair):
            break
        mid = (qlo + qhi) // 2
        fq, rq, tn = mid - qlo, qhi - mid, thi - tlo
        Lq, Lt = int(max(fq.max(), rq.max())), int(tn.max())
        qq = torch.cat([_cut(Q, pair, qlo, fq, Lq, False, -1),
                        _cut(Q, pair, mid, rq, Lq, True, -1)])
        tt = torch.cat([_cut(T, pair, tlo, tn, Lt, False, -2),
                        _cut(T, pair, tlo, tn, Lt, True, -2)])
        ql = torch.from_numpy(np.concatenate([fq, rq]))
        rows = bottom_rows(qq, ql, tt).long()
        n = len(pair)
        fwd, rev = rows[:n], rows[n:]
        mlen = torch.from_numpy(tn).to(rows.device)[:, None]
        jj = torch.arange(rows.shape[1], device=rows.device)[None, :]
        rev_at = rev.gather(1, (mlen - jj).clamp(0, rows.shape[1] - 1))
        total = torch.where(jj <= mlen, fwd + rev_at, 1 << 40)
        best = total.min(1, keepdim=True).values
        hit = total == best
        if control:   # the largest optimal column
            jstar = torch.where(hit, jj, -1).max(1).values
        else:
            jstar = torch.where(hit, jj, rows.shape[1]).min(1).values
        cut = tlo + jstar.cpu().numpy()
        frag = (np.concatenate([pair, pair]), np.concatenate([qlo, mid]),
                np.concatenate([mid, qhi]), np.concatenate([tlo, cut]),
                np.concatenate([cut, thi]))
    paths: list[list[int]] = [[] for _ in range(P)]
    for p, _, piece in sorted(leaves, key=lambda x: (x[0], x[1])):
        paths[p] += piece
    return paths


def chunks(order: np.ndarray, qlen: np.ndarray, tlen: np.ndarray,
           cells: int):
    """Runs of ``order`` whose padded DP area, pairs x (longest query + 1)
    x (longest target + 1), stays within ``cells`` (one pair at least)."""
    out, start, mq, mt = [], 0, 0, 0
    for k, i in enumerate(order):
        nq, nt = max(mq, int(qlen[i])), max(mt, int(tlen[i]))
        if k > start and (k - start + 1) * (nq + 1) * (nt + 1) > cells:
            out.append(order[start:k])
            start, nq, nt = k, int(qlen[i]), int(tlen[i])
        mq, mt = nq, nt
    if len(order) > start:
        out.append(order[start:])
    return out


def default_cells(device) -> int:
    """DP cells a batch may hold: 2^30 (2 GiB of int16) on a card, 2^24
    on the host."""
    return 1 << 30 if str(device).startswith("cuda") else 1 << 24


def distances(queries: list[str], targets: list[str], device,
              cells: int | None = None) -> np.ndarray:
    """The exact distance of each pair (bottom DP rows only)."""
    cells = cells or default_cells(device)
    qlen = np.array([len(s) for s in queries], np.int64)
    tlen = np.array([len(s) for s in targets], np.int64)
    dist = np.zeros(len(queries), np.int64)
    order = np.lexsort((qlen, tlen))
    for sel in chunks(order, np.zeros_like(qlen), tlen, cells // 16):
        q = codes([queries[i] for i in sel], int(qlen[sel].max()), device)
        t = codes([targets[i] for i in sel], int(tlen[sel].max()), device,
                  fill=-2)
        rows = bottom_rows(q, torch.from_numpy(qlen[sel]), t)
        dist[sel] = rows.gather(
            1, torch.from_numpy(tlen[sel]).to(rows.device)[:, None]
        ).squeeze(1).cpu().numpy()
    return dist


def align_pairs(queries: list[str], targets: list[str], algorithm: str,
                device, control: bool = False, cells: int | None = None
                ) -> list[list[int]]:
    """Each pair's path as the port's ``algorithm`` (``myers`` or
    ``banded-escalate``) gives it at the pair's span bucket.  Pairs padded
    to 2,048 or less take the dense DP first, which also gives the
    distance their route depends on; those it routes to Hirschberg, and
    every longer pair, take Hirschberg's path."""
    cells = cells or default_cells(device)
    P = len(queries)
    qlen = np.array([len(s) for s in queries], np.int64)
    tlen = np.array([len(s) for s in targets], np.int64)
    Lq = np.array([span_bucket(a, b) for a, b in zip(qlen, tlen)], np.int64)
    paths: list[list[int]] = [[] for _ in range(P)]
    hirsch = [int(i) for i in np.flatnonzero(Lq > 2048)]
    d = np.flatnonzero(Lq <= 2048)
    d = d[np.lexsort((tlen[d], qlen[d], Lq[d]))]
    for sel in chunks(d, qlen, tlen, cells):
        q = codes([queries[i] for i in sel], int(qlen[sel].max()), device)
        t = codes([targets[i] for i in sel], int(tlen[sel].max()), device,
                  fill=-2)
        ps, dist = dense_paths(q, qlen[sel], t, tlen[sel], control)
        for i, p, dd in zip(sel, ps, dist):
            if route(algorithm, int(Lq[i]), int(qlen[i]), int(tlen[i]),
                     int(dd)):
                hirsch.append(int(i))
            else:
                paths[i] = p
    h = np.array(sorted(hirsch, key=lambda i: (qlen[i], tlen[i])), np.int64)
    # a Hirschberg level holds about 32 tensors of 2 x pairs x target
    for sel in chunks(h, np.zeros_like(qlen), tlen, cells // 32):
        Q = codes([queries[i] for i in sel], int(qlen[sel].max()), device)
        T = codes([targets[i] for i in sel], int(tlen[sel].max()), device)
        for i, p in zip(sel, hirschberg_paths(Q, qlen[sel], T, tlen[sel],
                                              control)):
            paths[i] = p
    return paths


def cigar(path: list[int]) -> str:
    """Compact CIGAR (M for a match or mismatch, I, D) of a path."""
    ops = np.array(["M", "M", "I", "D"])[np.asarray(path, np.int64)]
    if ops.size == 0:
        return ""
    brk = np.flatnonzero(ops[1:] != ops[:-1])
    starts = np.r_[0, brk + 1]
    ends = np.r_[brk + 1, ops.size]
    return "".join(f"{e - s}{ops[s]}" for s, e in zip(starts, ends))
