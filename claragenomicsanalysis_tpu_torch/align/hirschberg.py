"""Hirschberg–Myers divide and conquer for long pairs (counterpart of
``claragenomicsanalysis_tpu/align/hirschberg.py``).

Linear-memory global alignment, level by level: every open fragment of the
whole batch whose query side exceeds ``BASE_Q`` is split at its middle query
row.  One forward and one reversed Myers bottom row per fragment, in a
single batched call, locate the column where an optimal path crosses that
row; the two halves are the next level's fragments.  Fragments with a query
side of at most ``BASE_Q`` are solved by banded NW at radius
``max(8, pow2(longest side))``, which holds every global path of the
fragment (by the banded-NW kernel the caller names, ``ops.banded.KERNELS``;
both give the same paths).  The pieces, in query order, make each pair's
path.

The path is optimal and deterministic but not the dense canonical one: the
split takes the smallest optimal column.  The split rule, the middle row,
``BASE_Q`` and the base radius are the JAX package's, so the two packages
give the same path.  Fragments live as NumPy arrays on the host; each
level's sequences are cut from the pairs' codes on the device, and only the
split columns come back.

The leaves' paths take one of two routes.  :func:`hirschberg_align_batch`
(``Aligner.get_alignments()``, ``cli align``, ``cli correct``) unpacks each
leaf's codes on the host and joins them into a code list a pair.
:func:`hirschberg_align_packed` (``Aligner.get_cigars()``, ``cli
pipeline``) keeps every leaf's packed words on the device, as segments of
its pair's path, for the CIGAR kernel (``ops/cigar.py``).

With a mesh whose 'sp' axis has more than one rank, a level whose longer
side reaches ``sp_min_len`` takes its forward and reverse rows from the
ring wavefront (parallel/ring_nw.py) instead of B4; the rows are the same
unit-cost distances, so the split, and the path, do not change.  By
default the threshold is :func:`ring_min_len`, the shortest query B4 runs
in more than one pass (the JAX package takes the longest query whose
Myers state fits one TPU core's VMEM).

The counters ``hirschberg.pairs``, ``hirschberg.levels`` and
``hirschberg.ring_levels`` (``utils.profiling.count``) hold the pairs it
aligned, the split levels it ran and those of them that went to the ring.
"""

import functools

import numpy as np
import torch

from ..ops.banded import launch_chunks, resolve
from ..ops.myers import WORD, myers_bottom_row, myers_plan
from ..ops.nw_diag import INF
from ..ops.tb_decode import PackedPaths, decode_packed
from ..utils.genomeutils import PAD, pack_pairs
from ..utils.logging import initialize_logger
from ..utils.profiling import count, to_host, trace_range

BASE_Q = 32  # fragments with a query side <= BASE_Q are solved directly


def pow2_at_least(x: np.ndarray) -> np.ndarray:
    """Elementwise ``1 << (x - 1).bit_length()``: the least power of two
    >= x, for integers x >= 1."""
    return np.left_shift(1, np.frexp(np.asarray(x, np.float64) - 1)[1])


def _cut(codes: torch.Tensor, row: np.ndarray, start: np.ndarray,
         length: np.ndarray, width: int, reverse: bool) -> torch.Tensor:
    """(n, width) int8: ``codes[row, start:start + length]``, reversed when
    asked, PAD past ``length``."""
    dev = codes.device
    row, start, length = (torch.from_numpy(a).to(dev)[:, None]
                          for a in (row, start, length))
    k = torch.arange(width, device=dev)
    inside = k < length
    pos = start + (length - 1 - k if reverse else k)
    return torch.where(inside, codes[row, torch.where(inside, pos, 0)], PAD)


def split_points(rows: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
    """Split columns of n fragments from their 2n bottom rows, forward rows
    first: ``argmin_j fwd[i, j] + rev[i, mlen - j]`` over ``j <= mlen``
    (``mlen = tlen[i]``), ties to the smallest j.  The tie-break is
    explicit (the minimum, then the first column that reaches it), so it
    does not rest on an argmin's order on the device."""
    n = rows.shape[0] // 2
    fwd, rev = rows[:n].long(), rows[n:].long()
    mlen = tlen[:n].long()[:, None]
    jj = torch.arange(rows.shape[1], device=rows.device)[None, :]
    rev_at = rev.gather(1, (mlen - jj).clamp(0, rows.shape[1] - 1))
    total = torch.where(jj <= mlen, fwd + rev_at, INF)
    best = total.min(1, keepdim=True).values
    return torch.where(total == best, jj, rows.shape[1]).min(1).values


def ring_min_len() -> int:
    """The shortest padded query for which B4 needs more than one pass
    (``ops.myers.myers_plan``): where one pass stops holding the query,
    the level goes to the ring."""
    words = 1
    while myers_plan(words)[2] == 1:
        words += 1
    return (words - 1) * WORD + 1


def _leaves(queries, targets, dev, kernel, nw_fn, decode_fn, ring=None,
            sp_min_len=None) -> list:
    """Every pair split level by level down to its base fragments, which
    are solved by banded NW: -> one ``(pair, qlo, decode_fn(tb, ...))``
    triple a base launch."""
    P = len(queries)
    qlen = np.array([len(s) for s in queries], np.int64)
    tlen = np.array([len(s) for s in targets], np.int64)
    with trace_range("hirschberg.pack"):
        codes = pack_pairs(queries, targets,
                           max(1, int(qlen.max(initial=0))),
                           max(1, int(tlen.max(initial=0))))
        Q = torch.from_numpy(codes[0]).to(dev)
        T = torch.from_numpy(codes[2]).to(dev)

    leaves: list[tuple[np.ndarray, np.ndarray, object]] = []
    frag = (np.arange(P), np.zeros(P, np.int64), qlen, np.zeros(P, np.int64),
            tlen)                                  # pair, qlo, qhi, tlo, thi
    while len(frag[0]):
        base = frag[2] - frag[1] <= BASE_Q
        if base.any():
            with trace_range("hirschberg.base"):
                leaves += _solve_base(Q, T, *(a[base] for a in frag),
                                      nw_fn, decode_fn, kernel)
        frag = tuple(a[~base] for a in frag)
        if len(frag[0]):
            with trace_range("hirschberg.split"):
                frag = _split_level(Q, T, *frag, ring=ring,
                                    sp_min_len=sp_min_len)
            count("hirschberg.levels")
    return leaves


def hirschberg_align_batch(queries: list[str], targets: list[str], device,
                           kernel: str = "diag", mesh=None,
                           sp_min_len: int | None = None
                           ) -> tuple[list[list[int]], np.ndarray]:
    """-> (paths, dists): each pair's optimal edit path (AlignmentState
    codes) and its cost, with the DP on ``device`` and the base cases by
    the banded-NW ``kernel``.  ``mesh`` with an 'sp' axis > 1: levels whose
    longer side reaches ``sp_min_len`` (default :func:`ring_min_len`) take
    their rows from the ring; every rank calls with the same pairs.

    The list route (``Aligner.get_alignments()``, ``cli correct``): every
    leaf's codes come to the host as a list (``tb.unpack``) and each pair's
    path is their concatenation (``hirschberg.join``)."""
    ring = mesh if mesh is not None and mesh.shape.get("sp", 1) > 1 else None
    if ring is not None and sp_min_len is None:
        sp_min_len = ring_min_len()
        initialize_logger().info(
            "hirschberg: auto sp threshold %d bases (the shortest query B4 "
            "runs in more than one pass); longer levels use the "
            "ring-wavefront 'sp' axis", sp_min_len)
    nw_fn, decode_fn = resolve(device, kernel)
    P = len(queries)
    if P == 0:
        return [], np.zeros(0, np.int64)
    leaves = _leaves(queries, targets, torch.device(device), kernel, nw_fn,
                     decode_fn, ring, sp_min_len)

    with trace_range("hirschberg.join"):
        pair = np.concatenate([p for p, _, _ in leaves])
        qlo = np.concatenate([lo for _, lo, _ in leaves])
        pieces = [piece for _, _, ps in leaves for piece in ps]
        paths: list[list[int]] = [[] for _ in range(P)]
        for k in np.lexsort((qlo, pair)):      # leaves in query order
            paths[pair[k]] += pieces[k]
        dists = np.array([np.count_nonzero(p) for p in paths], np.int64)
    count("hirschberg.pairs", P)
    return paths, dists


def hirschberg_align_packed(queries: list[str], targets: list[str], device,
                            kernel: str = "diag") -> PackedPaths:
    """The paths of :func:`hirschberg_align_batch` (no mesh) left on the
    device (``Aligner.get_cigars()``, ``cli pipeline``): each base launch's
    packed words stay there (``ops.tb_decode.decode_packed``), and a pair's
    leaves become its segments, which ``PackedPaths.segments`` puts in the
    list join's order.  No distance: the caller has the Myers score."""
    nw_fn, _ = resolve(device, kernel)
    out = PackedPaths(len(queries), device)
    if queries:
        for pair, qlo, (words, first) in _leaves(
                queries, targets, torch.device(device), kernel, nw_fn,
                functools.partial(decode_packed, kernel=kernel)):
            out.add(pair, words, first, key=qlo)
    count("hirschberg.pairs", len(queries))
    return out


def _solve_base(Q, T, pair, qlo, qhi, tlo, thi, nw_fn, decode_fn, kernel):
    """Banded NW of the base fragments, bucketed by radius and cut into
    launches by ops.banded.launch_chunks; -> one (pair, qlo, decode_fn's
    result) triple per launch."""
    qs, ts = qhi - qlo, thi - tlo
    radius = np.maximum(8, pow2_at_least(np.maximum(np.maximum(qs, ts), 1)))
    out = []
    for r in np.unique(radius).tolist():
        bucket = np.flatnonzero(radius == r)
        Lq, Lt = max(1, int(qs[bucket].max())), max(1, int(ts[bucket].max()))
        for sel in launch_chunks(bucket, Lq, Lt, r, kernel):
            q = _cut(Q, pair[sel], qlo[sel], qs[sel], Lq, False)
            t = _cut(T, pair[sel], tlo[sel], ts[sel], Lt, False)
            ql, tl = (torch.from_numpy(a[sel].astype(np.int32)).to(Q.device)
                      for a in (qs, ts))
            _, tb = nw_fn(q, ql, t, tl, r)
            out.append((pair[sel], qlo[sel], decode_fn(tb, ql, tl, r)))
    return out


def _split_level(Q, T, pair, qlo, qhi, tlo, thi, ring=None,
                 sp_min_len: int | None = None):
    """One level: forward and reversed bottom rows of every fragment in one
    batched call (B4, or the ring of mesh ``ring`` where the level's longer
    side reaches sp_min_len); -> the two children of each fragment."""
    mid = (qlo + qhi) // 2
    fq, rq, tn = mid - qlo, qhi - mid, thi - tlo
    Lq, Lt = int(max(fq.max(), rq.max())), int(tn.max())
    q = torch.cat([_cut(Q, pair, qlo, fq, Lq, False),
                   _cut(Q, pair, mid, rq, Lq, True)])
    t = torch.cat([_cut(T, pair, tlo, tn, Lt, False),
                   _cut(T, pair, tlo, tn, Lt, True)])
    ql = torch.from_numpy(np.concatenate([fq, rq]).astype(np.int32))
    tl = torch.from_numpy(np.concatenate([tn, tn]).astype(np.int32))
    ql, tl = ql.to(Q.device), tl.to(Q.device)
    if ring is not None and max(Lq, Lt) >= sp_min_len:
        from ..parallel.ring_nw import ring_wavefront_nw_rows
        with trace_range("hirschberg.ring"):
            rows = torch.from_numpy(ring_wavefront_nw_rows(
                q, ql, t, tl, ring, device=Q.device)).to(Q.device)
        count("hirschberg.ring_levels")
    else:
        rows, _ = myers_bottom_row(q, ql, t, tl)
    jstar = to_host(split_points(rows, tl)).numpy()
    cut = tlo + jstar
    return (np.concatenate([pair, pair]), np.concatenate([qlo, mid]),
            np.concatenate([mid, qhi]), np.concatenate([tlo, cut]),
            np.concatenate([cut, thi]))
