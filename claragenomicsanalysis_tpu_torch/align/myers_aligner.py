"""Myers-scored alignment with a banded re-run, and its score-free variant
(counterpart of ``claragenomicsanalysis_tpu/align/myers_aligner.py``).

``myers_align_batch``: the Myers bit-vector kernel gives each pair's exact
edit distance s; banded NW at radius r = max(8, pow2(s)) then re-derives the
dense canonical path.  Any optimal path stays within |i - j| <= s, and on
such a path the banded DP equals the dense one while values elsewhere only
grow, so the banded traceback is the dense canonical path.  ``kernel``
names the banded-NW kernel (``ops.banded.KERNELS``); both give that path.

``banded_escalate_align_batch`` skips the O(Lq * Lt) scoring pass: it runs
banded NW from radius pow2(max(|lq - lt|, (lq + lt) // 12, 8)) and doubles
the radius of every pair whose banded score s' exceeds it.  s' >= s always,
and s' <= r puts every dense-optimal path inside the band, so s' == s and
the path is again the dense canonical one: the two functions agree wherever
neither routes to Hirschberg.  It counts the pairs that enter its loop in
``escalate.pairs`` and each pair sent again at a doubled radius in
``escalate.retries`` (``utils.profiling.count``).

Routing (:func:`routes_to_hirschberg`) is one rule for both: a pair goes to
the linear-memory Hirschberg path when its banded traceback, counted as
the JAX package's XLA kind counts it (``Lq * round_up(2r + 1, 128)`` bytes,
``Lq`` the batch's padded query length), exceeds ``TB_BYTES_PER_PROBLEM``.
Since r >= 8 gives at least 128 bytes a row, **at a padded query length
above 2048 every pair goes to Hirschberg, under all three algorithms.**
Hirschberg's path is optimal but not always the canonical one.  The rule
does not look at the device, so a batch gives the same paths on the CPU and
on the card.
"""

import numpy as np
import torch

from ..ops.banded import launch_chunks, resolve
from ..ops.myers import myers_bottom_row
from ..ops.tb_decode import PackedPaths, decode_packed
from ..utils.mathutils import round_up
from ..utils.profiling import count, to_host, trace_range
from .hirschberg import (hirschberg_align_batch, hirschberg_align_packed,
                         pow2_at_least)

#: traceback bytes per pair above which a pair goes to Hirschberg (the JAX
#: package's XLA-kind cap, align/myers_aligner.py TB_BYTES_PER_PROBLEM)
TB_BYTES_PER_PROBLEM = 1 << 18


def routes_to_hirschberg(Lq: int, r: int) -> bool:
    """True when a pair of a batch with padded query length ``Lq`` goes to
    Hirschberg at band radius ``r`` (see the module docstring)."""
    return Lq * round_up(2 * r + 1, 128) > TB_BYTES_PER_PROBLEM


def _hirschberg_into(paths, dists, hirsch, queries, targets, device, kernel):
    """Align the pairs ``hirsch`` with Hirschberg into ``paths`` and, unless
    it is None, ``dists``."""
    if hirsch:
        with trace_range("aligner.hirschberg"):
            h_paths, h_dists = hirschberg_align_batch(
                [queries[b] for b in hirsch], [targets[b] for b in hirsch],
                device, kernel)
        for k, b in enumerate(hirsch):
            paths[b] = h_paths[k]
            if dists is not None:
                dists[b] = h_dists[k]


def myers_align_batch(q: np.ndarray, qlen: np.ndarray, t: np.ndarray,
                      tlen: np.ndarray, queries: list[str],
                      targets: list[str], device, kernel: str = "diag",
                      packed: bool = False) -> tuple:
    """-> (paths, dists) of the packed batch (``q (B, Lq)`` int8 codes with
    -1 PAD, int32 lengths); ``queries``/``targets`` are the pairs' strings,
    which the pairs routed to Hirschberg use.  ``paths``: a code list a pair
    (``Aligner.get_alignments()``), or with ``packed`` an
    ``ops.tb_decode.PackedPaths`` left on the device, a banded pair one
    segment and a Hirschberg pair its leaves (``Aligner.get_cigars()``)."""
    nw_fn, decode_fn = resolve(device, kernel)
    dev = torch.device(device)
    B, Lq = q.shape
    Lt = t.shape[1]
    qd, qld, td, tld = (torch.from_numpy(a).to(dev)
                        for a in (q, qlen, t, tlen))
    with trace_range("aligner.myers.score"):
        _, scores = myers_bottom_row(qd, qld, td, tld)
        dists = to_host(scores).numpy().astype(np.int64)

    paths = PackedPaths(B, dev) if packed else [[] for _ in range(B)]
    buckets: dict[int, list[int]] = {}
    hirsch: list[int] = []
    with trace_range("aligner.route"):
        for b in range(B):
            if qlen[b] == 0 and tlen[b] == 0:
                continue
            r = max(8, int(pow2_at_least(max(dists[b], 1))))
            if routes_to_hirschberg(Lq, r):
                hirsch.append(b)
            else:
                buckets.setdefault(r, []).append(b)

    for r, idxs in sorted(buckets.items()):
        for sel in launch_chunks(idxs, Lq, Lt, r, kernel):
            seld = torch.from_numpy(sel).to(dev)
            with trace_range("aligner.myers.banded"):
                _, tb = nw_fn(qd[seld], qld[seld], td[seld], tld[seld], r)
                if packed:
                    paths.add(sel, *decode_packed(tb, qld[seld], tld[seld],
                                                  r, kernel))
                    continue
                sub = decode_fn(tb, qld[seld], tld[seld], r)
            for b, p in zip(sel, sub):
                paths[b] = p
    # the distance stays the Myers score, which the path's cost equals
    if not packed:
        _hirschberg_into(paths, None, hirsch, queries, targets, device,
                         kernel)
    elif hirsch:
        with trace_range("aligner.hirschberg"):
            paths.extend(hirschberg_align_packed(
                [queries[b] for b in hirsch], [targets[b] for b in hirsch],
                device, kernel), hirsch)
    return paths, dists


def banded_escalate_align_batch(q: np.ndarray, qlen: np.ndarray,
                                t: np.ndarray, tlen: np.ndarray,
                                queries: list[str], targets: list[str],
                                device, kernel: str = "diag"
                                ) -> tuple[list[list[int]], np.ndarray]:
    """Score-free variant of :func:`myers_align_batch`, same arguments and
    results (see the module docstring)."""
    nw_fn, decode_fn = resolve(device, kernel)
    dev = torch.device(device)
    B, Lq = q.shape
    Lt = t.shape[1]
    qd, qld, td, tld = (torch.from_numpy(a).to(dev)
                        for a in (q, qlen, t, tlen))
    paths: list[list[int]] = [[] for _ in range(B)]
    dists = np.zeros(B, np.int64)

    r_of: dict[int, int] = {}
    hirsch: list[int] = []
    with trace_range("aligner.route"):
        for b in range(B):
            if qlen[b] == 0 and tlen[b] == 0:
                continue
            lq, lt = int(qlen[b]), int(tlen[b])
            r = int(pow2_at_least(max(abs(lq - lt), (lq + lt) // 12, 8)))
            while routes_to_hirschberg(Lq, r) and r > 8:
                r //= 2        # start at the largest radius that stays banded
            if routes_to_hirschberg(Lq, r):
                hirsch.append(b)
            else:
                r_of[b] = r
    count("escalate.pairs", len(r_of))

    while r_of:
        buckets: dict[int, list[int]] = {}
        for b, r in r_of.items():
            buckets.setdefault(r, []).append(b)
        r_of = {}
        for r, idxs in sorted(buckets.items()):
            for sel in launch_chunks(idxs, Lq, Lt, r, kernel):
                seld = torch.from_numpy(sel).to(dev)
                with trace_range("aligner.banded_escalate.nw"):
                    sc, tb = nw_fn(qd[seld], qld[seld], td[seld], tld[seld],
                                   r)
                    sc = to_host(sc).numpy()
                resolved = sc <= r
                if resolved.any():
                    with trace_range("aligner.banded_escalate.decode"):
                        sub = decode_fn(tb, qld[seld], tld[seld], r)
                with trace_range("aligner.route"):
                    for k, b in enumerate(sel):
                        if resolved[k]:
                            paths[b] = sub[k]
                            dists[b] = sc[k]
                        elif routes_to_hirschberg(Lq, 2 * r):
                            hirsch.append(int(b))
                        else:
                            r_of[int(b)] = 2 * r
                            count("escalate.retries")
    _hirschberg_into(paths, dists, hirsch, queries, targets, device, kernel)
    return paths, dists
