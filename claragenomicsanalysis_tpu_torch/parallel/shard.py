"""Sharded execution over a mesh of ranks (counterpart of
``claragenomicsanalysis_tpu/parallel/shard.py``).

Every function is SPMD: each rank of the mesh calls it with the same host
inputs and gets the whole, merged result (the JAX package's multi-process
branches re-replicate the same way).  The ranks run the port's own kernels
on their share, so nothing here is a kernel:

- ``data``: :func:`sharded_banded_nw` and :func:`sharded_poa` give each
  rank a contiguous slice of the problems or windows (the JAX split: a
  slice is ceil(n / ranks) long); merging is concatenation in order, so
  N ranks equal one rank bit for bit;
- ``rep``: the target index splits into sorted-representation blocks.
  :func:`sharded_match_chain` counts each block's anchors first, expands
  them, routes each anchor to the rank that owns its query read's range
  with one all_to_all, and chains there; chains cannot straddle ranks (a
  chain lives inside one (q_read, t_read, dir) group), so the union of the
  ranks' overlaps is the one-rank set.  :func:`sharded_anchors` gathers
  the blocks' anchors instead (route=False, and ``Matcher(mesh=)``).

The rep blocks keep the JAX package's bounds: the target is padded with
INVALID reps to its index capacity, max(1024, pow2(n_elems)) rounded to a
multiple of the ranks.  The bounds decide nothing unless a rank holds more
anchors than its capacity (EXCEEDED_MAX_ANCHORS), where a rank keeps the
first anchors of its block as a JAX shard does.  The 32-bit values travel
as int64 in [0, 2^32) and the routing expression is the JAX one (ROADMAP
C4).  Left out: ``pack2``, the JAX package's packed TPU chain sort (the
port has one chain path).
"""

from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist

from ..ops import map_ops
from ..ops.sketch import INVALID
from ..utils.mathutils import round_up
from ..utils.profiling import to_host, trace_range
from . import comm


def shard_slice(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``parts`` contiguous parts of n items, each
    ceil(n / parts) long (the last ones shorter or empty)."""
    per = -(-n // parts)
    return slice(min(index * per, n), min((index + 1) * per, n))


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


# ------------------------------------------------------------------ data


def sharded_banded_nw(q, qlen, t, tlen, band_radius, mesh, device="cuda",
                      kernel: str = "diag"):
    """Banded NW with the batch split over 'data': each rank aligns its
    slice (models.aligner.banded_align: B1 + B2, or B3 + B2-row for
    ``kernel="row"``) and the slices' results are gathered in pair order.
    ``band_radius``: one radius, or one a pair.  -> (scores (B,) int64,
    paths), equal to one rank's; the JAX function returns the traceback
    instead, which is the kernel's own layout here."""
    from ..models.aligner import banded_align
    B = q.shape[0]
    radii = np.broadcast_to(np.asarray(band_radius, np.int64), (B,))
    sl = shard_slice(B, mesh.shape["data"], mesh.axis_index("data"))
    scores, paths = banded_align(q[sl], qlen[sl], t[sl], tlen[sl], radii[sl],
                                 device, kernel)
    return gather_paths(scores, paths, mesh.group("data"), device)


def gather_paths(scores: np.ndarray, paths: list, group, device):
    """Every rank's (scores, paths) of its slice, concatenated in group
    rank order: the paths travel as one code array and their lengths."""
    lens = np.array([len(p) for p in paths], dtype=np.int64)
    codes = np.concatenate([np.asarray(p, dtype=np.int8) for p in paths]
                           + [np.zeros(0, np.int8)])
    dev = torch.device(device)
    scores, lens, codes = (to_host(comm.all_gather_cat(
        torch.from_numpy(a).to(dev), group)).numpy()
        for a in (scores, lens, codes))
    ends = np.cumsum(lens)
    return scores, [codes[e - n:e].tolist() for e, n in zip(ends, lens)]


def sharded_poa(program, seqs, weights, lens, n_seqs, mesh):
    """Windows split over 'data': each rank runs ``program(seqs, weights,
    lens, n_seqs)`` (NumPy arrays of its slice -> a tuple of tensors with
    a leading window dimension: models.poa's route, lockstep or one kernel
    a window) and the slices' outputs are gathered in window order.  The
    window count is padded with empty windows to a multiple of the ranks,
    as the JAX function pads it.  -> the outputs as NumPy arrays."""
    n = mesh.shape["data"]
    W = seqs.shape[0]
    pad = round_up(W, n) - W

    def padw(x, fill):
        x = np.asarray(x)
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)]) if pad else x

    args = [padw(seqs, -1), padw(weights, 0), padw(lens, 0), padw(n_seqs, 0)]
    sl = shard_slice(W + pad, n, mesh.axis_index("data"))
    out = program(*(a[sl] for a in args))
    group = mesh.group("data")
    return tuple(to_host(comm.all_gather_cat(o, group)).numpy()[:W]
                 for o in out)


# ------------------------------------------------------------------- rep


def _chain_kwargs(cfg) -> dict:
    frac = Fraction(cfg.min_overlap_fraction).limit_denominator(10**6)
    return dict(k=cfg.kmer_size, min_residues=cfg.min_residues,
                min_overlap_len=cfg.min_overlap_len,
                min_bases_per_residue=cfg.min_bases_per_residue,
                min_overlap_fraction_num=frac.numerator,
                min_overlap_fraction_den=frac.denominator,
                max_gap=cfg.max_anchor_gap)


def _pad_target_for_rep(tidx_arrays: dict, n_rep: int) -> dict:
    """The sorted target element arrays padded to the JAX index capacity
    (max(1024, pow2(n_elems))) rounded to a multiple of n_rep, with
    rep = INVALID at the tail, so no query rep ever selects them."""
    Ct = tidx_arrays["rep"].shape[0]
    Ctp = round_up(max(1024, _pow2(Ct)), n_rep)
    out = {}
    for k, v in tidx_arrays.items():
        if k == "n_elems":
            out[k] = v
            continue
        fill = INVALID if k == "rep" else 0
        out[k] = torch.cat([v, v.new_full((Ctp - Ct,), fill)])
    return out


def _rep_block(tidx_arrays: dict, mesh) -> dict:
    """This rank's block of the padded target: block r of n_rep equal
    contiguous blocks."""
    n_rep = mesh.shape["rep"]
    tpad = _pad_target_for_rep(tidx_arrays, n_rep)
    Cb = tpad["rep"].shape[0] // n_rep
    r = mesh.axis_index("rep")
    return {k: v if k == "n_elems" else v[r * Cb:(r + 1) * Cb]
            for k, v in tpad.items()}


_ANCHOR_FIELDS = ("q_read", "t_read", "q_pos", "t_pos", "dir", "valid")


def sharded_anchors(qidx_arrays: dict, tidx_arrays: dict, cfg, mesh,
                    cap: int = 1 << 18):
    """Rep-sharded anchor generation: each rank expands the anchors of its
    target block, at most round_up(cap, n_rep) of them (``cap`` is the
    per-rank capacity, as in the JAX function), and every rank gets all
    blocks' anchors in block order.  -> (anchors dict, total, overflow) as
    ops.map_ops.match_anchors."""
    n_rep = mesh.shape["rep"]
    group = mesh.group("rep")
    tblock = _rep_block(tidx_arrays, mesh)
    cap_local = round_up(cap, n_rep)
    lo, cum, total = map_ops.match_count(qidx_arrays, tblock)
    total = int(to_host(total))
    anchors = map_ops.match_expand(qidx_arrays, tblock, lo, cum,
                                   cap=min(total, cap_local),
                                   skip_self=cfg.skip_self_mappings)
    stacked = torch.stack([anchors[f].to(torch.int32)
                           for f in _ANCHOR_FIELDS], 1)
    stacked = comm.all_gather_cat(stacked, group)
    anchors = {f: stacked[:, i] for i, f in enumerate(_ANCHOR_FIELDS)}
    anchors["valid"] = anchors["valid"].bool()
    local = torch.tensor([total, int(total > cap_local)],
                         device=stacked.device)
    totals = to_host(comm.all_reduce(local, group))
    return anchors, int(totals[0]), bool(totals[1])


def _query_range(qidx_arrays: dict, n_query_reads, first_read):
    """(first query read id, query read count), derived from the index's
    read ids where the caller gives neither (the JAX unpacked-index rule)."""
    if first_read is None or n_query_reads is None:
        rid = qidx_arrays["read_id"]
        ne = rid.shape[0]
        lo = int(rid.min()) if ne else 0
        if first_read is None:
            first_read = lo
            if n_query_reads is None:
                n_query_reads = int(rid.max()) + 1 - lo if ne else 1
        if n_query_reads is None:
            n_query_reads = max(int(rid.max()) + 1 - first_read, 1) \
                if ne else 1
    return first_read, max(n_query_reads, 1)


def _dest(q_read: torch.Tensor, qid0: int, n_reads: int, n_rep: int):
    """The rank that owns query read ``q_read``: the JAX expression
    clip((q_read - qid0) * n_rep // n_reads, 0, n_rep - 1)."""
    d = torch.div((q_read.to(torch.int64) - qid0) * n_rep, n_reads,
                  rounding_mode="floor")
    return d.clamp(0, n_rep - 1)


def _routed_sizes(qidx_arrays: dict, tblock: dict, qid0: int, n_reads: int,
                  n_rep: int, group):
    """The counting pre-pass: this rank's (lo, cum) of its block, and every
    rank's anchor total and anchors a destination rank (counted before
    skip_self, so upper bounds): -> (lo, cum, totals (n_rep,), buckets
    (n_rep, n_rep))."""
    lo, cum, total = map_ops.match_count(qidx_arrays, tblock)
    cnt = cum[1:] - cum[:-1]
    dest = _dest(qidx_arrays["read_id"], qid0, n_reads, n_rep)
    buckets = torch.zeros(n_rep, dtype=torch.int64,
                          device=cnt.device).index_add_(0, dest, cnt)
    sizes = to_host(comm.all_gather_cat(
        torch.cat([total.reshape(1), buckets])[None], group))
    return lo, cum, sizes[:, 0], sizes[:, 1:]


def sharded_match_chain(qidx_arrays: dict, tidx_arrays: dict, cfg, mesh,
                        cap: int = 1 << 18, route: bool = True,
                        n_query_reads: int | None = None,
                        first_read: int | None = None):
    """Rep-sharded matching and query-sharded chaining over 'rep'.

    route=True: each rank expands its block's anchors at the capacity the
    counting pre-pass gives (cap_local = min(max(1024, pow2(the largest
    rank total)), max(1024, pow2(cap)))), sends each to the rank that owns
    its query read with one all_to_all of equal-size buckets, and chains
    the anchors it receives.  -> (this rank's masked chain output, on its
    device: the ops.map_ops.chain_anchors dict of the overlaps whose query
    reads it owns; overflow), where overflow means the anchor total passes
    ``cap`` (EXCEEDED_MAX_ANCHORS).  ``Overlapper.compact_rows(out, mesh)``
    merges the ranks' rows.

    route=False: the blocks' anchors are gathered (:func:`sharded_anchors`)
    and every rank chains all of them; -> (the whole masked output as NumPy
    arrays, overflow)."""
    n_rep = mesh.shape["rep"]
    group = mesh.group("rep")
    if not route:
        anchors, _, overflow = sharded_anchors(
            qidx_arrays, tidx_arrays, cfg, mesh, cap=cap // n_rep)
        out = map_ops.chain_anchors(anchors, **_chain_kwargs(cfg))
        return {k: to_host(v).numpy() for k, v in out.items()}, overflow

    qid0, n_reads = _query_range(qidx_arrays, n_query_reads, first_read)
    tblock = _rep_block(tidx_arrays, mesh)
    lo, cum, totals, buckets = _routed_sizes(qidx_arrays, tblock, qid0,
                                             n_reads, n_rep, group)
    overflow_cap = int(totals.sum()) > cap
    cap_local = min(max(1024, _pow2(totals.max())), max(1024, _pow2(cap)))
    # a bucket never holds more than the pre-pass counted, so the buckets
    # are sized to the largest count (no anchor is dropped in the exchange)
    c_send = max(1, min(int(buckets.max()), cap_local))
    total = int(totals[mesh.axis_index("rep")])
    overflow = total > cap_local
    anchors = map_ops.match_expand(qidx_arrays, tblock, lo, cum,
                                   cap=min(total, cap_local),
                                   skip_self=cfg.skip_self_mappings)
    with trace_range("mapper.all_to_all"):
        routed = _route(anchors, qid0, n_reads, n_rep, c_send, group)
    out = map_ops.chain_anchors(routed, **_chain_kwargs(cfg))
    flag = comm.all_reduce(torch.tensor([int(overflow)], device=lo.device),
                           group, op=dist.ReduceOp.MAX)
    return out, bool(to_host(flag)[0]) or overflow_cap


def _route(anchors: dict, qid0: int, n_reads: int, n_rep: int,
           c_send: int, group) -> dict:
    """Each valid anchor to the rank that owns its query read: buckets of
    c_send rows (4 int32 words: q_read, t_read, dir << 30 | q_pos, t_pos;
    q_read = -1 marks an empty row), one all_to_all; -> the received
    anchors, n_rep * c_send rows with their ``valid`` mask."""
    v = anchors["valid"]
    dev = v.device
    words = torch.stack([anchors["q_read"].to(torch.int32),
                         anchors["t_read"].to(torch.int32),
                         (anchors["dir"].to(torch.int32) << 30)
                         | anchors["q_pos"].to(torch.int32),
                         anchors["t_pos"].to(torch.int32)], 1)
    dest = torch.where(v, _dest(anchors["q_read"], qid0, n_reads, n_rep),
                       n_rep)                  # invalid rows park past the end
    _, perm = torch.sort(dest, stable=True)
    counts = torch.bincount(dest, minlength=n_rep + 1)[:n_rep]
    offs = torch.cumsum(counts, 0) - counts
    j = torch.arange(c_send, device=dev)
    in_bucket = j[None, :] < counts[:, None]                 # (n_rep, c_send)
    buf = torch.full((n_rep, c_send, 4), -1, dtype=torch.int32, device=dev)
    if perm.numel():
        src = perm[(offs[:, None] + j[None, :]).clamp(max=perm.numel() - 1)]
        buf = torch.where(in_bucket[..., None], words[src], buf)
    got = comm.all_to_all(buf, group).reshape(-1, 4)
    return {"q_read": got[:, 0], "t_read": got[:, 1],
            "q_pos": got[:, 2] & ((1 << 30) - 1), "t_pos": got[:, 3],
            "dir": got[:, 2] >> 30, "valid": got[:, 0] >= 0}
