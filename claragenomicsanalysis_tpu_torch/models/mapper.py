"""All-vs-all minimizer overlap mapper on PyTorch (counterpart of
``claragenomicsanalysis_tpu/models/mapper.py``, the cudamapper equivalent).

The surface is the JAX package's: ``Index.create_index`` /
``Matcher.create_matcher`` / ``Overlapper``, the all-vs-all and
query-vs-target drivers with index batching and host index caching, and
PAF output.  Sketch, index sort, matching and chaining are torch ops on the
entry point's device (ops/sketch.py, ops/map_ops.py); the drivers loop over
(query chunk x target chunk) pairs and merge the rows in canonical
Overlap.key() order, so the output is identical for any batching and equal
to the JAX package's.

Each pair syncs its true anchor count and expands exactly that many anchors
(at most ``max_anchors``; a pair past it keeps the anchors the JAX
expansion keeps and reports EXCEEDED_MAX_ANCHORS).  Left out on purpose:
the JAX package's capacity and count hints, its one-pair-behind download,
its pow2 padding of batches, reads and index capacities and its prefetch
thread, which exist for the TPU's transfer path and ``jit``.
"""

from collections import Counter
from dataclasses import dataclass, replace
from fractions import Fraction

import numpy as np
import torch

from ..core.config import MapperConfig
from ..core.status import StatusType
from ..core.types import Overlap
from ..io.fasta import FastaParser
from ..io.paf import format_paf_row
from ..ops import map_ops, sketch
from ..utils.genomeutils import encode, reverse_complement
from ..utils.mathutils import round_up
from ..utils.profiling import to_host, trace_range


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; RuntimeError for CUDA without a card,
    ValueError for anything but CUDA and the CPU (there is no fallback)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch finds no "
                               "CUDA device")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def kmerize(seq: str, k: int) -> Counter:
    """Multiset of the k-mers of seq (reference: cudamapper_utils.cpp
    kmerize [U]; host-side helper, used by overlap-end rescue)."""
    if k <= 0 or len(seq) < k:
        return Counter()
    return Counter(seq[i: i + k] for i in range(len(seq) - k + 1))


#: ASCII -> 2-bit base code for the vectorized similarity path (uppercase
#: ACGT only; anything else routes to the exact Counter fallback)
_SIM_CODE = np.full(256, -1, dtype=np.int64)
for _i, _c in enumerate("ACGT"):
    _SIM_CODE[ord(_c)] = _i


def _kmer_hist(codes: np.ndarray, k: int) -> np.ndarray:
    """Histogram of 2-bit-packed k-mer values over 4**k bins."""
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    vals = win @ (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
    return np.bincount(vals, minlength=4 ** k)


def sequence_similarity(a: str, b: str, k: int = 4) -> float:
    """Shared-k-mer fraction: |kmers(a) & kmers(b)| / min(#kmers) in [0, 1]
    (reference: cudamapper_utils similarity helper [U]; exact formula is OURS,
    documented here: multiset intersection over the shorter k-mer count).

    Long pure-uppercase-ACGT inputs with k <= 8 take a vectorized path
    (2-bit k-mer codes + bincount + elementwise min); short or non-ACGT
    inputs keep the string-multiset Counter, which measures faster below
    a few hundred bases (numpy call overhead dominates tiny flanks — the
    per-overlap scale fix for rescue_overlap_ends is the BATCHED
    _similarity_batch below, not this function)."""
    if k <= 0 or len(a) < k or len(b) < k:
        return 0.0
    if k <= 8 and min(len(a), len(b)) >= 256:
        ca = _SIM_CODE[np.frombuffer(a.encode(), dtype=np.uint8)]
        cb = _SIM_CODE[np.frombuffer(b.encode(), dtype=np.uint8)]
        if ca.min() >= 0 and cb.min() >= 0:
            shared = int(np.minimum(_kmer_hist(ca, k), _kmer_hist(cb, k))
                         .sum())
            return shared / min(len(a) - k + 1, len(b) - k + 1)
    ka, kb = kmerize(a, k), kmerize(b, k)
    if not ka or not kb:
        return 0.0
    shared = sum((ka & kb).values())
    return shared / min(sum(ka.values()), sum(kb.values()))


def _similarity_batch(pairs: list[tuple[str, str]], k: int) -> np.ndarray:
    """sequence_similarity over many (a, b) pairs at once — the scale path
    for rescue_overlap_ends (one Counter multiset per flank cost ~35 us;
    at ONT scale the rescue pass has 10^5..10^6 flank pairs).

    Pure-uppercase-ACGT pairs batch through padded 2-bit k-mer codes and
    one flat bincount per row chunk; anything else falls back to the
    Counter path per pair.  Results equal sequence_similarity exactly."""
    n = len(pairs)
    sims = np.zeros(n, dtype=np.float64)
    if n == 0:
        return sims

    def fallback(idxs):
        for i in idxs:
            sims[i] = sequence_similarity(*pairs[i], k)

    if k <= 0 or k > 8:
        fallback(range(n))
        return sims
    try:                                    # one encode of ALL flanks
        a_bytes = "".join(a for a, _ in pairs).encode("ascii")
        b_bytes = "".join(b for _, b in pairs).encode("ascii")
    except UnicodeEncodeError:              # exotic chars: exact slow path
        fallback(range(n))
        return sims
    la = np.fromiter((len(a) for a, _ in pairs), np.int64, n)
    lb = np.fromiter((len(b) for _, b in pairs), np.int64, n)
    ca = _SIM_CODE[np.frombuffer(a_bytes, dtype=np.uint8)]
    cb = _SIM_CODE[np.frombuffer(b_bytes, dtype=np.uint8)]

    def seg_ok(codes, lens):
        """per-row all-ACGT flag, without per-row numpy calls"""
        ok = np.ones(n, dtype=bool)
        nz = np.flatnonzero(lens > 0)
        if nz.size:
            # reduceat over the NONZERO rows' offsets only: they are
            # strictly increasing and in-bounds, and each segment then
            # spans exactly that row's codes (empty rows contribute no
            # codes), so the last row's final character is never dropped
            offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
            ok[nz] = np.minimum.reduceat(codes, offs[nz]) >= 0
        return ok

    fast = (la >= k) & (lb >= k) & seg_ok(ca, la) & seg_ok(cb, lb)
    fallback(np.flatnonzero(~fast & (la >= k) & (lb >= k)))
    fi = np.flatnonzero(fast)
    if fi.size == 0:
        return sims
    nbins = 4 ** k
    pows = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)

    def row_vals(codes, lens):
        """(sum nwin,) valid k-mer values + per-row window counts: windows
        slide over the FLAT concatenation once; per-row windows are the
        offs[i]..offs[i]+len-k slice (cross-segment windows never get
        selected), so no padded matrix or scatter is ever built."""
        if codes.size < k:
            return np.zeros(0, np.int64), np.zeros(fi.size, np.int64)
        flat = np.lib.stride_tricks.sliding_window_view(codes, k) @ pows
        offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
        nwin = lens[fi] - k + 1
        total = int(nwin.sum())
        starts = np.concatenate([[0], np.cumsum(nwin)[:-1]])
        local = np.arange(total, dtype=np.int64) - np.repeat(starts, nwin)
        return flat[np.repeat(offs[fi], nwin) + local], nwin

    va, na = row_vals(ca, la)
    vb, nb = row_vals(cb, lb)
    # small slices keep the two dense histograms cache-resident (the
    # min+sum over them is the memory-bound step): ~0.5M bins ~= 4 MB
    CHUNK = max(1, (1 << 19) // nbins)
    ra = np.concatenate([[0], np.cumsum(na)])
    rb = np.concatenate([[0], np.cumsum(nb)])
    rowid_a = np.repeat(np.arange(fi.size) % CHUNK, na)
    rowid_b = np.repeat(np.arange(fi.size) % CHUNK, nb)
    for s in range(0, fi.size, CHUNK):
        e = min(s + CHUNK, fi.size)
        ha = np.bincount(rowid_a[ra[s]:ra[e]] * nbins + va[ra[s]:ra[e]],
                         minlength=(e - s) * nbins).reshape(e - s, nbins)
        hb = np.bincount(rowid_b[rb[s]:rb[e]] * nbins + vb[rb[s]:rb[e]],
                         minlength=(e - s) * nbins).reshape(e - s, nbins)
        shared = np.minimum(ha, hb).sum(axis=1)
        sims[fi[s:e]] = shared / np.minimum(na[s:e], nb[s:e])
    return sims


class Index:
    """Minimizer index over parser reads [first, past_last): the sorted
    sketch elements' arrays on the device, sliced to ``n_elems``."""

    def __init__(self, arrays: dict, first_read_id: int,
                 read_lengths: list[int], read_names: list[str]):
        self._arrays = arrays
        self.first_read_id = first_read_id
        self.read_lengths = read_lengths
        self.read_names = read_names

    @classmethod
    def create_index(cls, parser: FastaParser, first_read: int,
                     past_last_read: int, cfg: MapperConfig,
                     device="cuda") -> "Index":
        device = resolve_device(device)
        recs = [parser.get_sequence_by_id(i)
                for i in range(first_read, past_last_read)]
        k, w = cfg.kmer_size, cfg.window_size
        L = max(max((len(r.seq) for r in recs), default=k), k)
        reads = np.full((max(len(recs), 1), L), -1, dtype=np.int8)
        lens = np.zeros(max(len(recs), 1), dtype=np.int64)
        for i, r in enumerate(recs):
            reads[i, : len(r.seq)] = encode(r.seq)
            lens[i] = len(r.seq)
        with trace_range("mapper.sketch"):
            rep, dirs, is_min = sketch.sketch_batch(
                torch.from_numpy(reads).to(device),
                torch.from_numpy(lens).to(device), k, w,
                cfg.hash_representations)
        frac = Fraction(cfg.filtering_parameter).limit_denominator(10**6)
        with trace_range("mapper.index_sort"):
            arrays = map_ops.build_index(
                rep, dirs, is_min, first_read,
                filter_thr_num=frac.numerator,
                filter_thr_den=frac.denominator)
            arrays = _sliced(arrays)
        return cls(arrays, first_read, [len(r.seq) for r in recs],
                   [r.name for r in recs])

    # --- reference-parity array views ------------------------------------
    @property
    def n_elems(self) -> int:
        return self._arrays["n_elems"]

    def representations(self) -> np.ndarray:
        return to_host(self._arrays["rep"]).numpy().astype(np.uint32)

    def read_ids(self) -> np.ndarray:
        return to_host(self._arrays["read_id"]).numpy()

    def positions_in_reads(self) -> np.ndarray:
        return to_host(self._arrays["pos"]).numpy()

    def directions_of_reads(self) -> np.ndarray:
        return to_host(self._arrays["dir"]).numpy()

    def unique_representations(self) -> np.ndarray:
        return np.unique(self.representations())

    def first_occurrence_of_representations(self) -> np.ndarray:
        _, first = np.unique(self.representations(), return_index=True)
        return np.sort(first)

    def number_of_reads(self) -> int:
        return len(self.read_lengths)

    def to(self, device) -> "Index":
        """This index with its arrays on ``device`` (itself if there)."""
        device = resolve_device(device)
        if self._arrays["rep"].device == device:
            return self
        return Index({k: v if k == "n_elems" else v.to(device)
                      for k, v in self._arrays.items()}, self.first_read_id,
                     self.read_lengths, self.read_names)


def _sliced(arrays: dict) -> dict:
    """An index's arrays cut to their n_elems leading rows (the rest are
    INVALID and never match), with n_elems as an int."""
    n = int(arrays["n_elems"])
    return {"rep": arrays["rep"][:n], "read_id": arrays["read_id"][:n],
            "pos": arrays["pos"][:n], "dir": arrays["dir"][:n],
            "n_elems": n}


class IndexCache:
    """Host-side index cache: avoids re-sketching a read range reused across
    (query chunk x target chunk) pairs.

    ``store_dir`` adds the on-disk layer (parallel/index_store.py): misses
    first try the content-keyed .npz store, and freshly built indices are
    saved to it -- a compute cache across runs and a resume point."""

    def __init__(self, max_entries: int = 64, store_dir: str | None = None,
                 device="cuda"):
        self._cache: dict[tuple, Index] = {}
        self._order: list[tuple] = []
        self._max = max_entries
        self.store_dir = store_dir
        self.device = resolve_device(device)
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    def get_or_create(self, parser, first: int, past_last: int,
                      cfg: MapperConfig) -> Index:
        key = (id(parser), first, past_last, cfg.kmer_size, cfg.window_size,
               cfg.hash_representations, cfg.filtering_parameter)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        idx = None
        if self.store_dir:
            from ..parallel.index_store import index_key, load_index
            skey = index_key(parser, first, past_last, cfg)
            idx = load_index(self.store_dir, skey, device=self.device)
            if idx is not None:
                self.disk_hits += 1
        if idx is None:
            idx = Index.create_index(parser, first, past_last, cfg,
                                     device=self.device)
            from ..parallel.multihost import is_writer
            if self.store_dir and is_writer():      # rank 0 alone writes
                from ..parallel.index_store import index_key, save_index
                save_index(idx, self.store_dir,
                           index_key(parser, first, past_last, cfg))
        if len(self._order) >= self._max:
            old = self._order.pop(0)
            self._cache.pop(old, None)
        self._cache[key] = idx
        self._order.append(key)
        return idx


class Matcher:
    """Anchors between two indices."""

    def __init__(self, anchors: dict, n_anchors: int, cap_used: int,
                 hard_cap: int):
        self._anchors = anchors
        self.n_anchors = n_anchors      # the true count, synced
        self.cap_used = cap_used
        self._hard_cap = hard_cap

    @property
    def overflow(self) -> bool:
        return self.n_anchors > self._hard_cap

    @property
    def status(self) -> StatusType:
        return (StatusType.EXCEEDED_MAX_ANCHORS if self.overflow
                else StatusType.SUCCESS)

    @property
    def truncated(self) -> bool:
        """True when anchors the hard cap admits were dropped; never here,
        since the expansion is sized to the true count."""
        return self.cap_used < self.n_anchors <= self._hard_cap

    @classmethod
    def create_matcher(cls, query_index: Index, target_index: Index,
                       cfg: MapperConfig, cap: int | None = None,
                       device="cuda", mesh=None) -> "Matcher":
        """Anchors of every (query element, target element) pair of equal
        representation, at most ``cap`` of them (default: four times the
        query index's capacity, max(1024, pow2(n_elems)), as in the JAX
        package).  ``mesh`` with a 'rep' axis > 1: the target index splits
        into sorted-representation blocks over its ranks, each rank counts
        and expands its block's anchors (at most ``cap`` a rank, as in the
        JAX package) and every rank gets all blocks' anchors
        (parallel/shard.sharded_anchors); below the cap the anchor set, and
        all output, is the one-rank set."""
        device = resolve_device(device)
        qa = query_index.to(device)._arrays
        ta = target_index.to(device)._arrays
        if cap is None:
            cp = max(1024, 1 << (max(qa["n_elems"], 1) - 1).bit_length())
            cap = round_up(4 * cp, 128)
        with trace_range("mapper.match"):
            if rep_sharded(mesh):
                from ..parallel.shard import sharded_anchors
                anchors, total, _ = sharded_anchors(qa, ta, cfg, mesh,
                                                    cap=cap)
                return cls(anchors, total, min(cap, total), cap)
            with trace_range("mapper.match.count"):
                lo, cum, total = map_ops.match_count(qa, ta)
                total = int(to_host(total))
            cap_eff = min(cap, total)
            with trace_range("mapper.match.expand"):
                anchors = map_ops.match_expand(
                    qa, ta, lo, cum, cap=cap_eff,
                    skip_self=cfg.skip_self_mappings)
        return cls(anchors, total, cap_eff, cap)

    def anchors(self) -> dict:
        return self._anchors

    def anchors_host(self) -> dict:
        return {k: to_host(v).numpy() for k, v in self._anchors.items()}


def _canonical_order(rows: np.ndarray) -> np.ndarray:
    """Overlap.key() order as one numpy lexsort over (8, n) overlap rows
    (lexsort keys are least-significant first)."""
    return np.lexsort((rows[5], rows[3], rows[4], rows[2], rows[7],
                       rows[1], rows[0]))


class Overlapper:
    """Triggered chaining and the overlap filters."""

    @staticmethod
    def get_overlap_rows(anchors: dict, cfg: MapperConfig) -> np.ndarray:
        """Chained overlaps as an (8, n) int32 host array in canonical
        Overlap.key() order (rows: q_read, t_read, q_start, q_end, t_start,
        t_end, n_residues, strand01).  The array form is the scale path:
        per-overlap Python objects would dominate at millions of rows."""
        frac = Fraction(cfg.min_overlap_fraction).limit_denominator(10**6)
        with trace_range("mapper.chain"):
            out = map_ops.chain_anchors(
                anchors, k=cfg.kmer_size, min_residues=cfg.min_residues,
                min_overlap_len=cfg.min_overlap_len,
                min_bases_per_residue=cfg.min_bases_per_residue,
                min_overlap_fraction_num=frac.numerator,
                min_overlap_fraction_den=frac.denominator,
                max_gap=cfg.max_anchor_gap)
        return Overlapper.compact_rows(out)

    @staticmethod
    def compact_rows(out: dict, mesh=None) -> np.ndarray:
        """A masked chain output (ops.map_ops.chain_anchors, on the device)
        as the canonical (8, n_valid) host rows.  ``mesh`` with a 'rep'
        axis > 1: ``out`` is this rank's part of a routed chain
        (parallel/shard.sharded_match_chain), and every rank gets the rows
        of all its rep line's ranks."""
        with trace_range("mapper.compact"):
            rows = map_ops.compact_overlaps_gather(
                out, int(to_host(map_ops.count_valid(out))))
            if rep_sharded(mesh):
                from ..parallel.comm import all_gather
                rows = torch.cat(all_gather(rows.T, mesh.group("rep")),
                                 0).T
            rows = to_host(rows).numpy()
        return rows[:, _canonical_order(rows)]

    @staticmethod
    def compact_rows_local(out: dict, mesh) -> dict:
        """This rank's part of a routed chain as {its rep index: canonical
        (8, n_valid) rows}, on the rank that owns the part (data and sp
        coordinates 0; the others, copies, get {}).  No rank holds the
        whole overlap set.  Each rank owns a disjoint ascending range of
        query reads, so the parts in rep order are compact_rows(out, mesh)."""
        if mesh.axis_index("data") or mesh.axis_index("sp"):
            return {}
        with trace_range("mapper.compact_local"):
            rows = to_host(map_ops.compact_overlaps_gather(
                out, int(to_host(map_ops.count_valid(out))))).numpy()
        return {mesh.axis_index("rep"): rows[:, _canonical_order(rows)]}

    @staticmethod
    def rows_to_overlaps(rows: np.ndarray) -> list[Overlap]:
        with trace_range("mapper.overlaps"):
            cols = rows.T.tolist()          # one bulk int conversion
            return [Overlap(c[0], c[1], c[2], c[3], c[4], c[5], c[6],
                            "+" if c[7] == 0 else "-") for c in cols]

    @staticmethod
    def overlaps_to_rows(overlaps: list[Overlap]) -> np.ndarray:
        """:meth:`rows_to_overlaps` undone: (8, n) int64 rows."""
        return np.array([[o.query_read_id, o.target_read_id,
                          o.query_start_position_in_read,
                          o.query_end_position_in_read,
                          o.target_start_position_in_read,
                          o.target_end_position_in_read, o.num_residues,
                          0 if o.relative_strand == "+" else 1]
                         for o in overlaps], np.int64).reshape(-1, 8).T

    @staticmethod
    def get_overlaps(anchors: dict, cfg: MapperConfig) -> list[Overlap]:
        return Overlapper.rows_to_overlaps(
            Overlapper.get_overlap_rows(anchors, cfg))

    @staticmethod
    def filter_overlaps(overlaps: list[Overlap], min_residues: int = 0,
                        min_overlap_len: int = 0) -> list[Overlap]:
        """Post-filter (reference: Overlapper::filter_overlaps [U]): drop
        overlaps below the residue / length thresholds.  Order-preserving."""
        return [o for o in overlaps
                if o.num_residues >= min_residues
                and (o.query_end_position_in_read
                     - o.query_start_position_in_read) >= min_overlap_len
                and (o.target_end_position_in_read
                     - o.target_start_position_in_read) >= min_overlap_len]

    @staticmethod
    def fuse_overlaps(overlaps: list[Overlap],
                      max_gap: int = 500) -> list[Overlap]:
        """Merge runs of overlaps on the same (query, target, strand) whose
        successive query/target gaps both fit within max_gap (reference:
        OverlapperTriggered fuses adjacent candidate overlaps [U]; exact
        rule OURS, documented here).  Canonical rule: overlaps are taken in
        Overlap.key() order; a candidate fuses into the previous fused
        overlap when query gap <= max_gap and strand-oriented target gap
        <= max_gap (negative gaps, i.e. overlapping spans, always fuse).
        The fused overlap covers the union of spans, sums num_residues and
        drops any per-part CIGAR."""
        out: list[Overlap] = []
        for o in sorted(overlaps, key=lambda o: o.key()):
            last = out[-1] if out else None
            if (last is not None
                    and last.query_read_id == o.query_read_id
                    and last.target_read_id == o.target_read_id
                    and last.relative_strand == o.relative_strand):
                qgap = (o.query_start_position_in_read
                        - last.query_end_position_in_read)
                if o.relative_strand == "+":
                    tgap = (o.target_start_position_in_read
                            - last.target_end_position_in_read)
                else:
                    # '-' chains walk the target backwards in query order
                    tgap = (last.target_start_position_in_read
                            - o.target_end_position_in_read)
                if qgap <= max_gap and tgap <= max_gap:
                    out[-1] = replace(
                        last,
                        query_end_position_in_read=max(
                            last.query_end_position_in_read,
                            o.query_end_position_in_read),
                        target_start_position_in_read=min(
                            last.target_start_position_in_read,
                            o.target_start_position_in_read),
                        target_end_position_in_read=max(
                            last.target_end_position_in_read,
                            o.target_end_position_in_read),
                        num_residues=last.num_residues + o.num_residues,
                        cigar="")
                    continue
            out.append(replace(o))
        return out

    @staticmethod
    def fuse_overlap_rows(rows: np.ndarray, max_gap: int = 500) -> np.ndarray:
        """fuse_overlaps on the (8, n) canonical-order row array — the
        scale path (no per-overlap dataclasses; the Python loop only walks
        group members, and row arithmetic is plain ints).  Result rows
        equal fuse_overlaps applied to the same overlaps (differential-
        tested), in the same canonical order: fusion only merges adjacent
        same-group rows, so group-local merging preserves global order."""
        n = rows.shape[1]
        if n == 0:
            return rows
        qid, tid, st = rows[0], rows[1], rows[7]
        new_grp = np.ones(n, dtype=bool)
        new_grp[1:] = ((qid[1:] != qid[:-1]) | (tid[1:] != tid[:-1])
                       | (st[1:] != st[:-1]))
        grp_starts = np.flatnonzero(new_grp)
        grp_ends = np.append(grp_starts[1:], n)
        out_cols: list[np.ndarray] = []
        R = np.ascontiguousarray(rows.T)        # (n, 8) row-wise
        for s, e in zip(grp_starts, grp_ends):
            if e - s == 1:
                out_cols.append(R[s])
                continue
            fused = R[s].copy()
            fwd = fused[7] == 0
            for i in range(s + 1, e):
                c = R[i]
                qgap = c[2] - fused[3]
                tgap = (c[4] - fused[5]) if fwd else (fused[4] - c[5])
                if qgap <= max_gap and tgap <= max_gap:
                    fused[3] = max(fused[3], c[3])
                    fused[4] = min(fused[4], c[4])
                    fused[5] = max(fused[5], c[5])
                    fused[6] += c[6]
                else:
                    out_cols.append(fused)
                    fused = c.copy()
            out_cols.append(fused)
        return np.stack(out_cols, axis=1)

    @staticmethod
    def rescue_overlap_ends(overlaps: list[Overlap], parser: FastaParser,
                            extension: int = 50,
                            required_similarity: float = 0.85,
                            k: int = 4) -> list[Overlap]:
        """Extend overlap ends into the unaligned read flanks when the two
        flanks look alike (reference: Overlapper::rescue_overlap_ends [U]).

        Canonical rule (OURS, documented): each end extends by
        e = min(extension, query flank, target flank) iff e >= k and
        sequence_similarity(query flank, strand-oriented target flank, k)
        >= required_similarity.  '-' overlaps pair the query head with the
        reverse-complemented target TAIL flank and vice versa (PAF keeps
        target coordinates on the forward strand).

        The two ends read disjoint coordinates, so all candidate flank
        pairs are collected first and scored in ONE _similarity_batch
        call (the per-overlap Counter loop dominated rescue at scale)."""
        cand: list[tuple[int, bool, int]] = []   # (overlap idx, is_head, e)
        flanks: list[tuple[str, str]] = []
        spans = []
        for bi, o in enumerate(overlaps):
            q = parser.get_sequence_by_id(o.query_read_id).seq
            t = parser.get_sequence_by_id(o.target_read_id).seq
            qs, qe = (o.query_start_position_in_read,
                      o.query_end_position_in_read)
            ts, te = (o.target_start_position_in_read,
                      o.target_end_position_in_read)
            spans.append([qs, qe, ts, te])
            fwd = o.relative_strand == "+"

            # head of the query pairs with target start (+) / target end (-)
            e = min(extension, qs, ts if fwd else len(t) - te)
            if e >= k:
                qf = q[qs - e: qs]
                tf = (t[ts - e: ts] if fwd
                      else reverse_complement(t[te: te + e]))
                cand.append((bi, True, e))
                flanks.append((qf, tf))
            # tail of the query pairs with target end (+) / target start (-)
            e = min(extension, len(q) - qe, len(t) - te if fwd else ts)
            if e >= k:
                qf = q[qe: qe + e]
                tf = (t[te: te + e] if fwd
                      else reverse_complement(t[ts - e: ts]))
                cand.append((bi, False, e))
                flanks.append((qf, tf))

        sims = _similarity_batch(flanks, k)
        for (bi, is_head, e), sim in zip(cand, sims):
            if sim < required_similarity:
                continue
            fwd = overlaps[bi].relative_strand == "+"
            sp = spans[bi]
            if is_head:
                sp[0] -= e                  # qs
                if fwd:
                    sp[2] -= e              # ts
                else:
                    sp[3] += e              # te
            else:
                sp[1] += e                  # qe
                if fwd:
                    sp[3] += e              # te
                else:
                    sp[2] -= e              # ts
        return [replace(
            o, query_start_position_in_read=sp[0],
            query_end_position_in_read=sp[1],
            target_start_position_in_read=sp[2],
            target_end_position_in_read=sp[3])
            for o, sp in zip(overlaps, spans)]


@dataclass
class MapResult:
    overlaps: list[Overlap]
    statuses: list[StatusType]
    cache_hits: int = 0
    cache_misses: int = 0
    #: the same overlaps as an (8, n) int32 array in canonical order --
    #: the scale surface (fuse_overlap_rows etc. avoid object costs)
    rows: np.ndarray | None = None


def rep_sharded(mesh) -> bool:
    """Whether matching shards over ``mesh``: it has more than one rank on
    its 'rep' axis."""
    return mesh is not None and mesh.shape.get("rep", 1) > 1


def pair_rows(qidx: Index, tidx: Index, cfg: MapperConfig, cap: int,
              device, mesh=None):
    """One (query chunk, target chunk) pair: Matcher then Overlapper, or,
    where matching shards over ``mesh`` (:func:`rep_sharded`),
    :func:`_mesh_overlap_rows`.  -> (canonical rows, status)."""
    if rep_sharded(mesh):
        return _mesh_overlap_rows(qidx, tidx, cfg, mesh, cap)
    matcher = Matcher.create_matcher(qidx, tidx, cfg, cap=cap, device=device)
    return (Overlapper.get_overlap_rows(matcher.anchors(), cfg),
            matcher.status)


def _mesh_overlap_rows(qidx: Index, tidx: Index, cfg: MapperConfig, mesh,
                       cap: int):
    """One chunk pair on a mesh: rep-sharded matching, anchors routed to
    the rank that owns their query reads, chained there
    (parallel/shard.sharded_match_chain), the ranks' rows merged.
    -> (canonical rows, every rank's; status)."""
    from ..parallel.shard import sharded_match_chain
    with trace_range("mapper.match_chain_mesh"):
        out, overflow = sharded_match_chain(
            qidx._arrays, tidx._arrays, cfg, mesh, cap=cap,
            n_query_reads=len(qidx.read_lengths),
            first_read=qidx.first_read_id)
    status = (StatusType.EXCEEDED_MAX_ANCHORS if overflow
              else StatusType.SUCCESS)
    return Overlapper.compact_rows(out, mesh), status


def _map_pairs(pairs, cfg: MapperConfig, max_anchors: int, device,
               cache: IndexCache, mesh=None) -> MapResult:
    """Index -> Matcher -> Overlapper over ((parser, first, past_last) x 2)
    pairs, merged in canonical order; each pair through :func:`pair_rows`."""
    statuses: list[StatusType] = []
    all_rows = []
    for (qp, qf, ql), (tp, tf, tl) in pairs:
        qidx = cache.get_or_create(qp, qf, ql, cfg)
        tidx = cache.get_or_create(tp, tf, tl, cfg)
        rows, status = pair_rows(qidx, tidx, cfg, max_anchors, device, mesh)
        statuses.append(status)
        all_rows.append(rows)
    with trace_range("mapper.merge"):
        rows = (np.concatenate(all_rows, axis=1) if all_rows
                else np.zeros((8, 0), np.int32))
        rows = rows[:, _canonical_order(rows)]
    return MapResult(Overlapper.rows_to_overlaps(rows), statuses, cache.hits,
                     cache.misses, rows=rows)


def map_all_vs_all(parser: FastaParser, cfg: MapperConfig,
                   max_anchors: int = 1 << 24,
                   index_store_dir: str | None = None,
                   device="cuda", mesh=None) -> MapResult:
    """The cudamapper main loop: chunk the reads by the index-size budget,
    run every (query chunk x target chunk) pair through Index -> Matcher ->
    Overlapper on ``device``, merge deterministically.  ``mesh``
    (parallel.mesh.make_mesh): matching shards over its 'rep' axis, every
    rank calling with the same reads and getting every overlap; the output
    equals one rank's bit for bit."""
    device = resolve_device(device)
    chunks = [(parser, f, p) for f, p in
              parser.get_chunks(cfg.index_size_mb * 1_000_000)]
    cache = IndexCache(store_dir=index_store_dir, device=device)
    return _map_pairs(((q, t) for q in chunks for t in chunks), cfg,
                      max_anchors, device, cache, mesh)


def map_query_vs_target(query_parser: FastaParser,
                        target_parser: FastaParser, cfg: MapperConfig,
                        max_anchors: int = 1 << 24,
                        target_index_size_mb: int | None = None,
                        index_store_dir: str | None = None,
                        device="cuda", mesh=None) -> MapResult:
    """Two-file mapping: every query read against every target read, with
    separate query / target index budgets (``target_index_size_mb``
    defaults to the query's).  Self-mapping suppression is off: equal
    numeric read ids in the two files are unrelated reads.  ``mesh``: as
    for :func:`map_all_vs_all`."""
    device = resolve_device(device)
    qchunks = [(query_parser, f, p) for f, p in
               query_parser.get_chunks(cfg.index_size_mb * 1_000_000)]
    t_mb = (target_index_size_mb if target_index_size_mb is not None
            else cfg.index_size_mb)
    tchunks = [(target_parser, f, p) for f, p in
               target_parser.get_chunks(t_mb * 1_000_000)]
    cfg = replace(cfg, skip_self_mappings=False)
    cache = IndexCache(store_dir=index_store_dir, device=device)
    return _map_pairs(((q, t) for q in qchunks for t in tchunks), cfg,
                      max_anchors, device, cache, mesh)


def overlaps_to_paf(overlaps: list[Overlap], parser: FastaParser,
                    target_parser: FastaParser | None = None) -> list[str]:
    """PAF rows; `target_parser` resolves target read names/lengths when
    the overlaps came from a two-file (query-vs-target) run."""
    tp = target_parser if target_parser is not None else parser
    rows = []
    for o in overlaps:
        q = parser.get_sequence_by_id(o.query_read_id)
        t = tp.get_sequence_by_id(o.target_read_id)
        rows.append(format_paf_row(o, q.name, len(q.seq), t.name, len(t.seq)))
    return rows
