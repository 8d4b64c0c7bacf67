"""Read correction on PyTorch (port of
``claragenomicsanalysis_tpu/models/correct.py``).

All-vs-all map -> per-overlap base-exact re-alignment -> per-read pileup
windows -> batched POA consensus -> corrected reads (Racon-style
polishing).  The mapper, the aligners and the POA batches run on the entry
point's device; the window supports are host NumPy, as in the JAX package.
``work_dir`` makes a run resumable: the mapping loop checkpoints each
(query chunk x target chunk) pair (parallel/manifest.py) and the correction
each part of reads, in the JAX package's files, and a killed run resumes to
the same result.  ``mesh`` splits into its two views
(parallel.mesh.axis_meshes): matching shards over every rank on 'rep'
(the resumable map too), POA windows over every rank on 'data'; the
alignments run whole on every rank, as in the JAX package.  The span and
depth buckets come from the whole input, never from a rank's share, and
rank 0 alone writes the checkpoint files.

Left out on purpose: ``core.bufferplan.plan_poa_batch`` and the one-behind
drain's TPU sizing.  A ``Batch`` cuts its own launches by the device bytes
a window needs (``models.poa.launch_chunks``); ``windows_per_dispatch``
still cuts the jobs into batches, and no cut changes a result.
"""

import json
import os
from dataclasses import dataclass

import numpy as np

from ..core.config import BatchSize, CorrectConfig
from ..core.status import StatusType
from ..core.types import Overlap
from ..io.fasta import FastaParser
from ..models.aligner import create_aligner
from ..models.mapper import map_all_vs_all, resolve_device
from ..models.pipeline import overlap_spans, span_buckets, within_length
from ..models.poa import POA_MEM_BUDGET as POA_MEM_BUDGET
from ..models.poa import create_batch
from ..utils.genomeutils import reverse_complement
from ..utils.profiling import trace_range

# POA_MEM_BUDGET: device bytes of one POA launch; models.poa cuts each
# polish batch's launches by it, as the JAX package plans its dispatches

#: path moves whose matched columns one group of reads holds at once
#: (``_read_groups``; 2^22 moves are at most 64 MB of columns)
GROUP_MOVES = 1 << 22

#: CorrectConfig.poa_backend -> the models.poa kernel route it runs
POA_KERNEL = {"auto": "lockstep", "xla": "lockstep", "pallas2": "lockstep",
              "pallas": "window"}


@dataclass
class CorrectResult:
    names: list[str]
    seqs: list[str]
    n_windows: int          # total backbone windows
    n_polished: int         # windows that went through POA successfully
    n_window_failed: int    # POA-attempted windows that kept the backbone


def _matched_pairs(path: list[int], o: Overlap):
    """(positions in query read, forward-strand positions in target read) of
    every matched/mismatched column of the overlap's alignment.  Query
    positions are strictly increasing; '-' overlaps give decreasing target
    positions (PAF keeps target coordinates on the forward strand)."""
    codes = np.asarray(path, np.int8)
    if codes.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    cq = codes != 3   # match/mismatch/insertion consume query
    ct = codes != 2   # match/mismatch/deletion consume target
    qoff = np.cumsum(cq) - cq
    toff = np.cumsum(ct) - ct
    m = codes <= 1
    rq = o.query_start_position_in_read + qoff[m]
    if o.relative_strand == "+":
        rt = o.target_start_position_in_read + toff[m]
    else:
        rt = o.target_end_position_in_read - 1 - toff[m]
    return rq.astype(np.int64), rt.astype(np.int64)


def _align_overlaps(overlaps: list[Overlap], parser: FastaParser,
                    cfg: CorrectConfig, batch_size: int = 2048,
                    device="cuda"):
    """Base-exact alignment (``banded-escalate``) of each overlap's spans on
    ``device``, one aligner per pow2 span bucket and chunk (the bucket is
    part of the result: routing to Hirschberg keys on the padded length).
    Returns one path (AlignmentState codes) per overlap; unalignable
    overlaps get an empty path."""
    spans = overlap_spans(overlaps, parser)
    paths: list[list[int]] = [[] for _ in spans]
    for L, idxs in sorted(span_buckets(spans).items()):
        for start in range(0, len(idxs), batch_size):
            sel = idxs[start:start + batch_size]
            with trace_range("aligner.add"):
                aligner = create_aligner(
                    L, L, len(sel),
                    band_radius=min(cfg.aligner_band_radius, L),
                    algorithm="banded-escalate", device=device)
                for i in sel:
                    aligner.add_alignment(*spans[i])
            for i, a in zip(sel, aligner.get_alignments()):
                paths[i] = a.path if a.status == StatusType.SUCCESS else []
    return paths


def _columns(overlaps: list[Overlap], paths: list[list[int]]) -> list:
    """:func:`_matched_pairs` of each overlap, None where it has no path."""
    return [_matched_pairs(path, o) if path else None
            for o, path in zip(overlaps, paths)]


def _window_supports(read_seq: str, overlaps: list[Overlap], columns: list,
                     parser: FastaParser,
                     cfg: CorrectConfig) -> list[list[str]]:
    """Per-window support segments for one read, from its overlaps'
    matched columns (:func:`_columns`).  Window wi covers backbone bases
    [wi*W, (wi+1)*W); a support is the other read's substring whose
    aligned columns land in the window, oriented along the backbone.

    Supports are taken in canonical overlap order and capped at
    cfg.max_support; a support needs >= cfg.min_matched_bases matched
    columns in the window and its segment may not exceed 2 * window_length
    (a longer segment means a pathological alignment)."""
    W = cfg.window_length
    n_win = (len(read_seq) + W - 1) // W
    supports: list[list[str]] = [[] for _ in range(n_win)]
    for o, cols in zip(overlaps, columns):
        if cols is None or cols[0].size == 0:
            continue
        rq, rt = cols
        other = parser.get_sequence_by_id(o.target_read_id).seq
        w_first = int(rq[0]) // W
        w_last = int(rq[-1]) // W
        # rq is sorted increasing: searchsorted slices each window's columns
        bounds = np.searchsorted(
            rq, np.arange(w_first, w_last + 2, dtype=np.int64) * W)
        for wi in range(w_first, min(w_last + 1, n_win)):
            if len(supports[wi]) >= cfg.max_support:
                continue
            s, e = bounds[wi - w_first], bounds[wi - w_first + 1]
            if e - s < cfg.min_matched_bases:
                continue
            seg_t = rt[s:e]
            lo = int(seg_t.min())
            hi = int(seg_t.max()) + 1
            if hi - lo > 2 * W:
                continue
            seg = other[lo:hi]
            if o.relative_strand == "-":
                seg = reverse_complement(seg)
            supports[wi].append(seg)
    return supports


def _read_groups(read_ids: list[int], paths_of: dict[int, list]) -> list:
    """``read_ids`` cut into consecutive groups whose overlaps' paths hold
    at most GROUP_MOVES moves together (a read at least): the matched
    columns of one group are held at once, never a whole part's."""
    groups: list[list[int]] = []
    moves = 0
    for rid in read_ids:
        n = sum(len(p) for p in paths_of[rid])
        if not groups or moves + n > GROUP_MOVES:
            groups.append([])
            moves = 0
        groups[-1].append(rid)
        moves += n
    return groups


def _polish_batch_size(cfg: CorrectConfig, depth: int) -> BatchSize:
    """BatchSize for a polish batch of pileups up to `depth` sequences
    (backbone included): the pred and clique caps scale with the depth
    (deep noisy pileups gather many deletion skip-edges a node), and
    max_nodes is 3 * W."""
    W = cfg.window_length
    return BatchSize(max_sequence_size=2 * W,
                     max_nodes_per_window=3 * W,
                     max_sequences_per_poa=depth,
                     max_pred_per_node=max(4, depth),
                     max_aligned_per_node=max(4, depth // 2))


def poa_kernel(cfg: CorrectConfig) -> str:
    if cfg.poa_backend not in POA_KERNEL:
        raise ValueError(f"poa_backend must be one of {tuple(POA_KERNEL)}, "
                         f"not {cfg.poa_backend!r}")
    return POA_KERNEL[cfg.poa_backend]


def depth_bucket(n_seqs: int, max_support: int) -> int:
    """The pileup depth a window of ``n_seqs`` sequences runs at: the next
    power of two, at least 4, at most max_support + 1."""
    return min(max(4, 1 << (n_seqs - 1).bit_length()), max_support + 1)


def _polish_windows(jobs: list[list[str]], cfg: CorrectConfig,
                    windows_per_dispatch: int | None,
                    device="cuda", mesh=None) -> tuple[list[str], int]:
    """POA consensus for each job (= [backbone, support...]) on ``device``.
    Returns the consensus strings (backbone kept where POA fails or gives
    an empty consensus) and the failure count.

    Jobs are bucketed by pow2 pileup depth, each bucket at its own caps
    (:func:`_polish_batch_size`); a bucket is one batch, or batches of
    ``windows_per_dispatch`` jobs.  A batch enqueues its launches in
    generate_poa and the previous batch is read back after that, so the
    host packs one batch while the card runs the one before.  ``mesh``
    splits each batch's windows over its 'data' axis."""
    kernel = poa_kernel(cfg)
    buckets: dict[int, list[int]] = {}
    for i, seqs in enumerate(jobs):
        buckets.setdefault(depth_bucket(len(seqs), cfg.max_support),
                           []).append(i)

    out: list[str | None] = [None] * len(jobs)
    n_failed = 0

    def drain(sel, chunk, batch):
        nonlocal n_failed
        cons, _, stats = batch.get_consensus()
        for i, seqs, c, st in zip(sel, chunk, cons, stats):
            if st == StatusType.SUCCESS and c:
                out[i] = c
            else:
                out[i] = seqs[0]  # keep the backbone
                n_failed += 1

    pending = None
    for depth, idxs in sorted(buckets.items()):
        bs = _polish_batch_size(cfg, depth)
        wpd = windows_per_dispatch or len(idxs)
        for start in range(0, len(idxs), wpd):
            sel = idxs[start:start + wpd]
            chunk = [jobs[i] for i in sel]
            with trace_range("poa.groups"):
                batch = create_batch(batch_size=bs, max_poas=len(chunk),
                                     device=device, kernel=kernel, mesh=mesh)
                for seqs in chunk:
                    batch.add_poa_group(seqs)
            batch.generate_poa()
            if pending is not None:
                drain(*pending)
            pending = (sel, chunk, batch)
    if pending is not None:
        drain(*pending)
    # every job lands in exactly one depth bucket; a bucketing change must
    # not silently join None into a corrected read
    assert all(s is not None for s in out), "unpolished job slot"
    return out, n_failed


def _correct_part(read_ids: list[int], by_query: dict[int, list[Overlap]],
                  parser: FastaParser, cfg: CorrectConfig,
                  windows_per_dispatch: int | None, device, mesh=None):
    """Correct one contiguous part of reads.  Returns (seqs, n_windows,
    n_polished, n_failed)."""
    part_overlaps: list[Overlap] = []
    for rid in read_ids:
        part_overlaps.extend(by_query.get(rid, ()))
    with trace_range("correct.align"):
        paths = _align_overlaps(part_overlaps, parser, cfg, device=device)
    path_of = dict(zip(map(id, part_overlaps), paths))

    jobs: list[list[str]] = []
    slots: list[tuple[int, int]] = []   # (read slot, window idx) per job
    pieces: list[list[str]] = []
    n_windows = 0
    with trace_range("correct.windows"):
        Wl = cfg.window_length
        paths_of = {rid: [path_of[id(o)] for o in by_query.get(rid, ())]
                    for rid in read_ids}
        for group in _read_groups(read_ids, paths_of):
            # the group's matched columns first, then each read's windows
            with trace_range("windows.columns"):
                columns = [_columns(by_query.get(rid, []), paths_of[rid])
                           for rid in group]
            with trace_range("windows.supports"):
                for rid, cols in zip(group, columns):
                    slot = len(pieces)
                    seq = parser.get_sequence_by_id(rid).seq
                    sup = _window_supports(seq, by_query.get(rid, []), cols,
                                           parser, cfg)
                    piece = []
                    for wi in range((len(seq) + Wl - 1) // Wl):
                        backbone = seq[wi * Wl: (wi + 1) * Wl]
                        n_windows += 1
                        if (len(sup[wi]) >= cfg.min_supports_for_poa
                                and backbone):
                            slots.append((slot, wi))
                            jobs.append([backbone] + sup[wi])
                            piece.append(None)  # filled from POA below
                        else:
                            piece.append(backbone)
                    pieces.append(piece)

    with trace_range("correct.poa"):
        cons, n_failed = _polish_windows(jobs, cfg, windows_per_dispatch,
                                         device, mesh)
    with trace_range("correct.join"):
        for (slot, wi), c in zip(slots, cons):
            pieces[slot][wi] = c
        seqs = ["".join(p) for p in pieces]
    return seqs, n_windows, len(jobs) - n_failed, n_failed


def correct_reads(parser: FastaParser, cfg: CorrectConfig,
                  work_dir: str | None = None, part_size: int = 64,
                  windows_per_dispatch: int | None = None,
                  fail_after_parts: int | None = None,
                  device="cuda", mesh=None) -> CorrectResult:
    """Correct every read of `parser` against all others on ``device``.

    work_dir: enables checkpoint/resume (map pairs + read parts).
    fail_after_parts: fault-injection hook for resume tests.
    mesh: rep-sharded matching and data-sharded POA (every rank calls with
    the same reads and gets every corrected read)."""
    from ..parallel.mesh import axis_meshes
    from ..parallel.multihost import is_writer
    device = resolve_device(device)
    mesh_data, mesh_rep = axis_meshes(mesh)
    writer = is_writer()
    n = parser.get_num_sequences()
    names = [parser.get_sequence_by_id(i).name for i in range(n)]

    with trace_range("correct.map"):
        if work_dir:
            from ..parallel.manifest import map_all_vs_all_resumable
            overlaps, _, _ = map_all_vs_all_resumable(
                parser, cfg.mapper, os.path.join(work_dir, "map"),
                device=device, mesh=mesh_rep)
        else:
            overlaps = map_all_vs_all(parser, cfg.mapper, device=device,
                                      mesh=mesh_rep).overlaps

    # supports come from overlaps where the corrected read is the QUERY
    # (all-vs-all emits both orders of each pair, so every partner appears)
    by_query: dict[int, list[Overlap]] = {}
    with trace_range("overlaps.filter"):
        for o in overlaps:
            if within_length(o, cfg.max_alignment_length):
                by_query.setdefault(o.query_read_id, []).append(o)

    parts = [list(range(s, min(s + part_size, n)))
             for s in range(0, n, part_size)]
    manifest_path = (os.path.join(work_dir, "correct_manifest.json")
                     if work_dir else None)
    done: dict[str, bool] = {}
    if manifest_path:
        from ..parallel.manifest import read_done
        done = read_done(manifest_path, [str(pi) for pi in range(len(parts))],
                         mesh_data)
    seqs: list[str | None] = [None] * n
    totals = [0, 0, 0]
    computed = 0
    for pi, read_ids in enumerate(parts):
        part_file = (os.path.join(work_dir, f"corrected_part_{pi}.json")
                     if work_dir else None)
        if part_file and done.get(str(pi)):
            with open(part_file) as f:
                part = json.load(f)
            part_seqs = part["seqs"]
            stats = part["stats"]
        else:
            # the part's own time is its glue and the freeing of its
            # paths and windows when _correct_part returns
            with trace_range("correct.part"):
                part_seqs, *stats = _correct_part(
                    read_ids, by_query, parser, cfg, windows_per_dispatch,
                    device, mesh_data)
            if part_file and writer:
                from ..parallel.manifest import write_aside
                write_aside(part_file, json.dumps({"seqs": part_seqs,
                                                   "stats": stats}))
                done[str(pi)] = True
                write_aside(manifest_path, json.dumps(done))
            computed += 1
            if fail_after_parts is not None and computed >= fail_after_parts:
                raise RuntimeError("injected failure for resume test")
        for rid, s in zip(read_ids, part_seqs):
            seqs[rid] = s
        for i in range(3):
            totals[i] += stats[i]

    return CorrectResult(names, seqs, *totals)


def write_fasta(result: CorrectResult, path: str) -> None:
    with open(path, "w") as f:
        for name, seq in zip(result.names, result.seqs):
            f.write(f">{name}\n{seq}\n")
