"""Batched pairwise global aligner — the cudaaligner counterpart, in PyTorch
(port of ``claragenomicsanalysis_tpu/models/aligner.py``).

``create_aligner(...)`` -> ``Aligner`` with ``add_alignment`` / ``align_all``
/ ``get_alignments`` / ``reset``; each ``Alignment`` carries the edit path,
CIGAR, pretty view and a per-problem ``StatusType``, exactly as in the JAX
package.  ``get_cigars`` (the port's own) gives each pair's status and
CIGAR alone: its paths stay on the device and only their text, written by
the CIGAR kernel (ops/cigar.py), comes back.  The DP runs on an explicit
``torch.device``: on ``cuda`` through the hand-written kernels of ops/, on
``cpu`` through their plain PyTorch versions.  ``kernel`` names the
banded-NW kernel every algorithm's banded launches use (ops/banded.py):
``"diag"`` (the default, B1) or ``"row"`` (B3, the JAX package's
``backend="pallas-row"``); both give the same paths, distances and
statuses.  Algorithms:

- ``ukkonen`` (default): banded NW with the adaptive band;
- ``myers``: Myers bit-vector scores, then a banded re-run for the canonical
  path (align/myers_aligner.py);
- ``banded-escalate``: banded NW at doubling radii, no scoring pass (same
  module);
- ``hirschberg-myers``: linear-memory divide and conquer
  (align/hirschberg.py).
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from ..align.hirschberg import hirschberg_align_batch
from ..align.myers_aligner import (banded_escalate_align_batch,
                                   myers_align_batch)
from ..core.config import AlignerConfig
from ..core.status import AlignmentType, StatusType
from ..ops.banded import launch_chunks, resolve
from ..ops.cigar import cigar_strings
from ..ops.nw_diag import INF
from ..ops.tb_decode import PackedPaths
from ..utils import cigar
from ..utils.genomeutils import pack_pairs
from ..utils.profiling import to_host, trace_range

ALGORITHMS = ("ukkonen", "myers", "hirschberg-myers", "banded-escalate")


@dataclass
class Alignment:
    """One alignment result (reference: Alignment interface [U])."""

    query: str
    target: str
    status: StatusType
    alignment_type: AlignmentType = AlignmentType.GLOBAL_ALIGNMENT
    path: list[int] = field(default_factory=list)   # AlignmentState codes
    edit_distance: int = -1

    def get_query(self) -> str:
        return self.query

    def get_target(self) -> str:
        return self.target

    def get_alignment(self) -> list[int]:
        return self.path

    def convert_to_cigar(self, extended: bool = False) -> str:
        return cigar.path_to_cigar(self.path, extended=extended)

    def format_alignment(self, width: int = 80) -> str:
        return cigar.format_alignment(self.path, self.query, self.target,
                                      width)


def bucket_radius(band_radius: int, length_difference: int) -> int:
    """The adaptive Ukkonen band p + |lq - lt| (reference: ukkonen_gpu.cu
    band sizing [U]), widened to a power of two of at least 8 so that few
    distinct radii exist: a pair whose lengths differ by more than the
    configured radius still aligns."""
    dl = int(length_difference)
    return band_radius + (0 if dl == 0 else max(8, 1 << (dl - 1).bit_length()))


class Aligner:
    """Batched global aligner on one ``torch.device``."""

    def __init__(self, config: AlignerConfig, algorithm: str = "ukkonen",
                 device="cuda", kernel: str = "diag", mesh=None,
                 sp_min_len: int | None = None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.config = config
        self.algorithm = algorithm
        self.kernel = kernel
        self.device = torch.device(device)
        # raises for a kernel not in ops.banded.KERNELS
        self._nw, self._decode = resolve(self.device, kernel)
        # ukkonen shards its batch over the mesh's 'data' axis;
        # hirschberg-myers takes its long levels' rows from the 'sp' ring
        # (levels whose side reaches sp_min_len); myers and banded-escalate
        # run unsharded on every rank, as in the JAX package
        self.mesh = mesh
        self.sp_min_len = sp_min_len
        self._queries: list[str] = []
        self._targets: list[str] = []
        self._results: list[Alignment] | None = None
        self._packed: tuple | None = None     # (statuses, PackedPaths)

    # ------------------------------------------------------------------ API

    def add_alignment(self, query: str, target: str) -> StatusType:
        cfg = self.config
        if len(self._queries) >= cfg.max_alignments:
            return StatusType.EXCEEDED_MAX_ALIGNMENTS
        self._queries.append(query)
        self._targets.append(target)
        self._results = None
        self._packed = None
        if (len(query) > cfg.max_query_length
                or len(target) > cfg.max_target_length):
            # the slot stays so results are index-aligned; it is marked failed
            return StatusType.EXCEEDED_MAX_LENGTH
        return StatusType.SUCCESS

    def align_all(self) -> None:
        self._results = self._run_batch()

    def sync_alignments(self) -> None:
        if self._results is None:
            self.align_all()

    def get_alignments(self) -> list[Alignment]:
        self.sync_alignments()
        return self._results

    def sync_cigars(self) -> None:
        """Align the batch, unless done, for :meth:`get_cigars`: every path
        stays packed on the device."""
        if self._packed is None:
            self._packed = self._run_packed()

    def get_cigars(self, extended: bool = False
                   ) -> list[tuple[StatusType, str]]:
        """Each pair's status and CIGAR (``""`` unless SUCCESS), the text
        :meth:`Alignment.convert_to_cigar` gives, written on the device by
        the CIGAR kernel from the packed paths and read back once: no code
        list and no ``Alignment`` a pair.  For the ``myers`` algorithm
        (``cli pipeline``'s); the others raise ValueError."""
        self.sync_cigars()
        statuses, paths = self._packed
        ok = np.array([s == StatusType.SUCCESS for s in statuses], bool)
        texts = iter(cigar_strings(*paths.segments(ok), extended=extended))
        return [(s, next(texts) if k else "") for s, k in zip(statuses, ok)]

    def reset(self) -> None:
        self._queries.clear()
        self._targets.clear()
        self._results = None
        self._packed = None

    # ------------------------------------------------------------ internals

    def _pack(self):
        """(B, padded length) int8 codes, -1 PAD; overlong inputs are cut to
        the configured maximum (their status says so)."""
        cfg = self.config
        return pack_pairs([qs[: cfg.max_query_length] for qs in self._queries],
                          [ts[: cfg.max_target_length] for ts in self._targets],
                          cfg.padded_query_length, cfg.padded_target_length)

    def _plan(self, qlen: np.ndarray, tlen: np.ndarray) -> list:
        """The launches for problems of these lengths: (r, indices) per
        chunk, band buckets in increasing r, each cut into chunks by
        ops.banded.launch_chunks."""
        cfg = self.config
        return banded_plan(self.radii(qlen, tlen), cfg.padded_query_length,
                           cfg.padded_target_length, self.kernel)

    def radii(self, qlen: np.ndarray, tlen: np.ndarray) -> np.ndarray:
        """Each problem's adaptive band (:func:`bucket_radius`)."""
        return np.array([bucket_radius(self.config.band_radius, dl) for dl in
                         np.abs(np.asarray(qlen) - np.asarray(tlen))],
                        dtype=np.int64)

    def _run_batch(self) -> list[Alignment]:
        if not self._queries:
            return []
        with trace_range("aligner.pack"):
            q, qlen, t, tlen = self._pack()
        dev, kernel = self.device, self.kernel
        with trace_range(f"aligner.{self.algorithm}"):
            if self.algorithm == "hirschberg-myers":
                # the unpadded strings, as the JAX package passes them
                paths, dists = hirschberg_align_batch(
                    self._queries, self._targets, dev, kernel,
                    mesh=self.mesh, sp_min_len=self.sp_min_len)
            elif self.algorithm == "myers":
                paths, dists = myers_align_batch(
                    q, qlen, t, tlen, self._queries, self._targets, dev,
                    kernel)
            elif self.algorithm == "banded-escalate":
                paths, dists = banded_escalate_align_batch(
                    q, qlen, t, tlen, self._queries, self._targets, dev,
                    kernel)
            else:
                paths, dists = self._run_ukkonen(q, qlen, t, tlen)

        out = []
        with trace_range("aligner.results"):
            for b, (qs, ts, status) in enumerate(zip(
                    self._queries, self._targets, self._statuses(dists))):
                ok = status == StatusType.SUCCESS
                out.append(Alignment(query=qs, target=ts, status=status,
                                     path=paths[b] if ok else [],
                                     edit_distance=int(dists[b]) if ok
                                     else -1))
        return out

    def _statuses(self, dists) -> list[StatusType]:
        """Each pair's status: too long, past the band (an INF distance),
        or SUCCESS."""
        cfg = self.config
        return [StatusType.EXCEEDED_MAX_LENGTH
                if (len(qs) > cfg.max_query_length
                    or len(ts) > cfg.max_target_length)
                else StatusType.EXCEEDED_MAX_ALIGNMENT_DIFFERENCE
                if dists[b] >= INF else StatusType.SUCCESS
                for b, (qs, ts) in enumerate(zip(self._queries,
                                                 self._targets))]

    def _run_packed(self) -> tuple:
        """The batch through ``myers`` with its paths left on the device
        -> (statuses, ops.tb_decode.PackedPaths)."""
        if self.algorithm != "myers":
            raise ValueError(f"get_cigars runs the myers algorithm, not "
                             f"{self.algorithm!r}")
        if not self._queries:
            return [], PackedPaths(0, self.device)
        with trace_range("aligner.pack"):
            q, qlen, t, tlen = self._pack()
        with trace_range("aligner.myers"):
            paths, dists = myers_align_batch(
                q, qlen, t, tlen, self._queries, self._targets, self.device,
                self.kernel, packed=True)
        with trace_range("aligner.results"):
            return self._statuses(dists), paths

    def _run_ukkonen(self, q, qlen, t, tlen):
        """Banded NW at each pair's adaptive band (:func:`banded_align`);
        with a mesh of more than one rank on 'data', each rank aligns its
        slice of the batch (parallel/shard.sharded_banded_nw)."""
        radii = self.radii(qlen, tlen)
        if self.mesh is not None and self.mesh.shape.get("data", 1) > 1:
            from ..parallel.shard import sharded_banded_nw
            scores, paths = sharded_banded_nw(q, qlen, t, tlen, radii,
                                              self.mesh, self.device,
                                              self.kernel)
            return paths, scores
        scores, paths = banded_align(q, qlen, t, tlen, radii, self.device,
                                     self.kernel, self._nw, self._decode)
        return paths, scores


def banded_plan(radii: np.ndarray, Lq: int, Lt: int, kernel: str) -> list:
    """(r, indices) per launch for problems of a (Lq, Lt) batch at these
    radii: band buckets in increasing r, each cut into chunks by
    ops.banded.launch_chunks."""
    buckets: dict[int, list[int]] = {}
    for b, r in enumerate(np.asarray(radii).tolist()):
        buckets.setdefault(r, []).append(b)
    return [(r, sel) for r, idxs in sorted(buckets.items())
            for sel in launch_chunks(idxs, Lq, Lt, r, kernel)]


def banded_align(q, qlen, t, tlen, radii, device, kernel: str = "diag",
                 nw_fn=None, decode_fn=None):
    """Banded NW of each problem of the packed batch at its radius, chunk
    by chunk of :func:`banded_plan`, on ``device`` (by ``kernel``'s
    functions, ops.banded.resolve, unless given); the batch moves to the
    device once and only scores and packed paths come back.  -> (scores
    (B,) int64, paths)."""
    if nw_fn is None:
        nw_fn, decode_fn = resolve(device, kernel)
    dev = torch.device(device)
    qd, qld, td, tld = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (q, qlen, t, tlen))
    B = q.shape[0]
    paths: list[list[int]] = [[] for _ in range(B)]
    scores = np.zeros(B, dtype=np.int64)
    for r, sel in banded_plan(radii, q.shape[1], t.shape[1], kernel):
        seld = torch.from_numpy(sel).to(dev)
        ql, tl = qld[seld], tld[seld]
        sc, tb = nw_fn(qd[seld], ql, td[seld], tl, r)
        scores[sel] = to_host(sc).numpy()
        for b, p in zip(sel, decode_fn(tb, ql, tl, r)):
            paths[b] = p
    return scores, paths


def create_aligner(max_query_length: int, max_target_length: int,
                   max_alignments: int,
                   alignment_type: AlignmentType = AlignmentType.GLOBAL_ALIGNMENT,
                   band_radius: int = 64, algorithm: str = "ukkonen",
                   device="cuda", kernel: str = "diag", mesh=None,
                   sp_min_len: int | None = None) -> Aligner:
    """Factory mirroring the reference's create_aligner [U].  ``device`` is
    where the DP runs; asking for ``cuda`` where torch finds no card
    raises.  ``kernel`` is the banded-NW kernel, one of
    ``ops.banded.KERNELS``; any other string raises ValueError.

    ``mesh`` (parallel.mesh.make_mesh): with a 'data' axis > 1, ukkonen
    batches shard across its ranks; with an 'sp' axis > 1,
    hirschberg-myers levels whose side reaches ``sp_min_len`` (default:
    align.hirschberg.ring_min_len()) take their rows from the ring
    wavefront.  Every rank calls with the same pairs and gets every
    alignment."""
    if alignment_type != AlignmentType.GLOBAL_ALIGNMENT:
        raise ValueError("only global alignment is supported")
    cfg = AlignerConfig(max_query_length=max_query_length,
                        max_target_length=max_target_length,
                        max_alignments=max_alignments,
                        band_radius=band_radius)
    return Aligner(cfg, algorithm=algorithm, device=device, kernel=kernel,
                   mesh=mesh, sp_min_len=sp_min_len)
