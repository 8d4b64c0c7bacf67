"""Decode banded-NW tracebacks on the device (counterpart of
``claragenomicsanalysis_tpu/ops/tb_decode_pallas.py``), in either layout:
``diag`` (``diag=True`` there) for the ``tb (Dpad / 4, B, W)`` array of
:func:`ops.nw_diag.banded_nw_diag`, ``row`` (``diag=False``) for the
``tb (round_up(Lq, 16) / 4, B, round_up(2r + 1, 8))`` array of
:func:`ops.nw_row.banded_nw_row`.

Each problem's walk starts at (qlen, tlen) and follows the 2-bit codes back
to (0, 0).  The path leaves the device packed: ``packed (B, TL / 16)`` int32
holds 16 codes per word, written backwards from slot TL, and ``start (B,)``
int32 is the slot of the first move, with ``TL = round_up(Dpad + 8, 2048)``
(diag) or ``round_up(2 * 4 * R4 + 2r + 8, 2048)`` (row, R4 packed rows) —
the JAX function's arrays, value for value.  Lane and row are clipped to the
array, so a problem with an INF score walks bounded garbage; callers drop it
by status.

- :func:`decode_diag` and :func:`decode_row` launch their kernels in
  ``csrc/tb_decode.cu`` for CUDA tensors, in the plan
  :func:`tb_decode_plan` gives the shape, count the launches in
  ``launch.tb_decode`` / ``launch.tb_decode_row`` and time them inside a
  ``utils.profiling.kernel_times()`` block; for CPU tensors they run their
  plain versions.
- :func:`decode_diag_torch` and :func:`decode_row_torch` are the plain
  PyTorch versions: the batch walks in lockstep, one tensor step per move.
- :func:`traceback_paths_device` returns the paths as code lists, from the
  layout its caller names: the list route, which ``Aligner.get_alignments()``
  (``cli align``) and ``cli correct`` (``correct.windows`` reads matched
  columns from the codes) take; it unpacks every path on the host
  (``tb.unpack``).
- :func:`decode_packed` keeps them on the device instead, cut to the words a
  path of the traceback can fill, and :class:`PackedPaths` gathers such
  launches, and Hirschberg's leaves, as segments of the batch's paths for
  ``ops/cigar.py``: the route of ``Aligner.get_cigars()``, which the
  pipeline (``cli pipeline``) takes.  No code of it reaches the host.
"""

import numpy as np
import torch

from ..core.status import AlignmentState
from ..utils.mathutils import round_up
from ..utils.profiling import kernel_span, to_host, trace_range
from . import _build


def path_slots(tb_rows: int) -> int:
    """TL: path slots per problem for a traceback of ``tb_rows`` rows (one
    row is four diagonals; a global path has fewer moves than diagonals)."""
    return round_up(4 * tb_rows + 8, 2048)


def path_slots_row(tb_rows: int, band_radius: int) -> int:
    """TL of the row layout: a global path inside the band has at most
    qlen + tlen <= 2 * Lq + r moves, Lq = 4 * tb_rows."""
    return round_up(2 * 4 * tb_rows + 2 * band_radius + 8, 2048)


#: SMs of the card (an H100 SXM): the staged plan puts fewer problems in a
#: block where a launch has too few to give every SM a block of four
SMS = 132
#: problems with fewer packed rows keep the thread plan: many short walks in
#: flight hide each other's latency, and a chunk would hold the whole walk
STAGE_MIN_ROWS = 64
#: the widest row the staged plan streams: a walk's lane moves by at most one
#: a step, so a wider row would stream bytes the walk never reads
STAGE_MAX_WIDTH = 512
#: the most rows a chunk holds, and the shared memory one problem's ring of
#: two chunks may take
CHUNK_ROWS, RING_BYTES = 64, 32 * 1024
#: problems a block of the thread plan (one a thread)
THREAD_PROBLEMS = 128


def tb_decode_plan(B: int, R4: int, W: int, layout: str) -> tuple:
    """-> (variant, problems_a_block, rows_a_chunk) of a decode of B
    problems of a ``(R4, B, W)`` traceback in ``layout`` ("diag" or "row":
    one rule serves both).

    ``"staged-16"`` / ``"staged-8"`` (a warp a problem streaming its packed
    rows through a shared-memory ring of two chunks, 16- or 8-byte copies as
    W is a multiple of 16 or only of 8) where the problem has at least
    STAGE_MIN_ROWS rows and W is a multiple of 8 of at most
    STAGE_MAX_WIDTH; a chunk holds CHUNK_ROWS rows, fewer where two would
    pass RING_BYTES; 4, 2 or 1 problems a block, the most that still give
    every one of the SMS SMs a block and whose rings fit a block's shared
    memory.  Every other shape (and one whose ring of one-row chunks would
    not fit a block): ``"thread"`` (a thread a problem, THREAD_PROBLEMS a
    block, no chunk)."""
    if layout not in ("diag", "row"):
        raise ValueError(f"unknown traceback layout {layout!r}")
    if R4 < STAGE_MIN_ROWS or W <= 0 or W % 8 or W > STAGE_MAX_WIDTH:
        return "thread", THREAD_PROBLEMS, 0
    rows = min(CHUNK_ROWS, RING_BYTES // (2 * W))
    if rows < 1 or 2 * rows * W > _build.SMEM_PER_BLOCK:
        return "thread", THREAD_PROBLEMS, 0
    problems = next(n for n in (4, 2, 1) if n == 1 or (
        n * SMS <= B and n * 2 * rows * W <= _build.SMEM_PER_BLOCK))
    return ("staged-16" if W % 16 == 0 else "staged-8"), problems, rows


def _check(tb, qlen, tlen):
    if tb.dim() != 3 or tb.dtype != torch.int8:
        raise ValueError("tb must be a (rows, B, W) int8 tensor")
    B = tb.shape[1]
    if qlen.shape != (B,) or tlen.shape != (B,) \
            or qlen.dtype != torch.int32 or tlen.dtype != torch.int32:
        raise ValueError("qlen and tlen must be (B,) int32 tensors")
    if len({x.device for x in (tb, qlen, tlen)}) != 1:
        raise ValueError("tb, qlen and tlen must be on one device")


def _cell_diag(i, j, r):
    """(packed row, lane, bit shift) of cell (i, j) in the diag layout."""
    d = i + j
    return d >> 2, (r + j - i - ((d + r) & 1)) >> 1, 2 * (d & 3)


def _cell_row(i, j, r):
    """(packed row, lane, bit shift) of cell (i, j), i >= 1, in the row
    layout."""
    return (i - 1) >> 2, r + j - i, 2 * ((i - 1) & 3)


def _walk_torch(tb, qlen, tlen, band_radius, TL, cell):
    """The lockstep walk of both plain versions: every problem steps from
    (qlen, tlen) toward (0, 0), one tensor step per move, reading the code
    of ``cell(i, j, r)`` with row and lane clipped to the array."""
    _check(tb, qlen, tlen)
    R4, B, W = tb.shape
    dev = tb.device
    tbu = tb.view(torch.uint8)
    b = torch.arange(B, device=dev)
    i = qlen.long()
    j = tlen.long()
    k = torch.full((B,), TL, dtype=torch.int64, device=dev)
    # int64 words; folded to int32 bit patterns at the end
    packed = torch.zeros((B, TL // 16), dtype=torch.int64, device=dev)
    deletion = torch.full((B,), int(AlignmentState.DELETION),
                          dtype=torch.int64, device=dev)
    while True:
        active = ((i > 0) | (j > 0)) & (k > 0)
        if not bool(active.any()):
            break
        code = deletion        # row 0: the rest are deletions
        if R4:                 # R4 == 0 only when every qlen is 0
            row, lane, shift = cell(i, j, band_radius)
            byte = tbu[row.clamp(0, R4 - 1), b, lane.clamp(0, W - 1)]
            code = torch.where(i == 0, deletion,
                               (byte.long() >> shift) & 3)
        k = torch.where(active, k - 1, k)
        ba, ka = b[active], k[active]
        packed[ba, ka >> 4] |= code[active] << (2 * (ka & 15))
        i = i - (active & (code != AlignmentState.DELETION)).long()
        j = j - (active & (code != AlignmentState.INSERTION)).long()
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32), k.to(torch.int32)


def _launch(name, launcher, layout, tb, qlen, tlen, band_radius, TL):
    """Launch the library's ``launcher`` on CUDA tensors in the plan of
    :func:`tb_decode_plan`, timed as kernel ``name``, unless the batch is
    empty -> (packed, start)."""
    _check(tb, qlen, tlen)
    if tb.device.type != "cuda":
        raise ValueError(f"no kernel for device {tb.device}")
    tb, qlen, tlen = (x.contiguous() for x in (tb, qlen, tlen))
    R4, B, W = tb.shape
    packed = torch.zeros((B, TL // 16), dtype=torch.int32, device=tb.device)
    start = torch.empty(B, dtype=torch.int32, device=tb.device)
    if B == 0:
        return packed, start
    variant, problems, rows = tb_decode_plan(B, R4, W, layout)
    copy = 0 if variant == "thread" else int(variant.split("-")[1])
    lib = _build.load()
    with torch.cuda.device(tb.device), kernel_span(
            name, (tb, qlen, tlen, band_radius), B * TL):
        err = getattr(lib, launcher)(
            tb.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            packed.data_ptr(), start.data_ptr(), B, R4, W, band_radius, TL,
            copy, problems, rows, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, name)
    return packed, start


def decode_diag_torch(tb: torch.Tensor, qlen: torch.Tensor,
                      tlen: torch.Tensor,
                      band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`decode_diag`."""
    return _walk_torch(tb, qlen, tlen, band_radius, path_slots(tb.shape[0]),
                       _cell_diag)


def decode_diag(tb: torch.Tensor, qlen: torch.Tensor, tlen: torch.Tensor,
                band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk every problem's anti-diagonal traceback on the tensors' device.

    Returns ``packed (B, TL / 16)`` int32 and ``start (B,)`` int32 (see the
    module docstring).
    """
    if tb.device.type == "cpu":
        return decode_diag_torch(tb, qlen, tlen, band_radius)
    return _launch("tb_decode", "cga_tb_decode_diag", "diag", tb, qlen,
                   tlen, band_radius, path_slots(tb.shape[0]))


def decode_row_torch(tb: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor,
                     band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`decode_row`."""
    return _walk_torch(tb, qlen, tlen, band_radius,
                       path_slots_row(tb.shape[0], band_radius), _cell_row)


def decode_row(tb: torch.Tensor, qlen: torch.Tensor, tlen: torch.Tensor,
               band_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk every problem's row-layout traceback on the tensors' device.

    Returns ``packed (B, TL / 16)`` int32 and ``start (B,)`` int32 (see the
    module docstring).
    """
    if tb.device.type == "cpu":
        return decode_row_torch(tb, qlen, tlen, band_radius)
    return _launch("tb_decode_row", "cga_tb_decode_row", "row", tb, qlen,
                   tlen, band_radius,
                   path_slots_row(tb.shape[0], band_radius))


#: the device decoder of each traceback layout
DECODERS = {"diag": decode_diag, "row": decode_row}


def unpack_paths(packed: np.ndarray, start: np.ndarray) -> list[list[int]]:
    """Host side: 16 2-bit codes per int32 word -> one code list per row,
    from its start slot on."""
    pw = np.ascontiguousarray(packed).view(np.uint32)
    shifts = 2 * np.arange(16, dtype=np.uint32)
    codes = ((pw[:, :, None] >> shifts) & 3).astype(np.uint8)
    codes = codes.reshape(pw.shape[0], -1)
    return [codes[b, int(s):].tolist() for b, s in enumerate(start)]


def traceback_paths_device(tb: torch.Tensor, qlen: torch.Tensor,
                           tlen: torch.Tensor, band_radius: int,
                           kernel: str = "diag") -> list[list[int]]:
    """Decode a traceback of the layout ``kernel`` ("diag" or "row", the
    kernel that wrote it) on the device; only the packed path words are
    copied to the host, from the word of the earliest start on (the words
    before it are zero in every row).  Returns forward AlignmentState code
    lists, one per problem."""
    if kernel not in DECODERS:
        raise ValueError(f"unknown traceback layout {kernel!r}")
    packed, start = DECODERS[kernel](tb, qlen, tlen, band_radius)
    start = to_host(start).numpy()
    first = int(start.min()) // 16 if len(start) else 0
    packed = to_host(packed[:, first:]).numpy()
    with trace_range("tb.unpack"):
        return unpack_paths(packed, start - 16 * first)


def decode_packed(tb: torch.Tensor, qlen: torch.Tensor, tlen: torch.Tensor,
                  band_radius: int, kernel: str = "diag"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a traceback of the layout ``kernel`` on the device and keep the
    paths there: -> ``words (B, K)`` int32, the last K words of ``packed``,
    which hold every move a path of this traceback can have (fewer than
    4 R4 diagonals in the diag layout; qlen + tlen <= 2 Lq + r, Lq <= 4 R4,
    in the row layout), and ``first (B,)`` int32, each path's first slot in
    them."""
    if kernel not in DECODERS:
        raise ValueError(f"unknown traceback layout {kernel!r}")
    packed, start = DECODERS[kernel](tb, qlen, tlen, band_radius)
    R4 = tb.shape[0]
    moves = 4 * R4 if kernel == "diag" else 8 * R4 + band_radius
    tw = packed.shape[1]
    k = min(tw, max(1, (moves + 15) // 16))
    return packed[:, tw - k:].contiguous(), start - 16 * (tw - k)


class PackedPaths:
    """The edit paths of a batch of ``n`` pairs, left on ``device`` in B2's
    packed form.  Each path is made of segments, rows of
    :func:`decode_packed` launches (one a banded pair, one a Hirschberg
    leaf), read in the order of their keys (a leaf's first query row)."""

    def __init__(self, n: int, device):
        self.n = n
        self.device = torch.device(device)
        self._words: list[torch.Tensor] = []    # (m, K) int32 a launch
        self._first: list[torch.Tensor] = []    # (m,) int32
        self._owner: list[np.ndarray] = []      # (m,) the rows' paths
        self._key: list[np.ndarray] = []        # (m,) their order in them

    def add(self, owner, words: torch.Tensor, first: torch.Tensor,
            key=None) -> None:
        """Keep the rows of one :func:`decode_packed` launch, row k a
        segment of path ``owner[k]``, ordered in it by ``key[k]``."""
        owner = np.asarray(owner, np.int64)
        self._words.append(words)
        self._first.append(first)
        self._owner.append(owner)
        self._key.append(np.zeros_like(owner) if key is None
                         else np.asarray(key, np.int64))

    def extend(self, other: "PackedPaths", owner) -> None:
        """Take ``other``'s segments, its path p as path ``owner[p]``."""
        owner = np.asarray(owner, np.int64)
        self._words += other._words
        self._first += other._first
        self._owner += [owner[o] for o in other._owner]
        self._key += other._key

    def segments(self, keep: np.ndarray) -> tuple:
        """The paths ``keep`` marks (``(n,)`` bool), in order, as
        ``ops.cigar``'s ``(words, seg_base, seg_first, seg_end, path_seg)``
        on the device.  The host sends each segment's path and key and each
        launch's shape in one copy; the device puts the segments in order by
        one stable sort of a combined key (the order of the list join's
        ``lexsort((key, path))``) and builds the rest."""
        with trace_range("paths.segments"):
            dev = self.device
            m = np.array([w.shape[0] for w in self._words], np.int64)
            k = np.array([w.shape[1] for w in self._words], np.int64)
            owner = np.concatenate([np.zeros(0, np.int64)] + self._owner)
            key = np.concatenate([np.zeros(0, np.int64)] + self._key)
            ids = np.flatnonzero(keep)
            sizes = [len(owner)] * 2 + [len(m)] * 3 + [self.n, len(ids)]
            host = np.concatenate([
                owner * (int(key.max(initial=0)) + 1) + key, owner,
                np.cumsum(m * k) - m * k, k, m,
                np.asarray(keep, np.int64), ids])
            sort_key, owner, off, k, m, keep, ids = torch.from_numpy(
                host).to(dev).split(sizes)
            order = torch.sort(sort_key, stable=True).indices
            order = order[keep[owner[order]].bool()]
            launch = torch.repeat_interleave(
                torch.arange(len(m), device=dev), m,
                output_size=sizes[0])
            row = torch.arange(sizes[0], device=dev) - (m.cumsum(0) - m)[
                launch]
            launch = launch[order]
            path_seg = torch.zeros(len(ids) + 1, dtype=torch.int64,
                                   device=dev)
            path_seg[1:] = torch.bincount(owner[order], minlength=self.n)[
                ids].cumsum(0)
            words = (torch.cat([w.reshape(-1) for w in self._words])
                     if self._words
                     else torch.zeros(0, dtype=torch.int32, device=dev))
            first = (torch.cat(self._first) if self._first
                     else torch.zeros(0, dtype=torch.int32, device=dev))
            return (words, off[launch] + k[launch] * row[order],
                    first[order].long(), 16 * k[launch], path_seg)
