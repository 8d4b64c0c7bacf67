"""Edit paths on the device -> CIGAR text.  A kernel of the port alone: the
JAX package formats every CIGAR on the host from a code list
(``utils/cigar.py`` ``path_to_cigar`` here).

The paths come as segments of B2's packed words (``ops/tb_decode.py``;
:class:`~.tb_decode.PackedPaths` builds them):

- ``words (N,)`` int32: 16 two-bit AlignmentState codes a word, the code of
  slot s of a row at bits ``2 (s & 15)`` of ``words[base + (s >> 4)]``;
- segment k: slots ``[seg_first[k], seg_end[k])`` of the row at word
  ``seg_base[k]`` (each ``(S,)`` int64);
- path p: segments ``path_seg[p] .. path_seg[p + 1] - 1`` in order
  (``path_seg (P + 1,)`` int64).  A run that continues across a word or a
  segment is one run.

Each path's text is the one ``path_to_cigar`` writes for its codes, with
the letters of ``CIGAR_OP_COMPACT`` (M M I D) or ``CIGAR_OP_EXTENDED``
(= X I D).

- :func:`cigar_text` for CUDA tensors launches ``csrc/cigar.cu`` twice: a
  count pass gives each path's bytes, ``torch.cumsum`` makes them offsets,
  their total is read back, and a write pass writes the text at the
  offsets; both launches are kernel ``cigar`` (``launch.cigar``, and timed
  inside a ``utils.profiling.kernel_times()`` block).  For CPU tensors it
  runs :func:`cigar_text_torch`, the plain version.  -> uint8 text, each
  path's CIGAR followed by ``"\\n"``.
- :func:`cigar_strings`: that text read back once, decoded and split into
  one string a path.  It counts the paths in ``cigar.paths``, the segments
  in ``cigar.segments`` and the bytes read back in ``cigar.bytes``.
"""

import torch

from ..core.status import CIGAR_OP_COMPACT, CIGAR_OP_EXTENDED
from ..utils.profiling import count, kernel_span, to_host
from . import _build

SEPARATOR = ord("\n")


def _letters(extended: bool) -> list[int]:
    ops = CIGAR_OP_EXTENDED if extended else CIGAR_OP_COMPACT
    return [ord(ops[c]) for c in range(4)]


def _check(words, seg_base, seg_first, seg_end, path_seg):
    if words.dim() != 1 or words.dtype != torch.int32:
        raise ValueError("words must be a (N,) int32 tensor")
    S = seg_base.shape[0]
    for name, x in (("seg_base", seg_base), ("seg_first", seg_first),
                    ("seg_end", seg_end)):
        if x.shape != (S,) or x.dtype != torch.int64:
            raise ValueError(f"{name} must be a (S,) int64 tensor")
    if path_seg.dim() != 1 or path_seg.numel() < 1 \
            or path_seg.dtype != torch.int64:
        raise ValueError("path_seg must be a (P + 1,) int64 tensor")
    if len({x.device for x in (words, seg_base, seg_first, seg_end,
                               path_seg)}) != 1:
        raise ValueError("the paths' tensors must be on one device")


def cigar_text_torch(words: torch.Tensor, seg_base: torch.Tensor,
                     seg_first: torch.Tensor, seg_end: torch.Tensor,
                     path_seg: torch.Tensor,
                     extended: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`cigar_text`: every path's codes
    gathered at once, the runs found with one comparison, their digits
    written by place value."""
    _check(words, seg_base, seg_first, seg_end, path_seg)
    dev = words.device
    P = path_seg.numel() - 1
    first = seg_first.clamp(min=0)
    n = (seg_end - first).clamp(min=0)             # codes a segment
    seg_path = torch.repeat_interleave(torch.arange(P, device=dev),
                                       path_seg.diff())
    seg_of = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    k = torch.arange(seg_of.numel(), device=dev)
    slot = first[seg_of] + k - (n.cumsum(0) - n)[seg_of]
    code = (words[seg_base[seg_of] + (slot >> 4)].long()
            >> (2 * (slot & 15))) & 3
    letter = torch.tensor(_letters(extended), dtype=torch.uint8,
                          device=dev)[code]
    path = seg_path[seg_of]
    starts = torch.ones_like(letter, dtype=torch.bool)
    starts[1:] = (letter[1:] != letter[:-1]) | (path[1:] != path[:-1])
    at = starts.nonzero().squeeze(1)
    run_len = at.diff(append=at.new_tensor([k.numel()]))
    run_path = path[at]
    digits = torch.ones_like(run_len)
    place = 10
    while bool((run_len >= place).any()):
        digits += (run_len >= place).long()
        place *= 10
    run_bytes = digits + 1
    # a run's text follows the runs before it and one separator a path
    # before its own
    pos = run_bytes.cumsum(0) - run_bytes + run_path
    path_bytes = torch.ones(P, dtype=torch.int64, device=dev).index_add_(
        0, run_path, run_bytes)
    text = torch.empty(int(path_bytes.sum()), dtype=torch.uint8, device=dev)
    text[path_bytes.cumsum(0) - 1] = SEPARATOR
    text[pos + digits] = letter[at]
    value = run_len.clone()
    for d in range(int(digits.max()) if digits.numel() else 0):
        has = digits > d
        text[(pos + digits - 1 - d)[has]] = (ord("0") + value % 10)[has].to(
            torch.uint8)
        value //= 10
    return text


def _launch(args: tuple, lengths, text, P: int, letters: list[int],
            write: bool) -> None:
    """One pass of ``csrc/cigar.cu`` on the current stream."""
    lib = _build.load()
    packed = letters[0] | letters[1] << 8 | letters[2] << 16 | letters[3] << 24
    with torch.cuda.device(args[0].device), kernel_span(
            "cigar", args, args[0].numel()):
        err = lib.cga_cigar(*(x.data_ptr() for x in args), lengths.data_ptr(),
                            text.data_ptr(), P, packed, int(write),
                            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cigar")


def cigar_text(words: torch.Tensor, seg_base: torch.Tensor,
               seg_first: torch.Tensor, seg_end: torch.Tensor,
               path_seg: torch.Tensor, extended: bool = False
               ) -> torch.Tensor:
    """The CIGAR text of every path, on the tensors' device (see the module
    docstring).  -> uint8, each path's CIGAR followed by ``"\\n"``."""
    if words.device.type == "cpu":
        return cigar_text_torch(words, seg_base, seg_first, seg_end,
                                path_seg, extended)
    _check(words, seg_base, seg_first, seg_end, path_seg)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    args = tuple(x.contiguous() for x in (words, seg_base, seg_first,
                                          seg_end, path_seg))
    P = path_seg.numel() - 1
    dev = words.device
    letters = _letters(extended)
    counts = torch.empty(P, dtype=torch.int64, device=dev)
    text = torch.empty(0, dtype=torch.uint8, device=dev)
    _launch(args, counts, text, P, letters, False)
    offsets = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    offsets[1:] = counts.cumsum(0)
    text = torch.empty(int(to_host(offsets[-1:])[0]), dtype=torch.uint8,
                       device=dev)
    _launch(args, offsets, text, P, letters, True)
    return text


def cigar_strings(words: torch.Tensor, seg_base: torch.Tensor,
                  seg_first: torch.Tensor, seg_end: torch.Tensor,
                  path_seg: torch.Tensor,
                  extended: bool = False) -> list[str]:
    """One CIGAR string a path: :func:`cigar_text` read back once."""
    text = to_host(cigar_text(words, seg_base, seg_first, seg_end, path_seg,
                              extended)).numpy()
    count("cigar.paths", path_seg.numel() - 1)
    count("cigar.segments", seg_base.numel())
    count("cigar.bytes", text.size)
    return text.tobytes().decode("ascii").split("\n")[:-1]
