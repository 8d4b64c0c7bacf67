"""Banded-NW dispatch (counterpart of claragenomicsanalysis_tpu/ops/
banded.py): the one seam through which the aligner reaches its DP.

Two kernels compute the same banded NW, with the same scores and the same
canonical paths, in two traceback layouts (``KERNELS``):

- ``"diag"`` (ops/nw_diag.py, B1): the anti-diagonal sweep, the default;
- ``"row"`` (ops/nw_row.py, B3): the query-row sweep with an in-row min-plus
  prefix scan, the counterpart of the JAX ``backend="pallas-row"``.

The caller names the kernel (``create_aligner(..., kernel=)``), and each
kernel's traceback goes to its own layout's decoder: the layout is never
guessed from the array's shape.  The JAX package also falls back from one
kernel to the other, or to an XLA scan, for radii below 4 and for buckets
whose blocks overflow the TPU's scoped VMEM.  A Hopper block has a limit
too, 227 KB of shared memory, which wide bands pass (a pair whose lengths
differ by more than 16,384, a Hirschberg base case against a long target,
long reads): each kernel then runs its device-memory variant, chosen from
the shapes by ``nw_diag_plan`` / ``nw_row_plan``, never by catching an
error.  The port has no fallback to another kernel or to a plain version.

Every banded launch of the port, whichever algorithm makes it, is sized by
:func:`launch_chunks` from the chosen kernel's traceback bytes and the
scratch its variant takes.
"""

import functools

import numpy as np
import torch

from .nw_diag import (band_slots, banded_nw_diag, nw_diag_scratch_bytes,
                      padded_diagonals)
from .nw_row import (band_width_row, banded_nw_row, nw_row_scratch_bytes,
                     tb_rows)
from .tb_decode import traceback_paths_device

#: the banded-NW kernels, by the name a caller gives
KERNELS = ("diag", "row")


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown banded-NW kernel {kernel!r}; "
                         f"one of {KERNELS}")


def tb_bytes_per_problem(Lq: int, Lt: int, r: int,
                         kernel: str = "diag") -> int:
    """Packed traceback bytes one problem of a (Lq, Lt) batch adds to a
    launch of ``kernel`` at radius r: ``Dpad / 4 * round_up(r + 1, 8)`` for
    the diag layout, ``round_up(Lq, 16) / 4 * round_up(2r + 1, 8)`` for the
    row layout.  It sizes chunks only and never changes a result."""
    _check_kernel(kernel)
    if kernel == "row":
        return tb_rows(Lq) * band_width_row(r)
    return padded_diagonals(Lq, Lt) // 4 * band_slots(r)


def scratch_bytes_per_problem(Lq: int, Lt: int, r: int,
                              kernel: str = "diag") -> int:
    """Device scratch one problem of a (Lq, Lt) batch takes in a launch of
    ``kernel`` at radius r: 0 where the kernel's shared-memory variant runs,
    the diagonals or the row where its device-memory variant does."""
    _check_kernel(kernel)
    if kernel == "row":
        return nw_row_scratch_bytes(Lq, Lt, r)
    return nw_diag_scratch_bytes(Lq, Lt, r)


#: device-memory budget for the tracebacks (and scratch) of one banded
#: launch
MEM_BUDGET_PER_DISPATCH = 1 << 28


def launch_chunks(idxs, Lq: int, Lt: int, r: int,
                  kernel: str = "diag") -> list[np.ndarray]:
    """``idxs`` (problems of a (Lq, Lt) batch, all at radius r) cut into
    the problems of successive launches of ``kernel``, each launch's
    tracebacks and scratch within MEM_BUDGET_PER_DISPATCH."""
    per = (tb_bytes_per_problem(Lq, Lt, r, kernel)
           + scratch_bytes_per_problem(Lq, Lt, r, kernel))
    n = max(1, MEM_BUDGET_PER_DISPATCH // max(1, per))
    idxs = np.asarray(idxs)
    return [idxs[s: s + n] for s in range(0, len(idxs), n)]


def resolve(device, kernel: str = "diag") -> tuple:
    """-> (nw_fn, decode_fn) of ``kernel`` for ``device``.

    nw_fn(q, qlen, t, tlen, r) returns (scores, tb) on the inputs' device;
    decode_fn(tb, qlen, tlen, r) returns the edit paths as code lists.  Both
    launch their kernels for CUDA tensors and run their plain versions for
    CPU tensors.  Raises ValueError for a kernel not in KERNELS and
    RuntimeError when ``device`` is CUDA and no card is present."""
    _check_kernel(kernel)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch finds no "
                               "CUDA device")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    nw_fn = banded_nw_row if kernel == "row" else banded_nw_diag
    return nw_fn, functools.partial(traceback_paths_device, kernel=kernel)
