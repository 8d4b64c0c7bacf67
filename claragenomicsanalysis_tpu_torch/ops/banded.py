"""Banded-NW dispatch (counterpart of claragenomicsanalysis_tpu/ops/
banded.py): the one seam through which the aligner reaches its DP.

The port has one kernel kind, the anti-diagonal sweep of ops/nw_diag.py, at
every band radius.  The JAX package also routes to a row-sweep kernel and to
an XLA scan for radii below 4 and for buckets whose blocks overflow the TPU's
scoped VMEM, and must then tell the two traceback layouts apart when it
decodes.  A Hopper thread block has no such limit at these shapes, so the
port keeps a single layout and no fallback.

Every banded launch of the port, whichever algorithm makes it, is sized by
:func:`launch_chunks` from that layout's traceback bytes.
"""

import numpy as np
import torch

from .nw_diag import band_slots, banded_nw_diag, padded_diagonals
from .tb_decode import traceback_paths_device


def tb_bytes_per_problem(Lq: int, Lt: int, r: int) -> int:
    """Packed traceback bytes one problem of a (Lq, Lt) batch adds to a
    launch at radius r (the diag layout, ``tb (Dpad / 4, B, W)``).  It sizes
    chunks only and never changes a result."""
    return padded_diagonals(Lq, Lt) // 4 * band_slots(r)


#: device-memory budget for the tracebacks of one banded launch
MEM_BUDGET_PER_DISPATCH = 1 << 28


def launch_chunks(idxs, Lq: int, Lt: int, r: int) -> list[np.ndarray]:
    """``idxs`` (problems of a (Lq, Lt) batch, all at radius r) cut into
    the problems of successive launches, each launch's tracebacks within
    MEM_BUDGET_PER_DISPATCH."""
    n = max(1, MEM_BUDGET_PER_DISPATCH // tb_bytes_per_problem(Lq, Lt, r))
    idxs = np.asarray(idxs)
    return [idxs[s: s + n] for s in range(0, len(idxs), n)]


def resolve(device) -> tuple:
    """-> (nw_fn, decode_fn) for ``device``.

    nw_fn(q, qlen, t, tlen, r) returns (scores, tb) on the inputs' device;
    decode_fn(tb, qlen, tlen, r) returns the edit paths as code lists.  Both
    launch their kernels for CUDA tensors and run their plain versions for
    CPU tensors; raises when ``device`` is CUDA and no card is present."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch finds no "
                               "CUDA device")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return banded_nw_diag, traceback_paths_device
