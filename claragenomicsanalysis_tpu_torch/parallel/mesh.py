"""A grid of ranks over ('data', 'rep', 'sp') (counterpart of
``claragenomicsanalysis_tpu/parallel/mesh.py``).

The JAX mesh is a grid of one process's devices; here it is a grid of
ranks, one process each (parallel/multihost.py), with the JAX axis names:

- ``data``: problems and windows split into contiguous slices, merged by
  concatenation;
- ``rep``: the minimizer target index split into sorted-representation
  blocks, anchors routed to the rank owning their query reads;
- ``sp``: one problem's DP matrix split into target stripes, the frontier
  passed along the ring (ring_nw.py).

Rank ``k`` of the mesh is world rank ``k`` and runs on ``devices[k]``.
Each axis of more than one rank gets one process group a line (the ranks
that share the other two coordinates), made once a process for each rank
set (multihost.group_of).  Making a group is a call of every rank of the
world, so every rank builds every mesh, in one order (SPMD).  A mesh also
makes the group of all its ranks, the one line of each of its
``axis_meshes`` views, so a library call that derives the views (the
compositions do) is made by the mesh's own ranks alone.  A rank outside a
mesh holds no coordinates and calls none of its sharded functions.
"""

import numpy as np
import torch

from .multihost import (group_of, process_count, process_index,
                        world_devices)

AXES = ("data", "rep", "sp")


def local_device_count() -> int:
    """The cards torch finds, or 1 (the CPU) without one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


class Mesh:
    """Ranks 0 .. n-1 laid out as ``devices`` (data, rep, sp)."""

    def __init__(self, devices: np.ndarray):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 3:
            raise ValueError("a mesh is a (data, rep, sp) grid of devices")
        self.devices = devices
        self.axis_names = AXES
        self.shape = dict(zip(AXES, devices.shape))
        self.size = devices.size
        if self.size > process_count():
            raise ValueError(f"a mesh of {self.size} ranks needs as many "
                             f"processes; the world has {process_count()}")
        ranks = np.arange(self.size).reshape(devices.shape)
        me = process_index()
        self.coords = (dict(zip(AXES, map(int, np.argwhere(ranks == me)[0])))
                       if me < self.size else None)
        self.device = (torch.device(devices.reshape(-1)[me])
                       if self.coords is not None else None)
        self._lines: dict[str, list[int]] = {}
        self._groups: dict[str, object] = {}
        for ax, name in enumerate(AXES):
            if devices.shape[ax] == 1:
                continue
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, devices.shape[ax])
            for line in lines.tolist():
                group = group_of(line)
                if self.coords is not None and me in line:
                    self._lines[name] = line
                    self._groups[name] = group
        if self.size > 1:
            group_of(list(range(self.size)))     # the views' one line

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.reshape(-1).tolist()})"

    def require_member(self) -> None:
        if self.coords is None:
            raise ValueError(f"rank {process_index()} is not in {self}")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        self.require_member()
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line on ``axis`` (None where the
        axis has one rank)."""
        self.require_member()
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> list[int]:
        """World ranks of this rank's line on ``axis``, by coordinate."""
        self.require_member()
        return self._lines.get(axis, [process_index()])


def make_mesh(data: int | None = None, rep: int = 1, sp: int = 1,
              devices=None) -> Mesh:
    """Mesh with axes ('data', 'rep', 'sp') over the first data * rep * sp
    ranks; ``data`` fills the remaining ranks when None.  ``devices``: one
    device a rank (default: the world's, multihost.world_devices)."""
    devices = list(devices if devices is not None else world_devices())
    n = len(devices)
    if data is None:
        if n % (rep * sp):
            raise ValueError(f"{n} devices not divisible by rep*sp={rep * sp}")
        data = n // (rep * sp)
    need = data * rep * sp
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    arr = np.empty(need, dtype=object)
    arr[:] = [str(d) for d in devices[:need]]
    return Mesh(arr.reshape(data, rep, sp))


def axis_meshes(mesh: Mesh | None) -> tuple[Mesh | None, Mesh | None]:
    """(data-major, rep-major) views over the same ranks: every rank on
    'data' for the data-sharded stages (POA windows, alignment batches),
    every rank on 'rep' for the rep-sharded ones (minimizer matching)."""
    if mesh is None:
        return None, None
    devs = mesh.devices.reshape(-1)
    n = devs.size
    return Mesh(devs.reshape(n, 1, 1)), Mesh(devs.reshape(1, n, 1))
