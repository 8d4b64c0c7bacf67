"""The exchanges the sharded paths make between the ranks of one mesh axis
(the JAX package's ``all_gather``, ``all_to_all``, ``psum`` and
``ppermute`` inside ``shard_map``).

Each helper takes the axis's process group (None: the axis has one rank,
and the exchange is the identity) and works on tensors on the rank's
device.  NCCL exchanges them on the card; gloo has no CUDA ``all_gather``,
``all_to_all``, ``send`` or ``recv``, so under gloo every exchanged tensor
goes through host memory and comes back to its device.
"""

import torch
import torch.distributed as dist

from ..utils.profiling import count


def _on_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where the group's backend exchanges it: the host for gloo."""
    return x.cpu() if dist.get_backend(group) == "gloo" else x


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` in group-rank order, on ``x``'s device.  The
    leading dimension may differ between ranks; the others must agree."""
    n = group_size(group)
    if n == 1:
        return [x]
    w = _on_wire(x.contiguous(), group)
    sizes = [torch.zeros(1, dtype=torch.int64, device=w.device)
             for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([w.shape[0]], device=w.device),
                    group=group)
    sizes = [int(s) for s in sizes]
    pad = max(sizes)
    if pad == 0:
        return [x] * n
    if w.shape[0] < pad:
        w = torch.cat([w, w.new_zeros((pad - w.shape[0],) + w.shape[1:])])
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return [p[:s].to(x.device) for p, s in zip(parts, sizes)]


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather`, concatenated along the leading dimension."""
    return torch.cat(all_gather(x, group))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x (n, c, ...)``: row j goes to group rank j; returns ``(n, c,
    ...)`` with row i from group rank i (``lax.all_to_all`` with
    split_axis = concat_axis = 0), on ``x``'s device."""
    n = group_size(group)
    if n == 1:
        return x
    w = _on_wire(x.contiguous(), group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    # bytes this process sends, its own share included
    count("comm.all_to_all_bytes", w.numel() * w.element_size())
    return out.to(x.device)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of every rank's ``x``, on ``x``'s device."""
    if group_size(group) == 1:
        return x
    w = _on_wire(x.clone(), group)
    dist.all_reduce(w, op=op, group=group)
    return w.to(x.device)


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send ``x`` to group rank ``dst``."""
    dist.send(_on_wire(x.contiguous(), group),
              dist.get_global_rank(group, dst), group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped as ``like`` from group rank ``src``, on ``like``'s
    device."""
    w = torch.empty_like(_on_wire(like, group))
    dist.recv(w, dist.get_global_rank(group, src), group=group)
    return w.to(like.device)
