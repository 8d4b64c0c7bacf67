"""The POA graph state of a batch of windows (counterpart of ``PoaState`` and
``init_state`` in ``claragenomicsanalysis_tpu/ops/poa_ops.py``).

Each field has a leading window axis W; N = ``BatchSize.padded_nodes``,
P = ``max_pred_per_node``, A = ``max_aligned_per_node``:

  base (W, N)      node bases, -1 on unused slots
  cov (W, N)       per-node coverage (weights summed)
  npred (W, N)     in-degree; pred / predw (W, N, P) sorted by pred index
  nsucc (W, N)     out-degree (a count: no successor lists are kept)
  nalig (W, N)     aligned-clique size; alig (W, N, A) sorted ascending
  node_count (W,), status (W,)
  paths (W, S, L)  the node sequence s visits at its position j, -1 where
                   none; None unless the MSA is asked for

All int32.  Only the MSA reads ``paths``, so a consensus-only run keeps it
``None`` and neither allocates nor copies it: ``init_state(..., msa=False)``
leaves it out, and every function that returns a new state copies it only
when it is there.  Nodes ``u < node_count`` are active; ``node_count`` may
exceed N in a window whose first sequence overflowed (its status says so).
"""

from typing import NamedTuple

import torch

from ..core.config import BatchSize
from ..core.status import StatusType

#: score of a cell no path reaches (poa_ops.NEG); sums on it stay in int32
NEG = -(2**30)


class PoaState(NamedTuple):
    base: torch.Tensor
    cov: torch.Tensor
    npred: torch.Tensor
    pred: torch.Tensor
    predw: torch.Tensor
    nsucc: torch.Tensor
    nalig: torch.Tensor
    alig: torch.Tensor
    node_count: torch.Tensor
    status: torch.Tensor
    paths: torch.Tensor | None = None

    def clone(self) -> "PoaState":
        """A copy with its own storage (contiguous), ``paths`` included when
        it is there."""
        return PoaState(*(None if t is None else t.contiguous().clone()
                          for t in self))

    def tensors(self) -> tuple:
        """The fields that are there (``paths`` left out when None)."""
        return tuple(t for t in self if t is not None)


def padget_cols(arr: torch.Tensor, idx: torch.Tensor,
                fill: int) -> torch.Tensor:
    """``arr[w, idx[w, ...]]`` per window w, ``fill`` where an index is out
    of ``arr``'s second axis (poa_ops._padget, batched)."""
    n = arr.shape[1]
    ok = (idx >= 0) & (idx < n)
    flat = idx.clamp(0, max(n - 1, 0)).reshape(arr.shape[0], -1).long()
    v = torch.gather(arr, 1, flat).reshape(idx.shape) if n else \
        torch.zeros(idx.shape, dtype=arr.dtype, device=arr.device)
    return torch.where(ok, v, torch.full_like(v, fill))


def init_state(bs: BatchSize, seq0: torch.Tensor, w0: torch.Tensor,
               len0: torch.Tensor, msa: bool = False) -> PoaState:
    """Each window's graph is the chain of its first sequence.

    seq0, w0: (W, L) int32 codes and weights; len0: (W,) int32.  A first
    sequence longer than ``max_nodes_per_window`` gives the window
    NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE.  With ``msa`` the state carries
    ``paths``: row 0 is ``0..len0 - 1``, every other entry -1."""
    W = seq0.shape[0]
    N, P, A = bs.padded_nodes, bs.max_pred_per_node, bs.max_aligned_per_node
    dev, i32 = seq0.device, torch.int32
    idx = torch.arange(N, dtype=i32, device=dev).expand(W, N)
    l0 = len0.to(i32)[:, None]
    active = idx < l0
    base = torch.where(active, padget_cols(seq0, idx, -1), -1).to(i32)
    cov = torch.where(active, padget_cols(w0, idx, 0), 0).to(i32)
    npred = (active & (idx > 0)).to(i32)
    pred = torch.full((W, N, P), -1, dtype=i32, device=dev)
    pred[:, :, 0] = torch.where(npred > 0, idx - 1, -1)
    ew = torch.minimum(padget_cols(w0, (idx - 1).clamp(min=0), 0),
                       padget_cols(w0, idx, 0))
    predw = torch.zeros((W, N, P), dtype=i32, device=dev)
    predw[:, :, 0] = torch.where(npred > 0, ew, 0)
    nsucc = (active & (idx < l0 - 1)).to(i32)
    nalig = torch.zeros((W, N), dtype=i32, device=dev)
    alig = torch.full((W, N, A), -1, dtype=i32, device=dev)
    status = torch.where(
        len0 > bs.max_nodes_per_window,
        int(StatusType.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE),
        int(StatusType.SUCCESS)).to(i32)
    paths = None
    if msa:
        S, L = bs.max_sequences_per_poa, bs.padded_seq
        jj = torch.arange(L, dtype=i32, device=dev).expand(W, L)
        paths = torch.full((W, S, L), -1, dtype=i32, device=dev)
        paths[:, 0] = torch.where(jj < l0, jj, -1)
    return PoaState(base, cov, npred, pred, predw, nsucc, nalig, alig,
                    len0.to(i32).clone(), status, paths)


def init_level(N: int, len0: torch.Tensor) -> torch.Tensor:
    """The topological levels of the initial chains: node u at level u."""
    idx = torch.arange(N, dtype=torch.int32, device=len0.device)[None, :]
    return torch.where(idx < len0[:, None], idx, 0).to(torch.int32)
