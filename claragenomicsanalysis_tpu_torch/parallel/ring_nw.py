"""Ring-wavefront edit distance over the 'sp' axis (counterpart of
``claragenomicsanalysis_tpu/parallel/ring_nw.py``).

One problem's DP matrix is split by target stripes: rank d of an 'sp' line
owns columns d*S+1 .. (d+1)*S of the padded target.  It computes its stripe
row by row; row i needs only D[i-1, d*S] and D[i, d*S] from its left
neighbour, which rank d-1 sends it (the JAX ``ppermute``) right after
computing its own row i, so rank d works on row i while rank d-1 works on
row i+1: a systolic wavefront, every rank busy after sp - 1 rows.  Rank 0
takes the column-0 boundary D[i, 0] = i.  The in-row deletion chain is a
``torch.cummin``: row[x] = x + cummin(D[i, d*S], vals[l] - l).

The JAX package computes this as plain XLA, so these are torch ops on the
rank's device and point-to-point sends, not a kernel.  Unit-cost
distances, equal to cpu/nw_oracle.nw_matrix and to ops.myers'
bottom rows.  The batch splits over 'data' as the data-sharded paths do,
and every rank of the mesh gets the whole result.  Each row is one
exchange, so a pair of query length Lq costs Lq exchanges a rank; under
gloo each one goes through host memory.
"""

import numpy as np
import torch

from . import comm
from .shard import shard_slice


def _as_tensor(x, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return t.to(device)


def _stripe(q, qlen, t, tlen, c0: int, mesh, want_rows: bool):
    """This rank's stripe (target columns c0+1 .. c0+S) of its data slice:
    the captured bottom row D[qlen, c0+1 .. c0+S] (B, S), or the score of
    the problems whose column tlen lies in the stripe (else 0) (B,)."""
    B, S = t.shape
    d, sp = mesh.axis_index("sp"), mesh.shape["sp"]
    group = mesh.group("sp")
    dev = t.device
    xx = torch.arange(1, S + 1, dtype=torch.int32, device=dev)
    row = (c0 + xx).expand(B, S).contiguous()            # D[0, stripe]
    caught = row.clone()                       # qlen == 0: D[0, :]
    tcol = (tlen - c0 - 1).long()
    owns = (tcol >= 0) & (tcol < S) & (tlen >= 1) & (qlen >= 1)
    tcol = tcol.clamp(0, max(S - 1, 0))[:, None]
    score = torch.zeros(B, dtype=torch.int32, device=dev)
    frontier = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    n_rows = int(qlen.max()) if B else 0       # the same on the whole line
    for i in range(1, n_rows + 1):
        if d == 0:
            prev_col = torch.full((B,), i - 1, dtype=torch.int32, device=dev)
            cur_col = prev_col + 1
        else:
            msg = comm.recv(frontier, d - 1, group)
            prev_col, cur_col = msg[:, 0], msg[:, 1]
        qch = q[:, i - 1:i]
        sub = ((qch != t) | (qch < 0)).to(torch.int32)
        diag = torch.cat([prev_col[:, None], row[:, :-1]], 1)
        vals = torch.minimum(diag + sub, row + 1)
        seeded = torch.cat([cur_col[:, None], vals - xx], 1)
        new = torch.cummin(seeded, 1).values[:, 1:] + xx
        if d < sp - 1:
            comm.send(torch.stack([row[:, -1], new[:, -1]], 1), d + 1, group)
        hit = qlen == i
        if want_rows:
            caught = torch.where(hit[:, None], new, caught)
        else:
            score = torch.where(hit & owns, new.gather(1, tcol)[:, 0], score)
        row = new
    return caught if want_rows else torch.where(owns, score, 0)


def _split(q, qlen, t, tlen, mesh, device):
    """This rank's problems and stripe: (q, qlen, t stripe, tlen, c0) on
    ``device``.  As in the JAX function, the batch is padded with empty
    problems to a multiple of the 'data' ranks and the target with -1 to a
    multiple of sp columns."""
    n_data, sp = mesh.shape["data"], mesh.shape["sp"]
    device = torch.device(device if device is not None else mesh.device)
    q, qlen, t, tlen = (_as_tensor(a, device) for a in (q, qlen, t, tlen))
    B, Lt = t.shape
    Bp = -(-max(B, n_data) // n_data) * n_data
    Ltp = -(-max(Lt, sp) // sp) * sp
    q = torch.cat([q, q.new_full((Bp - B, q.shape[1]), -1)])
    t = torch.cat([t, t.new_full((Bp - B, Lt), -1)])
    t = torch.cat([t, t.new_full((Bp, Ltp - Lt), -1)], 1)
    qlen, tlen = (torch.cat([x.to(torch.int32), x.new_zeros(Bp - B,
                                                            dtype=torch.int32)])
                  for x in (qlen, tlen))
    S = Ltp // sp
    c0 = mesh.axis_index("sp") * S
    sl = shard_slice(Bp, n_data, mesh.axis_index("data"))
    return q[sl], qlen[sl], t[sl, c0:c0 + S], tlen[sl], c0


def ring_wavefront_nw_rows(q, qlen, t, tlen, mesh, device=None) -> np.ndarray:
    """Bottom edit-distance rows D[qlen, 0..Lt] with the target split over
    'sp' and the batch over 'data' (Hirschberg's split input for levels
    too long for one Myers pass): (B, Lt+1) int32, column 0 = qlen.
    ``q``, ``t``: (B, L) codes, -1 past the lengths (arrays or tensors);
    ``device``: where the rank computes (default: its mesh device)."""
    B, Lt = np.shape(t)
    q, ql, ts, tl, c0 = _split(q, qlen, t, tlen, mesh, device)
    stripe = _stripe(q, ql, ts, tl, c0, mesh, want_rows=True)
    rows = torch.cat(comm.all_gather(stripe.T.contiguous(),
                                     mesh.group("sp")), 0).T
    rows = comm.all_gather_cat(rows.contiguous(), mesh.group("data"))
    qlen = np.asarray(torch.as_tensor(qlen).cpu(), np.int32).reshape(-1, 1)
    return np.concatenate([qlen, rows[:B, :Lt].cpu().numpy()], 1)


def ring_wavefront_nw(q, qlen, t, tlen, mesh, device=None) -> np.ndarray:
    """Global edit distance with the target split over 'sp' and the batch
    over 'data': (B,) int32 scores equal to the full NW distance."""
    B = np.shape(t)[0]
    q, ql, ts, tl, c0 = _split(q, qlen, t, tlen, mesh, device)
    part = _stripe(q, ql, ts, tl, c0, mesh, want_rows=False)
    score = comm.all_reduce(part, mesh.group("sp"))
    score = torch.where(ql == 0, tl, torch.where(tl == 0, ql, score))
    return comm.all_gather_cat(score, mesh.group("data")).cpu().numpy()[:B]
