"""Batched partial-order alignment, consensus and MSA — the cudapoa
counterpart, in PyTorch (port of ``claragenomicsanalysis_tpu/models/poa.py``).

``create_batch(...)`` -> ``Batch`` with ``add_poa_group`` /
``generate_poa`` / ``get_consensus`` / ``get_msa`` / ``get_graphs`` /
``reset``, and the per-window ``StatusType`` rules of the JAX package.  The
work runs on an explicit ``torch.device``: on ``cuda`` through the
hand-written kernels of ops/, on ``cpu`` through their plain PyTorch
versions.  ``kernel`` names which kernels run there, with the same outputs:

- ``"lockstep"`` (the default, the JAX package's ``backend="pallas2"``): all
  windows of a launch go through each step together, one kernel per step
  (``ops.poa_window.run_windows``);
- ``"window"`` (the JAX package's ``backend="pallas"``): one kernel runs the
  whole POA of each window (``ops.poa_window.poa_window``).

``generate_poa`` only enqueues; ``get_consensus`` and ``get_msa`` wait for
the results.  The MSA (``output_mask`` with ``OutputType.MSA``) costs the
per-sequence ``paths`` in the graph state and the gapped rows; a
consensus-only batch carries neither.  Windows go into launches by the
device bytes each needs on the batch's route (:func:`window_bytes`, mostly
the graph NW's score plane) under ``POA_MEM_BUDGET``; each window's result
does not depend on the others, so the cut never changes a result.
"""

import itertools

import numpy as np
import torch

from ..core.config import BatchSize, PoaScores
from ..core.status import OutputType, StatusType
from ..ops.poa_nwtb import plane_bytes
from ..ops.poa_window import poa_window, run_windows, window_scratch_bytes
from ..utils.genomeutils import BASES, encode
from ..utils.graph import DirectedGraph
from ..utils.profiling import to_host, trace_range

#: device-memory budget of one launch's windows (the JAX package's
#: read correction, models/correct.py, plans its POA dispatches by the
#: same 1 GiB)
POA_MEM_BUDGET = 1 << 30

KERNELS = ("lockstep", "window")
#: consensus letter per code + 1 slot for N (codes < 0)
_CHARS = np.frombuffer((BASES + "N").encode(), dtype=np.uint8)
#: MSA letter per code + 1 slot for a gap (codes < 0)
_MSA_CHARS = np.frombuffer((BASES + "-").encode(), dtype=np.uint8)


def window_bytes(bs: BatchSize, msa: bool = False,
                 scores: PoaScores | None = None,
                 kernel: str = "lockstep") -> int:
    """Device bytes one window holds during a launch of ``kernel``: the
    graph NW's score plane (in the kernels' words for these scores) and
    the window's sequences and weights, then for ``"lockstep"`` two copies
    of the graph state (the add writes a new one) and the path, with the
    MSA also the two states' ``paths``; for ``"window"`` the window's slice
    of B10's scratch (``ops.poa_window.window_scratch_bytes``: the graph,
    the path and the phases' tables), with the MSA also its ``paths``.
    Both count the MSA's rows."""
    N, L, S = bs.padded_nodes, bs.padded_seq, bs.max_sequences_per_poa
    P, A = bs.max_pred_per_node, bs.max_aligned_per_node
    total = plane_bytes(N, L, scores) + 8 * S * L
    if kernel == "window":
        total += window_scratch_bytes(bs)
        if msa:
            total += 4 * S * L + 4 * S * N
        return total
    state = 4 * N * (6 + 2 * P + A)
    total += 2 * state + 8 * (N + L)
    if msa:
        total += 2 * 4 * S * L + 4 * S * N
    return total


def launch_chunks(n_windows: int, bs: BatchSize, msa: bool = False,
                  scores: PoaScores | None = None,
                  kernel: str = "lockstep") -> list[range]:
    """Windows 0..n_windows-1 cut into successive launches of ``kernel``,
    each within POA_MEM_BUDGET (a launch holds at least one window)."""
    n = max(1, POA_MEM_BUDGET // window_bytes(bs, msa, scores, kernel))
    return [range(s, min(s + n, n_windows)) for s in range(0, n_windows, n)]


class Batch:
    """POA batch over padded windows, on one ``torch.device``."""

    _next_id = itertools.count()

    def __init__(self, batch_size: BatchSize | None = None,
                 scores: PoaScores | None = None,
                 output_mask: int = OutputType.CONSENSUS,
                 max_poas: int = 1024, banded_alignment: bool = False,
                 device="cuda", kernel: str = "lockstep", mesh=None):
        self.output_mask = OutputType(output_mask)
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, not "
                             f"{kernel!r}")
        self.kernel = kernel
        self.batch_size = batch_size or BatchSize()
        self.scores = scores or PoaScores()
        self.max_poas = max_poas
        self.banded_alignment = banded_alignment
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch finds no "
                               "CUDA device")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.mesh = mesh        # windows split over its 'data' axis
        self._batch_id = next(Batch._next_id)
        self._groups: list[tuple[list[str], list[list[int]]]] = []
        self._host_status: list[StatusType] = []
        self._out = None        # host (NumPy) outputs
        self._out_dev = None    # enqueued device outputs

    # ------------------------------------------------------------------ API

    def add_poa_group(self, seqs: list[str],
                      weights: list[list[int]] | None = None) -> StatusType:
        bs = self.batch_size
        if len(self._groups) >= self.max_poas:
            return StatusType.EXCEEDED_MAXIMUM_POAS
        status = StatusType.SUCCESS
        if len(seqs) > bs.max_sequences_per_poa:
            status = StatusType.EXCEEDED_MAXIMUM_SEQUENCES_PER_POA
        elif any(len(s) > bs.max_sequence_size for s in seqs):
            status = StatusType.EXCEEDED_MAXIMUM_SEQUENCE_SIZE
        self._groups.append((seqs, weights))      # None: every weight 1
        self._host_status.append(status)
        self._out = self._out_dev = None
        return status

    def get_total_poas(self) -> int:
        return len(self._groups)

    def batch_id(self) -> int:
        return self._batch_id

    def _pack_arrays(self):
        """(seqs, weights (W, S, L), lens (W, S), n_seqs (W,)) int32 NumPy
        arrays; a window refused on the host is packed empty."""
        bs = self.batch_size
        S, L, W = bs.max_sequences_per_poa, bs.padded_seq, len(self._groups)
        with trace_range("poa.pack"):
            seqs = np.full((W, S, L), -1, dtype=np.int32)
            weights = np.zeros((W, S, L), dtype=np.int32)
            lens = np.zeros((W, S), dtype=np.int32)
            n_seqs = np.zeros(W, dtype=np.int32)
            rows, cols, strs, given = [], [], [], []
            for wi, ((group, wt), hstat) in enumerate(
                    zip(self._groups, self._host_status)):
                if hstat != StatusType.SUCCESS:
                    # an empty window; the host status wins at decode
                    continue
                n_seqs[wi] = len(group)
                if wt is not None:
                    given += [(len(strs) + si, w) for si, w in enumerate(wt)]
                rows += [wi] * len(group)
                cols += range(len(group))
                strs += group
            n = np.array([len(s) for s in strs], dtype=np.int64)
            lens[rows, cols] = n
            if n.sum():
                # every base of every sequence in one encode and one
                # scatter: base k of sequence q lands at flat
                # (row_q * S + col_q) * L + k
                start = np.cumsum(n) - n
                row_off = (np.array(rows, dtype=np.int64) * S
                           + np.array(cols, dtype=np.int64)) * L
                flat = np.arange(n.sum()) + np.repeat(row_off - start, n)
                seqs.reshape(-1)[flat] = encode("".join(strs))
                w = np.ones(n.sum(), dtype=np.int32)
                for k, wk in given:
                    w[start[k]:start[k] + n[k]] = wk
                weights.reshape(-1)[flat] = w
            return seqs, weights, lens, n_seqs

    @property
    def _msa(self) -> bool:
        return bool(self.output_mask & OutputType.MSA)

    def _launches(self, arrays=None):
        """Each launch's windows, as (seqs, weights, lens, n_seqs) tensors on
        the batch's device (``arrays``: packed windows, default all)."""
        if arrays is None:
            arrays = self._pack_arrays()
        with trace_range("poa.pack"):
            arrays = [torch.from_numpy(a).to(self.device) for a in arrays]
        for c in launch_chunks(arrays[0].shape[0], self.batch_size,
                               self._msa, self.scores, self.kernel):
            yield tuple(a[c.start:c.stop] for a in arrays)

    def _run(self, *arrays):
        """The route over packed windows -> their six outputs (consensus
        codes, coverage, lengths, MSA rows, column counts, status) as
        tensors on the device, enqueued."""
        bs, sc, banded = self.batch_size, self.scores, self.banded_alignment
        if self.kernel == "window":
            outs = [poa_window(*launch, bs, sc, banded, self._msa)
                    for launch in self._launches(arrays)]
        else:
            outs = [run_windows(bs, sc, banded, *launch, self._msa)[:6]
                    for launch in self._launches(arrays)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def generate_poa(self) -> None:
        """Pack the windows and enqueue their launches; returns without
        waiting for the device.  With a mesh of more than one rank on
        'data', each rank runs its slice of the windows and the outputs
        are gathered here (parallel/shard.sharded_poa), which waits."""
        if not self._groups:
            self._out = (np.zeros((0, 0), np.int32),) * 2 + (
                np.zeros(0, np.int32), np.zeros((0, 0, 0), np.int32)) + (
                np.zeros(0, np.int32),) * 2
            return
        with trace_range("poa.generate"):
            if self.mesh is not None and self.mesh.shape.get("data", 1) > 1:
                from ..parallel.shard import sharded_poa
                self._out = sharded_poa(self._run, *self._pack_arrays(),
                                        self.mesh)
            else:
                self._out_dev = self._run(*self._pack_arrays())

    def _ensure(self):
        if self._out is None:
            if self._out_dev is None:
                self.generate_poa()
            if self._out is None:
                self._out = tuple(to_host(t).numpy() for t in self._out_dev)
                self._out_dev = None

    def get_consensus(self):
        """Returns (consensus list[str], coverage list[list[int]],
        statuses list[StatusType])."""
        self._ensure()
        codes, covs, lengths, _, _, dstat = self._out
        # negative codes are ambiguous-base (N) nodes, kept in place
        chars = _CHARS[np.where(np.asarray(codes) >= 0,
                                np.clip(codes, 0, 3), 4)]
        out_s, out_c, out_st = [], [], []
        with trace_range("poa.decode"):
            for wi in range(len(self._groups)):
                st = self._status(wi, dstat)
                if st != StatusType.SUCCESS:
                    out_s.append("")
                    out_c.append([])
                    out_st.append(st)
                    continue
                n = min(int(lengths[wi]), self.batch_size.max_consensus_size)
                out_s.append(chars[wi, :n].tobytes().decode())
                out_c.append(covs[wi, :n].tolist())
                out_st.append(StatusType.SUCCESS)
        return out_s, out_c, out_st

    def _status(self, wi: int, dstat) -> StatusType:
        """The window's status: the host's refusal wins over the device's."""
        st = self._host_status[wi]
        return StatusType(int(dstat[wi])) if st == StatusType.SUCCESS else st

    def get_msa(self):
        """Returns (msa list[list[str]], statuses): per window one gapped
        row (``-`` for a gap) per sequence, all ``n_cols`` long; [] for a
        window that failed.  A batch made without ``OutputType.MSA``
        reports OUTPUT_TYPE_UNAVAILABLE for every window."""
        if not self._msa:
            n = len(self._groups)
            return ([[] for _ in range(n)],
                    [StatusType.OUTPUT_TYPE_UNAVAILABLE] * n)
        self._ensure()
        _, _, _, rows, n_cols, dstat = self._out
        chars = _MSA_CHARS[np.where(np.asarray(rows) >= 0,
                                    np.clip(rows, 0, 3), 4)]
        out_m, out_st = [], []
        for wi, (group, _) in enumerate(self._groups):
            st = self._status(wi, dstat)
            out_st.append(st)
            if st != StatusType.SUCCESS:
                out_m.append([])
                continue
            nc = int(n_cols[wi])
            out_m.append([chars[wi, si, :nc].tobytes().decode()
                          for si in range(len(group))])
        return out_m, out_st

    def get_graphs(self):
        """DirectedGraph views of the POA graphs the device built, one per
        window (None for a window that failed): node u labelled
        ``"<base>:<coverage>"``, one edge per filled pred slot with its
        weight.  The export makes its own run of the lockstep route (the
        only one that hands back the final graph state) and keeps nothing
        on the device afterwards."""
        if not self._groups:
            return []
        parts = []
        for launch in self._launches():
            st = run_windows(self.batch_size, self.scores,
                             self.banded_alignment, *launch)[6]
            parts.append([t.cpu().numpy() for t in (
                st.base, st.cov, st.npred, st.pred, st.predw, st.node_count,
                st.status)])
        base, cov, npred, pred, predw, ncount, dstat = (
            np.concatenate(p) for p in zip(*parts))
        graphs = []
        for wi in range(len(self._groups)):
            if self._status(wi, dstat) != StatusType.SUCCESS:
                graphs.append(None)
                continue
            g = DirectedGraph()
            for u in range(int(ncount[wi])):
                g.set_node_label(u, f"{BASES[base[wi, u]]}:{int(cov[wi, u])}")
                for p in range(int(npred[wi, u])):
                    g.add_edge(int(pred[wi, u, p]), u, int(predw[wi, u, p]))
            graphs.append(g)
        return graphs

    def reset(self) -> None:
        self._groups.clear()
        self._host_status.clear()
        self._out = self._out_dev = None


def create_batch(batch_size: BatchSize | None = None,
                 scores: PoaScores | None = None,
                 output_mask: int = OutputType.CONSENSUS,
                 max_poas: int = 1024,
                 gap_score: int | None = None,
                 mismatch_score: int | None = None,
                 match_score: int | None = None,
                 banded_alignment: bool = False,
                 device="cuda", kernel: str = "lockstep",
                 mesh=None) -> Batch:
    """Factory with the JAX package's arguments; the band width comes from
    BatchSize.band_width.  ``device`` is where the work runs; ``kernel``
    (``"lockstep"`` or ``"window"``, the counterpart of the JAX
    ``backend="pallas2"`` / ``"pallas"``) names which hand-written kernels
    run on a card, with the same outputs either way.  ``mesh``
    (parallel.mesh.make_mesh): windows split over its 'data' axis, every
    rank adding the same windows and reading every result."""
    if scores is None and any(v is not None for v in
                              (gap_score, mismatch_score, match_score)):
        d = PoaScores()
        scores = PoaScores(
            match_score=match_score if match_score is not None else d.match_score,
            mismatch_score=mismatch_score if mismatch_score is not None else d.mismatch_score,
            gap_score=gap_score if gap_score is not None else d.gap_score)
    return Batch(batch_size, scores, output_mask, max_poas, banded_alignment,
                 device, kernel, mesh)
