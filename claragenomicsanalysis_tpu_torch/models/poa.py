"""Batched partial-order alignment consensus — the cudapoa counterpart, in
PyTorch (port of ``claragenomicsanalysis_tpu/models/poa.py``).

``create_batch(...)`` -> ``Batch`` with ``add_poa_group`` /
``generate_poa`` / ``get_consensus`` / ``get_msa`` / ``reset``, and the
per-window ``StatusType`` rules of the JAX package.  The work runs on an
explicit ``torch.device``: on ``cuda`` through the hand-written kernels of
ops/, on ``cpu`` through their plain PyTorch versions.

All windows of a launch go through each step together.  Per added
sequence the host enqueues B7 topsort -> B5 graph NW and traceback -> B6
add-alignment (plus a few elementwise status updates) with no sync in
between; after the last one, B7 once more and B8 consensus.
``generate_poa`` only enqueues; ``get_consensus`` waits for the results.
Windows go into launches by the device bytes each needs
(:func:`window_bytes`, mostly B5's score plane) under ``POA_MEM_BUDGET``;
each window's result does not depend on the others, so the cut never
changes a result.
"""

import itertools

import numpy as np
import torch

from ..core.config import BatchSize, PoaScores
from ..core.status import OutputType, StatusType
from ..ops.poa_add import add_alignment
from ..ops.poa_consensus import consensus
from ..ops.poa_nwtb import graph_nw_traceback, plane_bytes
from ..ops.poa_state import init_level, init_state
from ..ops.poa_topsort import topsort
from ..utils.genomeutils import BASES, encode
from ..utils.profiling import trace_range

#: device-memory budget of one launch's windows (the JAX package's
#: read correction, models/correct.py, plans its POA dispatches by the
#: same 1 GiB)
POA_MEM_BUDGET = 1 << 30

_LOOP = int(StatusType.LOOP_COUNT_EXCEEDED_UPPER_BOUND)
_BAND = int(StatusType.EXCEEDED_BAND_WIDTH)
_OK = int(StatusType.SUCCESS)
#: consensus letter per code + 1 slot for N (codes < 0)
_CHARS = np.frombuffer((BASES + "N").encode(), dtype=np.uint8)


def window_bytes(bs: BatchSize) -> int:
    """Device bytes one window holds during a launch: B5's score plane,
    two copies of the graph state (B6 writes a new one), the path and the
    window's sequences."""
    N, L, S = bs.padded_nodes, bs.padded_seq, bs.max_sequences_per_poa
    P, A = bs.max_pred_per_node, bs.max_aligned_per_node
    state = 4 * N * (6 + 2 * P + A)
    return plane_bytes(N, L) + 2 * state + 8 * (N + L) + 8 * S * L


def launch_chunks(n_windows: int, bs: BatchSize) -> list[range]:
    """Windows 0..n_windows-1 cut into successive launches, each within
    POA_MEM_BUDGET (a launch holds at least one window)."""
    n = max(1, POA_MEM_BUDGET // window_bytes(bs))
    return [range(s, min(s + n, n_windows)) for s in range(0, n_windows, n)]


def run_windows(bs: BatchSize, sc: PoaScores, banded: bool, seqs, weights,
                lens, n_seqs):
    """Consensus of one launch of windows, all tensors on one device.

    seqs, weights: (W, S, L) int32; lens: (W, S) int32; n_seqs: (W,) int32.
    Returns (codes (W, MC), covs (W, MC), length (W,), status (W,))."""
    S = bs.max_sequences_per_poa
    bw = bs.band_width if banded else 0
    state = init_state(bs, seqs[:, 0], weights[:, 0], lens[:, 0])
    level = init_level(bs.padded_nodes, lens[:, 0])
    for s in range(1, S):
        alive = (s < n_seqs) & (state.status == _OK)
        with trace_range("poa.topsort"):
            new_level, order, rank, ok = topsort(
                level, state.npred, state.pred, state.node_count)
        with trace_range("poa.nwtb"):
            pn, pp, k0, band_ok = graph_nw_traceback(
                seqs[:, s], order, rank, state.npred, state.base,
                state.nsucc, state.pred, lens[:, s], state.node_count, alive,
                sc, bw)
        act = alive & band_ok
        with trace_range("poa.add"):
            new = add_alignment(state, pn, pp, seqs[:, s], weights[:, s], k0,
                                act, bs.max_nodes_per_window)
        status = torch.where(act & ~ok, _LOOP, new.status)
        status = torch.where(alive & ~band_ok, _BAND, status)
        state = new._replace(status=status.to(torch.int32))
        level = torch.where(alive[:, None], new_level, level)
    with trace_range("poa.topsort"):
        _, _, rank, _ = topsort(level, state.npred, state.pred,
                                state.node_count)
    with trace_range("poa.consensus"):
        codes, covs, length = consensus(
            state.npred, state.pred, state.predw, state.base, state.cov,
            rank, state.node_count, bs.max_consensus_size)
    return codes, covs, length, state.status


class Batch:
    """POA batch over padded windows, on one ``torch.device``."""

    _next_id = itertools.count()

    def __init__(self, batch_size: BatchSize | None = None,
                 scores: PoaScores | None = None,
                 output_mask: int = OutputType.CONSENSUS,
                 max_poas: int = 1024, banded_alignment: bool = False,
                 device="cuda"):
        self.output_mask = OutputType(output_mask)
        if self.output_mask & OutputType.MSA:
            raise NotImplementedError(
                "OutputType.MSA needs the MSA kernel (B9), which the port "
                "does not have yet (ROADMAP A.4)")
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
        seqs = np.full((W, S, L), -1, dtype=np.int32)
        weights = np.zeros((W, S, L), dtype=np.int32)
        lens = np.zeros((W, S), dtype=np.int32)
        n_seqs = np.zeros(W, dtype=np.int32)
        rows, cols, strs, given = [], [], [], []
        for wi, ((group, wt), hstat) in enumerate(
                zip(self._groups, self._host_status)):
            if hstat != StatusType.SUCCESS:
                continue  # an empty window; the host status wins at decode
            n_seqs[wi] = len(group)
            if wt is not None:
                given += [(len(strs) + si, w) for si, w in enumerate(wt)]
            rows += [wi] * len(group)
            cols += range(len(group))
            strs += group
        n = np.array([len(s) for s in strs], dtype=np.int64)
        lens[rows, cols] = n
        if n.sum():
            # every base of every sequence in one encode and one scatter:
            # base k of sequence q lands at flat (row_q * S + col_q) * L + k
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

    def generate_poa(self) -> None:
        """Pack the windows and enqueue their launches; returns without
        waiting for the device."""
        if not self._groups:
            self._out = (np.zeros((0, 0), np.int32),) * 2 + (
                np.zeros(0, np.int32),) * 2
            return
        with trace_range("poa.generate"):
            arrays = [torch.from_numpy(a).to(self.device)
                      for a in self._pack_arrays()]
            outs = [run_windows(self.batch_size, self.scores,
                                self.banded_alignment,
                                *(a[c.start:c.stop] for a in arrays))
                    for c in launch_chunks(len(self._groups),
                                           self.batch_size)]
            self._out_dev = tuple(torch.cat(parts) for parts in zip(*outs))

    def _ensure(self):
        if self._out is None:
            if self._out_dev is None:
                self.generate_poa()
            if self._out is None:
                self._out = tuple(t.cpu().numpy() for t in self._out_dev)
                self._out_dev = None

    def get_consensus(self):
        """Returns (consensus list[str], coverage list[list[int]],
        statuses list[StatusType])."""
        self._ensure()
        codes, covs, lengths, dstat = self._out
        # negative codes are ambiguous-base (N) nodes, kept in place
        chars = _CHARS[np.where(np.asarray(codes) >= 0,
                                np.clip(codes, 0, 3), 4)]
        out_s, out_c, out_st = [], [], []
        for wi in range(len(self._groups)):
            st = self._host_status[wi]
            if st == StatusType.SUCCESS:
                st = StatusType(int(dstat[wi]))
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

    def get_msa(self):
        """Returns (msa list[list[str]], statuses); every window reports
        OUTPUT_TYPE_UNAVAILABLE, since a batch here never computes the
        MSA."""
        n = len(self._groups)
        return [[] for _ in range(n)], [StatusType.OUTPUT_TYPE_UNAVAILABLE] * n

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
                 device="cuda") -> Batch:
    """Factory with the JAX package's arguments (its ``backend`` and
    ``mesh`` excepted); the band width comes from BatchSize.band_width."""
    if scores is None and any(v is not None for v in
                              (gap_score, mismatch_score, match_score)):
        d = PoaScores()
        scores = PoaScores(
            match_score=match_score if match_score is not None else d.match_score,
            mismatch_score=mismatch_score if mismatch_score is not None else d.mismatch_score,
            gap_score=gap_score if gap_score is not None else d.gap_score)
    return Batch(batch_size, scores, output_mask, max_poas, banded_alignment,
                 device)
