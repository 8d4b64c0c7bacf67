"""Profiling (counterpart of claragenomicsanalysis_tpu/utils/profiling.py):
NVTX ranges that name the stages of a run in a CUDA profiler's timeline, and
CUDA-event times of the kernel launches made inside a ``kernel_times()``
block.

    with kernel_times() as kt:
        aligner.align_all()
    kt.ms()      # {"nw_diag": total ms, "tb_decode": total ms}
    kt.largest["nw_diag"]   # the inputs of its largest launch, to replay
                            # (the latest of equally large ones)

Outside such a block :func:`kernel_span` records nothing; inside it, each
launch costs two event records on the launching stream, and the block keeps
the inputs of each kernel's largest launch alive until it ends.

A ``stage_times()`` block does the same for the stages named by
:func:`trace_range` (the mapper's ``mapper.*`` ranges): each range entered
in it records a CUDA event at its start and end on the current stream, so
``st.ms()`` gives each stage's device-stream time, and the host clock
around it, so ``st.host_ms()`` gives its wall time on the host; on the
CPU it keeps the host times alone (``st.timings()``, the CLI's
``--timings``).
"""

import contextlib
import time

import torch

_collector = None       # the KernelTimes of the open kernel_times() block
_stages = None          # the StageTimes of the open stage_times() block


@contextlib.contextmanager
def trace_range(name: str):
    """Push an NVTX range named ``name`` for the body when CUDA is in use,
    and label it in a torch.profiler trace; inside a ``stage_times()``
    block, add its host seconds and, with CUDA, its CUDA events."""
    cuda = torch.cuda.is_available()
    stages = _stages
    if cuda:
        torch.cuda.nvtx.range_push(name)
    if stages is not None:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if stages is not None:
            stages.host_s[name] = (stages.host_s.get(name, 0.0)
                                   + time.perf_counter() - t0)
            stages.calls[name] = stages.calls.get(name, 0) + 1
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                stages.events.setdefault(name, []).append((start, end))
        if cuda:
            torch.cuda.nvtx.range_pop()


class StageTimes:
    """Host seconds and entries of every trace_range entered, and with
    CUDA its start and end events, by name."""

    def __init__(self):
        self.events: dict[str, list] = {}
        self.host_s: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def host_ms(self) -> dict[str, float]:
        """Total host milliseconds inside each range, by name."""
        return {name: s * 1e3 for name, s in self.host_s.items()}

    def ms(self) -> dict[str, float]:
        """Total milliseconds between each range's events, by name;
        synchronizes the card."""
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}

    def count(self) -> dict[str, int]:
        return dict(self.calls)

    def timings(self) -> dict[str, dict[str, float]]:
        """Host seconds and entries by range, in the JAX package's
        ``stage_timings()`` layout (the CLI's ``--timings``).  On the card
        a range's host time is not its device time: the kernels it
        launches run on after it returns."""
        return {k: {"total_s": self.host_s[k], "count": self.calls[k]}
                for k in sorted(self.host_s)}


@contextlib.contextmanager
def stage_times():
    """Time every trace_range entered in the body (host seconds, and CUDA
    events where CUDA is in use); yields a StageTimes."""
    global _stages
    if _stages is not None:
        raise RuntimeError("stage_times() blocks do not nest")
    _stages = StageTimes()
    try:
        yield _stages
    finally:
        _stages = None


class KernelTimes:
    """Start and end CUDA events of every timed launch, by kernel name, and
    the inputs of each kernel's largest launch (by the work its wrapper
    counts; of equal ones the latest, which in a POA run is the one on the
    grown graphs)."""

    def __init__(self):
        self.events: dict[str, list] = {}
        self.largest: dict[str, tuple] = {}
        self._largest_work: dict[str, int] = {}

    def ms(self) -> dict[str, float]:
        """Total device milliseconds per kernel; synchronizes the card."""
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}

    def count(self) -> dict[str, int]:
        return {name: len(pairs) for name, pairs in self.events.items()}


@contextlib.contextmanager
def kernel_times():
    """Time every kernel launch made in the body; yields a KernelTimes."""
    global _collector
    if _collector is not None:
        raise RuntimeError("kernel_times() blocks do not nest")
    _collector = KernelTimes()
    try:
        yield _collector
    finally:
        _collector = None


@contextlib.contextmanager
def kernel_span(name: str, inputs: tuple = (), work: int = 0):
    """Wrap one kernel launch on ``inputs`` that does ``work`` (cells or
    steps, as the wrapper counts them): recorded by CUDA events on the
    current stream when a kernel_times() block is open, free otherwise."""
    if _collector is None:
        yield
        return
    if work >= _collector._largest_work.get(name, -1):
        _collector._largest_work[name] = work
        _collector.largest[name] = inputs
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    _collector.events.setdefault(name, []).append((start, end))
