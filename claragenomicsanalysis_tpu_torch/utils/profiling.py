"""Profiling (counterpart of claragenomicsanalysis_tpu/utils/profiling.py):
named host ranges, counters, and CUDA-event times of the kernel launches
made inside a ``kernel_times()`` block.

    with kernel_times() as kt:
        aligner.align_all()
    kt.ms()      # {"nw_diag": total ms, "tb_decode": total ms}
    kt.largest["nw_diag"]   # the inputs of its largest launch, to replay
                            # (the latest of equally large ones)

Outside such a block :func:`kernel_span` times nothing; inside it, each
launch costs two event records on the launching stream, and the block keeps
the inputs of each kernel's largest launch alive until it ends.

A ``stage_times()`` block does the same for the stages named by
:func:`trace_range`: each range entered in it records a CUDA event at its
start and end on the current stream, so ``st.ms()`` gives each stage's
device-stream time, and the host clock around it, so ``st.host_ms()`` gives
its wall time on the host; on the CPU it keeps the host times alone
(``st.timings()``, the CLI's ``--timings``).  The block also holds the
counters that :func:`count` adds to (``st.counters``): ``launch.<kernel>``
for every kernel launch (:func:`kernel_span`), ``readback`` for every
:func:`to_host`, and what the code counts by name (``hirschberg.pairs``,
``escalate.retries``, ...); once the block has closed,
:func:`last_counters` still gives them.

A range is an NVTX range where a card is present, and a
``record_function`` label while a ``torch.profiler`` collects, so that it
shows in the profiler's trace on the clock of the CUDA activity.  With no
block open and no profiler collecting, a range and a count cost one check.
"""

import contextlib
import time

import torch

_collector = None       # the KernelTimes of the open kernel_times() block
_stages = None          # the StageTimes of the open stage_times() block
_last = None            # the StageTimes of the last closed one
_cuda = None            # whether a card is present, decided at first use
_profiling = torch.autograd._profiler_enabled


def _card() -> bool:
    global _cuda
    if _cuda is None:
        _cuda = torch.cuda.is_available()
    return _cuda


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open ``stage_times()``
    block; nothing without one."""
    stages = _stages
    if stages is None:
        return
    stages.counters[name] = stages.counters.get(name, 0) + n


class trace_range:
    """``with trace_range(name):`` names the body: an NVTX range where a
    card is present, a ``record_function`` label while a torch.profiler
    collects, and inside a ``stage_times()`` block its host seconds and,
    with a card, its CUDA events."""

    __slots__ = ("name", "stages", "label", "t0", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        cuda = _cuda if _cuda is not None else _card()
        if cuda:
            torch.cuda.nvtx.range_push(self.name)
        self.stages = stages = _stages
        self.label = None
        if stages is None and not _profiling():
            return                      # nothing records: one check
        if _profiling():
            self.label = torch.profiler.record_function(self.name)
            self.label.__enter__()
        if stages is not None:
            if cuda:
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        stages, name = self.stages, self.name
        if stages is not None:
            stages.host_s[name] = (stages.host_s.get(name, 0.0)
                                   + time.perf_counter() - self.t0)
            stages.calls[name] = stages.calls.get(name, 0) + 1
            if _cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                stages.events.setdefault(name, []).append((self.start, end))
        if self.label is not None:
            self.label.__exit__(*exc)
        if _cuda:
            torch.cuda.nvtx.range_pop()
        return False


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: a read-back, in the range ``host.readback`` and counted
    in ``readback``, so that the time the host waits on the card has a
    name."""
    with trace_range("host.readback"):
        count("readback")
        return t.cpu()


class StageTimes:
    """Host seconds and entries of every trace_range entered, with CUDA
    its start and end events, by name; and the counters of :func:`count`."""

    def __init__(self):
        self.events: dict[str, list] = {}
        self.host_s: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.counters: dict[str, int] = {}

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

    def launches(self) -> dict[str, int]:
        """Launches of each kernel, by kernel name (the ``launch.*``
        counters)."""
        return {k.removeprefix("launch."): v
                for k, v in self.counters.items() if k.startswith("launch.")}

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
    events where CUDA is in use) and keep its counters; yields a
    StageTimes."""
    global _stages, _last
    if _stages is not None:
        raise RuntimeError("stage_times() blocks do not nest")
    _stages = StageTimes()
    try:
        yield _stages
    finally:
        _last, _stages = _stages, None


def last_counters() -> dict[str, int] | None:
    """A copy of the counters of the last ``stage_times()`` block that
    closed; None before any has."""
    return None if _last is None else dict(_last.counters)


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
    steps, as the wrapper counts them): counted in ``launch.<name>``
    (:func:`count`), and recorded by CUDA events on the current stream
    when a kernel_times() block is open."""
    if _stages is not None:
        count(f"launch.{name}")
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
