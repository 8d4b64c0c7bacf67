"""The traced run's records: the port's spans (``utils.profiling``'s
``stage_times``: host ms of every ``trace_range``), its kernel events
(``kernel_times``: CUDA events around each hand-written kernel launch),
the work of each B4 launch, and the device timeline of ``torch.profiler``,
from which the busy time, the idle gaps and the device operations come."""

import json

from . import peaks

#: chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _AlwaysLower(dict):
    """A largest-work table under which every launch is the largest, so
    that the launch's inputs reach :class:`LaunchLog`."""

    def get(self, key, default=None):
        return -1


class LaunchLog(dict):
    """Stands in for ``KernelTimes.largest``: keeps, for each B4 launch in
    launch order, its shape and the query words it needs (summed on the
    device, read when the run ends), and holds no inputs alive."""

    def __init__(self):
        super().__init__()
        self.myers = []

    def __setitem__(self, name, inputs):
        if name == "myers":
            q, qlen, t, _ = inputs
            words = ((qlen.long() + 31) // 32).sum()
            self.myers.append((q.shape[0], q.shape[1], t.shape[1], words))


def record_launches(kt) -> LaunchLog:
    """Make the ``kernel_times()`` block ``kt`` log every B4 launch."""
    kt._largest_work = _AlwaysLower()
    kt.largest = LaunchLog()
    return kt.largest


def myers_roofline(kt, log: LaunchLog):
    """(bound s, event s) summed over the B4 launches of the block."""
    events = kt.events.get("myers", [])
    if not events:
        return None
    bound = sum(peaks.bound_s(*peaks.myers_work(B, Lq, Lt, int(w)))
                for B, Lq, Lt, w in log.myers)
    spent = sum(s.elapsed_time(e) for s, e in events) / 1e3
    return bound, spent


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameters, and without
    its template arguments where they are long: ``myers_kernel<16>``,
    ``at::native::elementwise_kernel<...>``; other operations' names (a
    copy, a memset) as they are."""
    if "::" not in name and "<" not in name:
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    if len(name) > 60 and "<" in name:
        name = name[:name.index("<")] + "<...>"
    return name[:120]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_profile(path: str, window: str):
    """From a chrome trace of ``torch.profiler``: the window's seconds, the
    seconds in which a device operation ran inside it, the device
    operations that took the most time, and the idle time inside the
    window by the innermost host range open at each gap's middle."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"no {window!r} range in the profiler's trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in dev])
    busy_us = sum(b - a for a, b in busy)
    by_op: dict[str, float] = {}
    for e in dev:
        op = short_name(e["name"])
        by_op[op] = by_op.get(op, 0.0) + e["dur"] / 1e6
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    # one sweep over the host ranges' ends and the gaps' middles: the
    # innermost open range (the latest opened) at each middle
    marks = [(e["ts"], 1, e["name"]) for e in spans
             if e.get("cat") == "user_annotation" and e["name"] != window]
    marks += [(e["ts"] + e["dur"], 0, e["name"]) for e in spans
              if e.get("cat") == "user_annotation" and e["name"] != window]
    marks += [((a + b) / 2, 2, b - a) for a, b in gaps]
    stack: list[str] = []
    idle: dict[str, float] = {}
    for _, kind, what in sorted(marks, key=lambda m: (m[0], m[1])):
        if kind == 1:
            stack.append(what)
        elif kind == 0:
            if what in stack:
                del stack[len(stack) - 1 - stack[::-1].index(what)]
        else:
            name = stack[-1] if stack else "(no range open)"
            idle[name] = idle.get(name, 0.0) + what / 1e6
    top = lambda d: [[k, v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "n_device_ops": len(dev),
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(idle)}}
