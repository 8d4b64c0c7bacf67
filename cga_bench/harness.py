"""One run of one cell: set-up, the measured window, the traced records,
the comparison with the reference, and the result line.

Set-up makes the run's genome and a pool of jobs from the seed (each job
the reads of one circular segment, written as FASTA under ``TMPDIR`` by up
to ``POOL_WORKERS`` processes and parsed here in job order), builds or
loads the port's kernels and runs one warm-up job.  The
window then runs whole jobs back to back through the configuration's entry
point and stops at the first job end at or after ``seconds``; only
completed jobs count, and a job is never run twice.  ``--trace 1`` times
the same window with the port's spans, kernel events and
``torch.profiler`` on, and reports the per-layer metrics instead of the
end-to-end ones.
"""

import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time

from . import readsim, spec, trace

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "claragenomicsanalysis_tpu")
WINDOW = "cga_bench.window"
#: the most processes that write the pool, one a core the run had
POOL_WORKERS = 8


class RunError(RuntimeError):
    """A run that must print no result."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def check_imports(when: str) -> None:
    bad = forbidden_modules()
    if bad:
        raise RunError(f"{when}: modules that no run may load are loaded: "
                       f"{', '.join(bad[:20])}")


def device_info(torch, chips: int) -> dict:
    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: the benchmark "
                       "runs only on a CUDA device")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, torch finds "
                       f"{torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def make_pool(seed: int, cell: spec.Cell, workdir: str, parse,
              workers: int = 1, cores=None):
    """(warm-up job, jobs): each a (reads, parser) pair, its FASTA under
    ``workdir``, written by ``workers`` processes on ``cores``
    (``readsim.write_pool``) and read here in job order as they come.  The
    warm-up job is the mix's law on a segment of ``warmup_segment`` bases:
    every code path of a job, less of the work."""
    with contextlib.closing(readsim.write_pool(
            seed, cell.traffic, cell.config["genome"]["length"], workdir,
            workers, cores)) as paths:
        jobs = [(readsim.read_fasta(path), parse(path)) for path in paths]
    return jobs[0], jobs[1:]


def host_clocks() -> tuple[float, float]:
    """(CPU seconds of this process, seconds its thread waited for a core
    on the run queue; 0 where the kernel does not say)."""
    try:
        with open("/proc/thread-self/schedstat") as f:
            wait = int(f.read().split()[1]) / 1e9
    except OSError:
        wait = 0.0
    return time.process_time(), wait


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t_start: float, root=spec.ROOT, device: str = "cuda",
             fault=None, host_cores=None) -> dict:
    """One run; returns the result line's object.  ``host_cores``, where
    given, is the set of cores the pool's workers and, after the window,
    the reference get.
    ``device="cpu"`` and ``fault`` (a function of an entry's output and the
    job's reads that returns a damaged output) exist for the benchmark's
    own tests."""
    import torch

    # one process a card, host work on one thread
    torch.set_num_threads(1)
    cell = spec.cell(workload, root)
    if device == "cuda":
        dev_info = device_info(torch, cell.chips)
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1}
    from claragenomicsanalysis_tpu_torch.io.fasta import create_fasta_parser
    entry = spec.entry(cell.config["entry"])
    settings = cell.config["settings"]
    workdir = tempfile.mkdtemp(prefix="cga_bench_")
    try:
        t_imports = time.perf_counter()
        workers = min(POOL_WORKERS, len(host_cores)) if host_cores else 1
        (_, warm_parser), pool = make_pool(
            seed, cell, workdir, create_fasta_parser, workers, host_cores)
        t_pool = time.perf_counter()
        entry.run(warm_parser, settings, device)
        if device == "cuda":
            torch.cuda.synchronize()
        t_warm = time.perf_counter()
        print(f"set-up: imports and device {t_imports - t_start:.3f} s, "
              f"pool of {len(pool)} jobs {t_pool - t_imports:.3f} s "
              f"({workers} processes), "
              f"warm-up job {t_warm - t_pool:.3f} s", file=sys.stderr)
        check_imports("after set-up")
        # the pool stays alive through the window: out of the collector's
        # way, so that collections scan only what the jobs make
        gc.collect()
        gc.freeze()
        return _measure(torch, cell, entry, settings, pool, seed, seconds,
                        traced, t_start, root, device, dev_info, workdir,
                        fault, host_cores)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _measure(torch, cell, entry, settings, pool, seed, seconds, traced,
             t_start, root, device, dev_info, workdir, fault,
             host_cores):
    from claragenomicsanalysis_tpu_torch.utils import profiling
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx = []
    if traced:
        st_cm, kt_cm = profiling.stage_times(), profiling.kernel_times()
        st, kt = st_cm.__enter__(), kt_cm.__enter__()
        log = trace.record_launches(kt)
        ctx = [kt_cm, st_cm]
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    done, outputs, spans, host = [], [], [], []
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    with torch.profiler.record_function(WINDOW):
        for reads, parser in pool:
            a, (cpu_a, wait_a) = time.perf_counter(), host_clocks()
            out = entry.run(parser, settings, device)
            if cuda:
                torch.cuda.synchronize()
            b, (cpu_b, wait_b) = time.perf_counter(), host_clocks()
            host.append((cpu_b - cpu_a, wait_b - wait_a))
            done.append(reads)
            outputs.append(fault(out, reads) if fault else out)
            spans.append((a, b))
            if b - w0 >= seconds:
                break
        else:
            raise RunError(f"the pool of {len(pool)} jobs ran out before "
                           f"{seconds} s: raise the mix's pool_jobs")
    if traced:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bases = sum(len(s) for reads in done for _, s in reads)
    elapsed = spans[-1][1] - spans[0][0]
    rec = {"bases": bases, "mbp": bases / 1e6, "elapsed_s": elapsed,
           "setup_s": setup_s, "jobs": len(done), "peak_bytes": peak}
    result = {"correct": None,
              "attempted": sum(o["attempted"] for o in outputs),
              "failed": sum(o["failed"] for o in outputs)}
    if traced:
        rec.update(host_ms=st.host_ms(), kernel_ms=kt.ms() if cuda else {},
                   myers=trace.myers_roofline(kt, log) if cuda else None)
        for cm in ctx:
            cm.__exit__(None, None, None)
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        prof_rec = trace.read_profile(path, WINDOW)
        os.remove(path)
        rec.update(prof_rec)
        dev_info.update(busy_s=prof_rec["busy_s"],
                        window_s=prof_rec["window_s"])
        result["breakdown"] = prof_rec["breakdown"]
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        v = spec.reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info["memory_peak_bytes"] = int(peak)
    result["metrics"] = metrics
    result["device"] = dev_info
    # the reference runs once the window is closed and its peak read
    if cuda:
        torch.cuda.empty_cache()
    if host_cores:
        os.sched_setaffinity(0, host_cores)
    t_ref = time.perf_counter()
    numbers = entry.judge(done, outputs, settings, cell.config["check"], seed,
                          device)
    print(f"window: {len(done)} jobs, {elapsed:.3f} s ("
          f"{', '.join(f'{b - a:.3f}' for a, b in spans)}); reference: "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    print("window host: CPU s / run-queue wait s a job ("
          + ", ".join(f"{c:.3f}/{w:.3f}" for c, w in host) + ")",
          file=sys.stderr)
    checks = {k: {"value": v, "limit": lim} for k, (v, lim)
              in numbers.items() if lim is not None}
    result["compared"] = {k: v for k, (v, lim) in numbers.items()
                          if lim is None}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None, host_cores=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        check_imports("at start")
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start, host_cores=host_cores)
        check_imports("at exit")
    except RunError as e:
        print(f"cga_bench: {e}", file=sys.stderr)
        return 2
    for k, v in res["compared"].items():
        print(f"compared {k} {v}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    order = ["correct", "attempted", "failed", "metrics", "device"]
    order += [k for k in ("breakdown", "compared") if k in res] + ["checks"]
    print(json.dumps({k: res[k] for k in order}), flush=True)
    return 0
