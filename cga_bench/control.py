"""The readings that the limits of ``correct`` are set from, at a cell's
own size: the program's (the lower reading) and the control's (the upper
one), each judged by the same comparison as a run's answers.

    python3 cga_bench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--jobs <k>] [--side control|program]

For each seed it makes the first ``k`` jobs of the run's pool (a run
completes about that many) and prints one JSON line of the numbers
compared, whether they pass, and the seconds each part took.

- ``--side control``: the reference in the program's place with one
  guarantee of the configuration broken: for ``cli pipeline`` optimal
  but not canonical alignments (an insertion before a deletion, the
  largest optimal Hirschberg split), for ``cli correct`` the consensus
  tie rule reversed.  Every seed has to come out not correct.
- ``--side program``: the configuration's entry on the card, after one
  warm-up job, as a run's window drives it.

The benchmark's runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cga_bench import readsim, spec  # noqa: E402
from cga_bench.reference import judge as ref  # noqa: E402


def make_jobs(cell, seed: int, n_jobs: int) -> list:
    """The first ``n_jobs`` jobs of the run's pool for ``seed``, and its
    warm-up job first."""
    tr = cell.traffic
    g = cell.config["genome"]["length"]
    genome = readsim.genome(seed, g)
    starts = readsim.segment_starts(seed, g, tr["segment"],
                                    int(tr["pool_jobs"]) + 1)
    warm = readsim.make_job(seed, -1, dict(tr, segment=tr["warmup_segment"]),
                            genome, int(starts[0]))
    return [warm] + [readsim.make_job(seed, j, tr, genome, int(starts[j + 1]))
                     for j in range(n_jobs)]


def control_outputs(cell, jobs, seed, device) -> list:
    """The control's answers in the entry's form; what the comparison
    does not read is left as the uncorrected reads or empty CIGARs."""
    settings, check = cell.config["settings"], cell.config["check"]
    maps = ref.job_maps(jobs, settings)
    if cell.config["entry"] == "pipeline":
        sample = ref.overlap_sample(maps, check, seed, "myers", device)
        cigars = ref.cigars_of(maps, sample, device, control=True)
        outs = [{"rows": kept, "cigars": [""] * len(kept)}
                for _, _, kept in maps]
        for (j, i), c in zip(sample, cigars):
            outs[j]["cigars"][i] = c
        return outs
    picks = ref.read_sample(jobs, settings, check, seed)
    fixed = ref.corrected_reads(maps, picks, settings, device, control=True)
    outs = [{"seqs": list(seqs), "rows": rows} for seqs, rows, _ in maps]
    for (j, r), s in fixed.items():
        outs[j]["seqs"][r] = s
    return outs


def program_outputs(cell, jobs, device) -> tuple[list, float]:
    """The entry's answers for the jobs after the first (the warm-up),
    and the seconds the jobs took."""
    import torch
    from claragenomicsanalysis_tpu_torch.io.fasta import create_fasta_parser
    entry = spec.entry(cell.config["entry"])
    workdir = tempfile.mkdtemp(prefix="cga_bench_")
    try:
        parsers = []
        for k, reads in enumerate(jobs):
            path = os.path.join(workdir, f"job{k}.fasta")
            readsim.write_fasta(reads, path)
            parsers.append(create_fasta_parser(path))
        entry.run(parsers[0], cell.config["settings"], device)
        t0 = time.perf_counter()
        outs = [entry.run(p, cell.config["settings"], device)
                for p in parsers[1:]]
        if device == "cuda":
            torch.cuda.synchronize()
        return outs, time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def readings(workload: str, seed: int, n_jobs: int, device, side: str,
             root=spec.ROOT) -> dict:
    """{name: (value, limit)} of one seed, and "seconds" of each part."""
    cell = spec.cell(workload, root)
    t0 = time.perf_counter()
    jobs = make_jobs(cell, seed, n_jobs)
    if side == "program":
        outs, run_s = program_outputs(cell, jobs, device)
    else:
        outs, run_s = control_outputs(cell, jobs[1:], seed, device), None
    t1 = time.perf_counter()
    nums = spec.entry(cell.config["entry"]).judge(
        jobs[1:], outs, cell.config["settings"], cell.config["check"], seed,
        device)
    nums["seconds"] = {"jobs": run_s, "side": t1 - t0,
                       "judge": time.perf_counter() - t1}
    return nums


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--side", choices=("control", "program"),
                    default="control")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        nums = readings(args.workload, seed, args.jobs, device, args.side)
        secs = nums.pop("seconds")
        checks = {k: {"value": v, "limit": lim}
                  for k, (v, lim) in nums.items() if lim is not None}
        print(json.dumps({
            "workload": args.workload, "side": args.side, "seed": seed,
            "device": device,
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks,
            "compared": {k: v for k, (v, lim) in nums.items() if lim is None},
            "seconds": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
