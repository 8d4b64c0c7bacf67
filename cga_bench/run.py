"""Run one cell of the port's benchmark once and print its result line:

    python3 cga_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``; the numbers compared with the reference last, under
``checks``).  A run without enough CUDA devices, or one that finds JAX or
the JAX package loaded, prints no result and exits with 2.

The jobs are host-bound Python around small launches, so the run keeps its
host work on one thread a library and on the one core it starts on: the
window then reads one core's speed throughout, not the scheduler's moves
between cores.  Every thread the run starts inherits that core; the
reference, after the window, gets the process's whole set back.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def pin_to_current_core() -> set | None:
    """Pin the calling thread, before it starts any other, to the core it
    runs on; returns the set of cores it had (None where the platform has
    no affinity calls)."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    cores = os.sched_getaffinity(0)
    with open("/proc/thread-self/stat") as f:
        # field 39, "processor": the core it last ran on
        cpu = int(f.read().rsplit(")", 1)[1].split()[36])
    os.sched_setaffinity(0, {cpu} if cpu in cores else {min(cores)})
    return cores


HOST_CORES = pin_to_current_core()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cga_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START, host_cores=HOST_CORES))
