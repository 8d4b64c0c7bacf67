"""The benchmark's own tests (``python -m pytest cga_bench/tests``).  They
import neither JAX nor the JAX package.  Tests that need a CUDA card carry
the ``cuda`` marker and skip without one; the ``cuda_device`` fixture
decides that, never an import."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a job small enough for the port's plain CPU versions
TINY = {"name": "tiny", "lengths": {"kind": "normal", "mean": 1500,
                                    "sd": 150},
        "depth": 8, "segment": 4000, "error_rate": 0.05, "ins": 0.25,
        "del": 0.25, "reverse": 0.5, "pool_jobs": 3, "warmup_segment": 2000}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def copy_bench(dest) -> str:
    """A copy of the benchmark (``BENCHMARK.json`` and ``cga_bench/``)
    under ``dest``, with the tiny mix and a tiny cell of each
    configuration added as files and entries."""
    root = str(dest)
    shutil.copytree(os.path.join(ROOT, "cga_bench"),
                    os.path.join(root, "cga_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "cga_bench", "traffic", "tiny.json"),
              "w") as f:
        json.dump(TINY, f)
    for c in ("correct_ont", "overlap_ont"):
        bench["workloads"].append({"name": f"{c}.tiny", "config": c,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w["name"] for w in bench["workloads"]
                               if w["name"].endswith(".tiny")
                               and w["config"].startswith(
                                   m["workloads"][0].split("_")[0])]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
