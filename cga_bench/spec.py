"""What a cell is made of, found by name from ``BENCHMARK.json``: its
configuration file (named by the configuration's ``file``), its traffic
mix (``traffic/<mix>.json`` beside this file) and the reader of each
per-layer metric (``metrics/<metric>.py``).  A later change adds a
configuration, a mix, a cell or a metric by adding files and entries; no
file here names one."""

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, its files read."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(Path(root) / conf["file"]) as f:
        config = json.load(f)
    traffic_file = Path(root) / HERE.name / "traffic" / f"{w['traffic']}.json"
    with open(traffic_file) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read(records)`` function of ``metrics/<metric>.py``."""
    path = Path(root) / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"cga_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry(name: str):
    """The module ``entries/<name>.py`` that drives one of the port's
    entry points."""
    return importlib.import_module(f"{__package__}.entries.{name}")


def bad_names(bench: dict) -> list[str]:
    """Every name, unit and key of ``bench`` outside the allowed
    characters."""
    bad = []
    names = ([c["name"] for c in bench["configs"]]
             + [k for c in bench["configs"] for k in c["reduced"]]
             + [w[k] for w in bench["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    bad += [n for n in names if not NAME.fullmatch(n)]
    bad += [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]
            if not UNIT.fullmatch(m["unit"])]
    return bad
