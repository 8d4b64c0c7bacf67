"""BENCHMARK.json against its allowed characters, the harness finding a
configuration, a mix, a cell and a metric by name from files alone, and
the whole-name check for JAX and the JAX package."""

import json
import os
import sys

import pytest

from cga_bench import harness, spec
from conftest import ROOT, copy_bench

BENCH = spec.load_benchmark(ROOT)
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_use_the_allowed_characters():
    assert spec.bad_names(BENCH) == []
    for bad in ("a b", "a,b", "a/b", ".a", "µs", "x" * 65):
        assert not spec.NAME.fullmatch(bad)
    assert not spec.UNIT.fullmatch("tokens per second")
    assert spec.UNIT.fullmatch("bases/s") and spec.UNIT.fullmatch("%")


def test_every_configuration_mix_and_metric_has_its_file():
    for w in BENCH["workloads"]:
        c = spec.cell(w["name"], ROOT)
        assert c.config["name"] == w["config"]
        assert c.traffic["name"] == w["traffic"]
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
    for m in ALL_METRICS:
        assert callable(spec.reader(m["name"], ROOT))


def test_per_layer_metrics_sit_only_in_cells_of_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        cells = moved.get("workloads", [w["name"] for w in
                                        BENCH["workloads"]])
        assert set(m["workloads"]) <= set(cells), m["name"]


def test_a_cell_mix_and_metric_added_from_files_alone(tmp_path):
    root = copy_bench(tmp_path)
    bench = spec.load_benchmark(root)
    # a new mix and a new cell: files and entries only
    mix = dict(json.load(open(os.path.join(
        root, "cga_bench", "traffic", "long10k.json"))), name="long20k",
        lengths={"kind": "normal", "mean": 20000, "sd": 2000})
    with open(os.path.join(root, "cga_bench", "traffic", "long20k.json"),
              "w") as f:
        json.dump(mix, f)
    bench["workloads"].append({"name": "overlap_ont.long20k",
                               "config": "overlap_ont",
                               "traffic": "long20k", "chips": 1,
                               "why": "t"})
    # a new configuration: its file and its entry
    conf = json.load(open(os.path.join(root, "cga_bench", "configs",
                                       "overlap_ont.json")))
    conf["name"] = "overlap_k19"
    conf["settings"]["mapper"]["kmer_size"] = 19
    with open(os.path.join(root, "cga_bench", "configs",
                           "overlap_k19.json"), "w") as f:
        json.dump(conf, f)
    bench["configs"].append({"name": "overlap_k19", "source": "s",
                             "file": "cga_bench/configs/overlap_k19.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "overlap_k19.short500",
                               "config": "overlap_k19",
                               "traffic": "short500", "chips": 1,
                               "why": "t"})
    # a new per-layer metric: its reader and its entry
    with open(os.path.join(root, "cga_bench", "metrics",
                           "jobs_in_window.overlap.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec['jobs'])\n")
    bench["per_layer"].append({"name": "jobs_in_window.overlap",
                               "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "pipeline",
                               "moves": "overlap_bases_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "overlap_bases_per_s":
            m["workloads"] += ["overlap_ont.long20k", "overlap_k19.short500"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    assert spec.bad_names(bench) == []
    c = spec.cell("overlap_ont.long20k", root)
    assert c.traffic["lengths"]["mean"] == 20000
    assert "jobs_in_window.overlap" in [m["name"] for m in c.per_layer]
    assert "overlap_bases_per_s" in [m["name"] for m in c.end_to_end]
    k = spec.cell("overlap_k19.short500", root)
    assert k.config["settings"]["mapper"]["kmer_size"] == 19
    assert spec.reader("jobs_in_window.overlap", root)({"jobs": 3}) == 3.0
    assert "jobs_in_window.overlap" not in [
        m["name"] for m in spec.cell("correct_ont.long10k", root).per_layer]


def test_import_check_compares_whole_top_level_names(monkeypatch):
    import claragenomicsanalysis_tpu_torch  # noqa: F401  (the port is fine)
    assert harness.forbidden_modules() == []
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen",
                 "claragenomicsanalysis_tpu", "claragenomicsanalysis_tpu.cli"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in harness.forbidden_modules()
        with pytest.raises(harness.RunError):
            harness.check_imports("test")
        monkeypatch.delitem(sys.modules, name)
    for name in ("jaxtyping", "claragenomicsanalysis_tpu_torch.cli",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
        assert harness.forbidden_modules() == []
        monkeypatch.delitem(sys.modules, name)


def test_a_run_without_a_card_prints_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "correct_ont.long10k", "--seed", "1",
                       "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "cuda" in err.lower()
