"""The counter metrics read the counters of the port's last closed
``stage_times()`` block, and nothing from a port that keeps none."""

import pytest

from cga_bench import spec
from claragenomicsanalysis_tpu_torch.utils import profiling
from conftest import ROOT

REC = {"bases": 2_000_000, "mbp": 2.0}


def read(name):
    return spec.reader(name, ROOT)(REC)


def test_counter_metrics_read_the_last_closed_block():
    with profiling.stage_times():
        profiling.count("launch.myers", 30)
        profiling.count("launch.nw_diag", 10)
        profiling.count("readback", 6)
        profiling.count("escalate.pairs", 8)
        profiling.count("escalate.retries", 2)
    for cell in ("overlap", "correct"):
        assert read(f"launches_per_mbp.{cell}") == 20.0
        assert read(f"readbacks_per_mbp.{cell}") == 3.0
    assert read("escalate_retry_share.correct") == 25.0


def test_no_pair_in_the_loop_reads_zero_retries():
    with profiling.stage_times():
        profiling.count("launch.myers")
    assert read("escalate_retry_share.correct") == 0.0
    assert read("readbacks_per_mbp.overlap") is None


@pytest.mark.parametrize("name", [
    "launches_per_mbp.overlap", "launches_per_mbp.correct",
    "readbacks_per_mbp.overlap", "readbacks_per_mbp.correct",
    "escalate_retry_share.correct"])
def test_a_port_without_counters_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "last_counters")
    assert read(name) is None
