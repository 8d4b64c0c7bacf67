"""The port's one tracing system (claragenomicsanalysis_tpu_torch/utils/
profiling.py) on the CPU: counters, the cost-free path of a range when
nothing records, the ranges' labels in a torch.profiler trace, read-backs,
and the leaf ranges and counters that a small ``run_pipeline`` and
``correct_reads`` enter, whose outputs do not change with a block open.
No test here reads a time."""

import json

import pytest
import torch

from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                         MapperConfig,
                                                         PipelineConfig)
from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                      FastaSequence)
from claragenomicsanalysis_tpu_torch.models import correct, pipeline
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)
from claragenomicsanalysis_tpu_torch.utils import profiling

MAPPER = MapperConfig(kmer_size=11, window_size=5, min_overlap_len=50,
                      min_overlap_fraction=0.2, min_bases_per_residue=500)
#: ranges and counters of both compositions' paths on these reads: three
#: long reads, whose overlaps pad past 2,048 and go to Hirschberg, and five
#: short ones, whose overlaps stay banded
COMMON = {"overlaps.filter", "overlaps.spans", "overlaps.buckets",
          "aligner.add", "aligner.route", "aligner.results",
          "host.readback", "hirschberg.pack", "mapper.merge",
          "mapper.overlaps"}
#: the list route's ranges, which the pipeline (its paths kept on the
#: device) no longer enters
LIST_ROUTE = {"tb.unpack", "hirschberg.join"}
PIPELINE_RANGES = COMMON | {"pipeline.cigar", "pipeline.paf",
                            "paths.segments"}
CORRECT_RANGES = COMMON | LIST_ROUTE | {"windows.columns", "windows.supports",
                           "poa.groups", "poa.pack", "poa.decode",
                           "correct.join", "correct.part"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these small shapes run on one thread: pytest-
    xdist runs several test processes at once, and torch's default pool of
    a thread a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parser():
    genome = PoissonGenomeSimulator(seed=5).build_reference(2800)
    sim = NoisyReadSimulator(seed=5, error_rate=0.04)
    reads = (sim.generate_reads(genome, 3, 2500, "long")
             + sim.generate_reads(genome, 5, 400, "short"))
    return FastaParser("<mem>", records=[FastaSequence(r.name, r.seq)
                                         for r in reads])


def _traced(fn):
    with profiling.stage_times() as st:
        out = fn()
    return out, st


@pytest.fixture(scope="module")
def pipeline_runs(parser):
    def run():
        return pipeline.run_pipeline(parser, PipelineConfig(mapper=MAPPER),
                                     device="cpu")
    return run(), *_traced(run)


@pytest.fixture(scope="module")
def correct_runs(parser):
    def run():
        return correct.correct_reads(
            parser, CorrectConfig(mapper=MAPPER, max_support=7),
            device="cpu")
    return run(), *_traced(run)


def test_count_is_a_no_op_outside_a_block_and_adds_inside():
    profiling.count("x", 5)                 # nothing open: nothing kept
    with profiling.stage_times() as st:
        profiling.count("x")
        profiling.count("x", 4)
        profiling.count("y", 0)
    assert st.counters == {"x": 5, "y": 0}
    with profiling.stage_times() as again:
        pass
    assert again.counters == {}


def test_last_counters_outlive_their_block():
    with profiling.stage_times():
        profiling.count("escalate.pairs", 3)
        profiling.count("readback")
    profiling.count("readback")             # closed: nothing kept
    got = profiling.last_counters()
    assert got == {"escalate.pairs": 3, "readback": 1}
    got["readback"] = 7                     # a copy
    assert profiling.last_counters()["readback"] == 1
    with pytest.raises(RuntimeError, match="nest"):
        with profiling.stage_times():
            with profiling.stage_times():
                pass
    assert profiling.last_counters() == {}  # the outer block, not a refusal


def test_blocks_refuse_to_nest():
    with profiling.stage_times():
        with pytest.raises(RuntimeError, match="nest"):
            with profiling.stage_times():
                pass
    assert profiling._stages is None


def test_range_enters_no_record_function_with_nothing_tracing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.trace_range("quiet"):
        profiling.count("quiet")
    assert profiling.to_host(torch.arange(3)).tolist() == [0, 1, 2]
    # a stage_times() block times the range, still with no label
    with profiling.stage_times() as st:
        with profiling.trace_range("timed"):
            pass
    assert st.calls == {"timed": 1} and st.host_s["timed"] >= 0


def test_range_keeps_its_time_when_the_body_raises():
    with profiling.stage_times() as st:
        with pytest.raises(ValueError):
            with profiling.trace_range("failing"):
                raise ValueError("body")
    assert st.calls == {"failing": 1}


def test_ranges_label_a_cpu_profiler_trace(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace_range("pipeline.cigar"):
            with profiling.trace_range("tb.unpack"):
                profiling.to_host(torch.ones(4))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    labels = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"pipeline.cigar", "tb.unpack", "host.readback"} <= labels


def test_to_host_counts_readback():
    t = torch.arange(6).reshape(2, 3)
    with profiling.stage_times() as st:
        a = profiling.to_host(t)
        b = profiling.to_host(t[1])
    assert torch.equal(a, t) and b.tolist() == [3, 4, 5]
    assert st.counters == {"readback": 2}
    assert st.calls == {"host.readback": 2}


def test_kernel_span_counts_launches_outside_kernel_times():
    with profiling.kernel_span("nothing_open"):
        pass
    with profiling.stage_times() as st:
        for _ in range(3):
            with profiling.kernel_span("nw_diag", (), 7):
                pass
    assert st.counters == {"launch.nw_diag": 3}
    assert st.launches() == {"nw_diag": 3}
    assert profiling._collector is None


def test_pipeline_enters_its_leaf_ranges(pipeline_runs):
    _, _, st = pipeline_runs
    assert PIPELINE_RANGES <= set(st.calls)
    assert not LIST_ROUTE & set(st.calls)
    assert st.launches() == {}              # plain versions on the CPU
    assert st.counters["hirschberg.pairs"] > 0
    assert st.counters["readback"] == st.calls["host.readback"] > 0


def test_pipeline_output_unchanged_by_an_open_block(pipeline_runs):
    plain, traced, _ = pipeline_runs
    assert traced == plain
    assert plain.n_aligned == len(plain.overlaps) > 0


def test_correct_enters_its_leaf_ranges(correct_runs):
    _, _, st = correct_runs
    assert CORRECT_RANGES <= set(st.calls)
    assert st.launches() == {}
    c = st.counters
    assert c["escalate.pairs"] > 0
    assert c["escalate.pairs"] >= c.get("escalate.retries", 0)
    assert c["hirschberg.pairs"] > 0
    # the eight reads' columns fit one group
    assert st.calls["windows.columns"] == st.calls["windows.supports"] == 1


def test_correct_output_unchanged_by_an_open_block(correct_runs):
    plain, traced, _ = correct_runs
    assert traced == plain
    assert plain.n_polished > 0


def test_correct_output_unchanged_by_small_column_groups(
        parser, correct_runs, monkeypatch):
    """Reads cut into groups of a few thousand moves (a group a read or
    two here) correct to the same reads as one group."""
    monkeypatch.setattr(correct, "GROUP_MOVES", 3000)
    got, st = _traced(lambda: correct.correct_reads(
        parser, CorrectConfig(mapper=MAPPER, max_support=7), device="cpu"))
    assert got == correct_runs[0]
    assert 1 < st.calls["windows.columns"] <= 8
