"""The metric arithmetic: host ms a read Mbp, the pipeline's CIGAR strings,
B4's counted work and roofline, the device's idle share and the
breakdown, from hand-made records."""

import json

import pytest

from cga_bench import peaks, spec, trace
from conftest import ROOT

REC = {"bases": 2_000_000, "mbp": 2.0, "elapsed_s": 40.0, "setup_s": 21.5,
       "jobs": 2, "peak_bytes": 3 * 2**30,
       "host_ms": {"pipeline.map": 60.0, "pipeline.align": 30_000.0,
                   "aligner.pack": 1_000.0, "aligner.myers": 20_000.0,
                   "aligner.hirschberg": 15_000.0,
                   "hirschberg.split": 9_000.0, "pipeline.cigar": 900.0},
       "kernel_ms": {"myers": 150.0, "nw_diag": 40.0, "tb_decode": 10.0},
       "myers": (0.03, 0.15), "busy_s": 0.5, "window_s": 40.0}


def read(name, rec=REC):
    return spec.reader(name, ROOT)(rec)


def test_rates_and_ms_per_mbp():
    assert read("overlap_bases_per_s") == 50_000.0
    assert read("setup_s") == 21.5
    assert read("map_ms_per_mbp.overlap") == 30.0
    assert read("aligner_ms_per_mbp.overlap") == 10_500.0
    assert read("hirschberg_ms_per_mbp.overlap") == 7_500.0
    assert read("kernel_ms_per_mbp.overlap") == 100.0
    assert read("peak_mem_gib.overlap") == 3.0


def test_cigar_strings_of_the_pipeline():
    # pipeline.cigar's own host ms, not pipeline.align's less its aligner
    # ranges; a run that never entered it reads nothing
    assert read("cigar_strings_ms_per_mbp.overlap") == 900.0 / 2
    rec = dict(REC, host_ms={"pipeline.align": 30_000.0})
    assert read("cigar_strings_ms_per_mbp.overlap", rec) is None


def test_hirschberg_reads_zero_where_no_pair_went_there():
    rec = dict(REC, host_ms={"correct.align": 500.0, "correct.map": 5.0})
    assert read("hirschberg_ms_per_mbp.correct", rec) == 0.0
    assert read("aligner_ms_per_mbp.correct", rec) == 250.0
    # a run whose records hold no such stage reads nothing
    assert read("windows_ms_per_mbp.correct", rec) is None
    assert read("myers_roofline.correct", dict(rec, myers=None)) is None


def test_b4_count_and_roofline():
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    ops, nbytes = peaks.myers_work(B=4, Lq=64, Lt=100, words=5)
    assert ops == 27 * 5 * 100
    assert nbytes == 4 * 64 + 4 * 100 + 32 + 4 * 4 * 101 + 16
    assert peaks.bound_s(ops, nbytes) == max(ops / peaks.INT32_OPS_PER_S,
                                             nbytes / 3.35e12)
    assert read("myers_roofline.overlap") == pytest.approx(20.0)
    assert read("device_idle.overlap") == pytest.approx(98.75)


def test_profile_busy_time_and_idle_gaps(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "cga_bench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "pipeline.align",
           "ts": 10, "dur": 80},
          {"ph": "X", "cat": "user_annotation", "name": "aligner.hirschberg",
           "ts": 50, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 12, "dur": 8},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 95,
           "dur": 10}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    got = trace.read_profile(str(path), "cga_bench.window")
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(20e-6)   # [5, 20) and [95, 100)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops == pytest.approx({"k1": 1e-5, "k2": 8e-6, "copy": 1e-5})
    idle = dict(got["breakdown"]["idle_gaps"])
    # gaps [0, 5) (no range), [20, 95): its middle 57.5 lies inside
    # aligner.hirschberg, the innermost range open there
    assert idle == pytest.approx({"(no range open)": 5e-6,
                                  "aligner.hirschberg": 75e-6})


@pytest.mark.parametrize("raw,short", [
    ("void (anonymous namespace)::myers_kernel<16>(signed char const*, int)",
     "myers_kernel<16>"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl_nocast<at::native::CUDAFunctor_add<long> >(at::TensorIteratorBase&"
     ")::{lambda(int)#1}>(int, x)", "at::native::elementwise_kernel<...>"),
])
def test_device_operation_names_are_shortened(raw, short):
    assert trace.short_name(raw) == short
