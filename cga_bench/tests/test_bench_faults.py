"""A whole run, the chip's look skipped (the port's plain versions on the
CPU, a tiny cell), with the timed path broken underneath: ``correct`` has
to come out false for every fault the cell can have, and true without
one."""

import time

import numpy as np
import pytest

from cga_bench import harness
from conftest import copy_bench


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_bench(tmp_path_factory.mktemp("bench"))


def run(root, cell, fault=None, seed=2**33 + 5):
    return harness.run_cell(cell, seed, 0.01, False, time.perf_counter(),
                            root=root, device="cpu", fault=fault)


def _longest(rows):
    span = np.maximum(rows[:, 3] - rows[:, 2], rows[:, 5] - rows[:, 4])
    return int(np.argmax(span))


def _another(n, longest):
    """An index other than ``longest``, fixed by the test, not by the
    run's seed."""
    rest = [i for i in range(n) if i != longest]
    return rest[int(np.random.default_rng(3).integers(len(rest)))]


def _alter(cigar):
    return cigar.replace("M", "X", 1)


def alter_cigar(out, reads):
    i = _longest(out["rows"])
    cig = list(out["cigars"])
    cig[i] = _alter(cig[i])
    return dict(out, cigars=cig)


def alter_another_cigar(out, reads):
    i = _another(len(out["cigars"]), _longest(out["rows"]))
    cig = list(out["cigars"])
    cig[i] = _alter(cig[i])
    return dict(out, cigars=cig)


def alter_row(out, reads):
    rows = np.array(out["rows"], np.int64)
    i = _another(len(rows), _longest(rows))
    rows[i, 3] -= 1
    return dict(out, rows=rows)


def half_rows(out, reads):
    return dict(out, rows=out["rows"][::2], cigars=out["cigars"][::2])


def no_alignment(out, reads):
    return dict(out, cigars=[""] * len(out["cigars"]))


def _longest_read(reads):
    return max(range(len(reads)), key=lambda i: len(reads[i][1]))


def _alter_read(out, r):
    seqs = list(out["seqs"])
    seqs[r] = ("C" if seqs[r][0] != "C" else "G") + seqs[r][1:]
    return dict(out, seqs=seqs)


def alter_base(out, reads):
    return _alter_read(out, _longest_read(reads))


def alter_another_base(out, reads):
    return _alter_read(out, _another(len(reads), _longest_read(reads)))


def alter_mapped_row(out, reads):
    rows = np.array(out["rows"], np.int64)
    rows[_another(len(rows), _longest(rows)), 6] += 1
    return dict(out, rows=rows)


def half_reads(out, reads):
    return dict(out, seqs=out["seqs"][: len(out["seqs"]) // 2])


def unchanged(out, reads):
    return dict(out, seqs=[s for _, s in reads])


@pytest.mark.parametrize("cell,fault,number", [
    ("overlap_ont.tiny", None, None),
    ("overlap_ont.tiny", alter_cigar, "cigars_differing"),
    ("overlap_ont.tiny", alter_another_cigar, "cigars_differing"),
    ("overlap_ont.tiny", alter_row, "overlap_rows_differing"),
    ("overlap_ont.tiny", half_rows, "overlap_rows_differing"),
    ("overlap_ont.tiny", no_alignment, "cigars_differing"),
    ("correct_ont.tiny", None, None),
    ("correct_ont.tiny", alter_base, "reads_differing"),
    ("correct_ont.tiny", alter_another_base, "reads_differing"),
    ("correct_ont.tiny", alter_mapped_row, "overlap_rows_differing"),
    ("correct_ont.tiny", half_reads, "reads_missing"),
    ("correct_ont.tiny", unchanged, "reads_differing"),
], ids=["pipeline-sound", "pipeline-answer-altered",
        "pipeline-another-answer-altered", "pipeline-overlap-altered",
        "pipeline-half-left-out", "pipeline-step-skipped", "correct-sound",
        "correct-answer-altered", "correct-another-answer-altered",
        "correct-overlap-altered", "correct-half-left-out",
        "correct-returned-unchanged"])
def test_a_fault_makes_the_run_incorrect(root, cell, fault, number):
    res = run(root, cell, fault)
    assert res["attempted"] >= 1
    if fault is None:
        assert res["correct"] is True, res["checks"]
        assert all(c["value"] == 0 for c in res["checks"].values())
    else:
        assert res["correct"] is False
        assert res["checks"][number]["value"] > res["checks"][number]["limit"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["overlap_ont.tiny", "correct_ont.tiny"])
def test_the_control_is_not_correct(root, cell):
    """The control (cga_bench/control.py) at a test's size: the reference
    with one guarantee broken (non-canonical paths; the consensus tie rule
    reversed), judged as a run's answers are."""
    from cga_bench.control import readings
    for seed in (11, 12):
        nums = readings(cell, seed, 1, "cpu", "control", root=root)
        nums.pop("seconds")
        assert any(v > lim for v, lim in nums.values() if lim is not None)


def test_the_samples_cover_what_the_seed_does_not_always_pick():
    """Whole reads and whole jobs where the budget allows; where it does
    not, the seed draws different items besides the longest."""
    from cga_bench.reference import judge
    reads = [[(f"r{i}", "A" * (100 + i)) for i in range(40)]]
    settings = {"window_length": 32}
    whole = judge.read_sample(reads, settings, {"windows": 10**6}, 1)
    assert sorted(whole) == [(0, r) for r in range(40)]
    picks = [judge.read_sample(reads, settings, {"windows": 20}, s)
             for s in (1, 2, 3)]
    assert all(p[0] == (0, 39) and len(p) == 5 for p in picks)
    assert len({tuple(p) for p in picks}) == 3
