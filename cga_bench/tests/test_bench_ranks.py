"""The four-rank cell (``entries/correct_ranks.py``) as a whole run on the
CPU: four gloo ranks of a ``RankPool`` at a tiny size, judged by the
reference.  The run has to read ``correct``, and has to stop reading it
when one rank's share of the reads is dropped or when the gathered shares
land one rank off; no rank process may outlive a run."""

import json
import os
import time

import numpy as np
import pytest

from cga_bench import harness
from cga_bench.entries import correct_ranks
from conftest import copy_bench

CELL = "correct_ont_d4.tiny"
RANKS = 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = copy_bench(tmp_path_factory.mktemp("bench"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": CELL, "config": "correct_ont_d4",
                               "traffic": "tiny", "chips": RANKS,
                               "why": "tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "correct_bases_per_s":
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def shares(out, reads, max_len=16384) -> list[list[int]]:
    """The deal of the job's reads over the ranks, worked out again from
    the mapper's rows the run returned (the port's own rule)."""
    from claragenomicsanalysis_tpu_torch.models.correct import deal_reads
    rows = np.asarray(out["rows"], np.int64).reshape(-1, 8)
    rows = rows[np.maximum(rows[:, 3] - rows[:, 2], rows[:, 5] - rows[:, 4])
                <= max_len]
    area = (rows[:, 3] - rows[:, 2]) * (rows[:, 5] - rows[:, 4])
    areas = [int(area[rows[:, 0] == r].sum()) for r in range(len(reads))]
    return deal_reads(areas, RANKS)


def drop_a_share(out, reads):
    gone = set(max(shares(out, reads), key=len))
    return dict(out, seqs=[s for i, s in enumerate(out["seqs"])
                           if i not in gone])


def shares_one_rank_off(out, reads):
    deal = shares(out, reads)
    gathered = [out["seqs"][i] for share in deal for i in share]
    seqs = list(out["seqs"])
    for i, s in zip([i for share in deal[1:] + deal[:1] for i in share],
                    gathered):
        seqs[i] = s
    return dict(out, seqs=seqs)


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("fault,number", [
    (None, None), (drop_a_share, "reads_missing"),
    (shares_one_rank_off, "reads_differing")],
    ids=["sound", "a-share-dropped", "shares-one-rank-off"])
def test_four_ranks_judged(root, fault, number):
    pids = []
    try:
        res = harness.run_cell(CELL, 2**33 + 5, 0.01, False,
                               time.perf_counter(), root=root, device="cpu",
                               fault=fault)
        pids = [p.pid for p in correct_ranks._pool._procs]
    finally:
        correct_ranks.close()
    assert len(pids) == RANKS - 1
    assert not any(alive(p) for p in pids)
    assert res["attempted"] >= 1
    if fault is None:
        assert res["correct"] is True, res["checks"]
        assert all(c["value"] == 0 for c in res["checks"].values())
    else:
        assert res["correct"] is False
        assert res["checks"][number]["value"] > res["checks"][number]["limit"]
