"""``parallel.multihost.RankPool``: a world of gloo ranks on the CPU that
stays up across calls, the test process as rank 0.  Three jobs in a row
run on one world and equal the same jobs under ``run_ranks``; a worker
that raises surfaces as ``RanksFailed``; ``close()`` leaves no process.
This file imports no JAX: the ranks import its job functions.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_rank_pool.py
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu_torch.parallel import comm, multihost
from claragenomicsanalysis_tpu_torch.parallel.mesh import make_mesh
from claragenomicsanalysis_tpu_torch.parallel.shard import sharded_banded_nw
from claragenomicsanalysis_tpu_torch.utils.genomeutils import pack_pairs

WORLD = 3
SEEDS = (1, 2, 3)


def job(seed: int):
    """Banded NW of a seeded batch with the pairs split over every rank,
    and the process id of every rank."""
    rng = np.random.default_rng(seed)
    qs = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(n)))
          for n in rng.integers(20, 90, 11)]
    ts = [q[2:] + "ACG" for q in qs]
    q, ql, t, tl = pack_pairs(qs, ts, 96, 96)
    mesh = make_mesh()
    scores, paths = sharded_banded_nw(q, ql, t, tl, 8, mesh, "cpu")
    pids = comm.all_gather(torch.tensor([os.getpid()]), mesh.group("data"))
    return scores.tolist(), paths, [int(p) for p in pids]


def three_jobs():
    return [job(s) for s in SEEDS]


def fail_on_rank(rank: int):
    if multihost.process_index() == rank:
        raise ValueError(f"rank {rank} fails")
    return multihost.process_index()


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture
def pool():
    p = multihost.RankPool(WORLD, ["cpu"] * WORLD, log_level="WARNING")
    yield p
    p.close()


def test_three_jobs_on_one_world_equal_run_ranks(pool):
    pids = [p.pid for p in pool._procs]
    got = [pool.run(job, s) for s in SEEDS]
    want = multihost.run_ranks(three_jobs, WORLD, ["cpu"] * WORLD,
                               timeout=240, log_level="WARNING")
    for g, w in zip(got, want[0]):
        assert g[:2] == w[:2]
    # one world: the caller is rank 0 and the workers stay the same
    assert all(g[2] == [os.getpid()] + pids for g in got)
    pool.close()
    assert not torch.distributed.is_initialized()
    assert not any(alive(p) for p in pids)
    assert multiprocessing.active_children() == []
    pool.close()                            # a second close does nothing


def test_a_raising_worker_surfaces_as_ranks_failed(pool):
    pids = [p.pid for p in pool._procs]
    assert pool.run(fail_on_rank, WORLD) == 0   # no rank fails
    with pytest.raises(multihost.RanksFailed) as e:
        pool.run(fail_on_rank, 2)
    assert e.value.exitcodes[0] == 0 and e.value.exitcodes[2] == 1
    assert "ValueError: rank 2 fails" in e.value.errors[2]
    assert "rank 2 fails" in str(e.value)
    # the failure ended the pool: no group, no process
    assert not torch.distributed.is_initialized()
    assert not any(alive(p) for p in pids)
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(fail_on_rank, 1)
