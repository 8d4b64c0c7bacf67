"""Process groups and rank processes (counterpart of
``claragenomicsanalysis_tpu/parallel/multihost.py``).

The JAX package drives all the local devices of a mesh from one process and
forms a multi-process group only across hosts.  PyTorch's idiom is one
process a rank, so here every mesh member is a process:

- :func:`initialize_distributed` forms the group (``torch.distributed``)
  from an explicit rendezvous, world size and rank, with one device a rank
  (``devices``, the same list on every rank; it may repeat a card).  By
  default every rank has a card of its own (:func:`default_devices`), as
  every entry point of the port runs on the card unless asked; CPU ranks
  are asked for with ``["cpu"] * n``;
- :func:`choose_backend` is the one backend rule, a plain function of that
  list, logged at init: ``nccl`` when every rank has a card of its own,
  ``gloo`` on the CPU or when ranks share a card.  A failed init raises;
  nothing retries with another backend;
- :func:`run_ranks` starts the ranks (``spawn``), runs one importable
  function in each and brings every rank's return value back, for the CLI's
  ``-d N``, the tests and the smoke run;
- :class:`RankPool` keeps a world up across calls, the caller as rank 0:
  for a library user who runs one job after another on the same ranks.

Library functions are SPMD: every rank calls them with the same host inputs
and gets the whole, merged result.  Only rank 0 writes files (see
:func:`is_writer`).
"""

import atexit
import logging
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import initialize_logger

#: the device of every rank of the world formed by initialize_distributed
_world_devices: list[str] | None = None
#: the process groups this rank has joined, by their ranks
_groups: dict[tuple, object] = {}


def choose_backend(devices) -> str:
    """``nccl`` when every rank has a CUDA card of its own, else ``gloo``
    (the CPU, or ranks that share a card: NCCL refuses two ranks on one
    device).  Gloo moves CUDA tensors through host memory (parallel/comm.py)."""
    devs = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devs)
                 and len({d.index or 0 for d in devs}) == len(devs))
    return "nccl" if own_cards else "gloo"


def default_devices(world_size: int) -> list[str]:
    """One card a rank, ``cuda:0`` .. ``cuda:{n-1}``; raises when there are
    fewer cards than ranks (never falls back to the CPU)."""
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > k:
        raise RuntimeError(f"{world_size} ranks but only {k} CUDA devices; "
                           f"CPU ranks are asked for with devices=['cpu'] * "
                           f"{world_size}")
    return [f"cuda:{r}" for r in range(world_size)]


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: str | None = None,
                           devices=None) -> None:
    """Form the process group: ``init_method`` is a ``file://`` or
    ``tcp://host:port`` rendezvous, ``devices`` one device a rank (default:
    :func:`default_devices`).  A CUDA rank's card becomes the current device
    before anything is launched.  World size 1 forms no group."""
    global _world_devices
    devices = [str(d) for d in (devices if devices is not None
                                else default_devices(world_size))]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _world_devices = devices
    if world_size <= 1:
        return
    backend = backend or choose_backend(devices)
    logging.getLogger("claragenomicsanalysis_tpu_torch").info(
        "rank %d of %d on %s: backend %s (%s)", rank, world_size, dev,
        backend, "every rank has a card of its own" if backend == "nccl"
        else "the CPU, or ranks that share a card")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def destroy_distributed() -> None:
    global _world_devices
    if dist.is_initialized():
        dist.destroy_process_group()
    _world_devices = None
    _groups.clear()


def group_of(ranks: list[int]):
    """The process group of ``ranks`` (sorted world ranks): the default
    group where they are the whole world, else one made once a process.
    ``torch.distributed.new_group`` is a call of every rank of the world,
    so every rank asks for the same rank sets in the same order (the
    meshes, parallel/mesh.py, are built SPMD); a rank outside the set gets
    a placeholder it never uses."""
    if ranks == list(range(process_count())):
        return dist.group.WORLD
    key = tuple(ranks)
    if key not in _groups:
        _groups[key] = dist.new_group(ranks)
    return _groups[key]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """True on the one rank that writes files and stdout (rank 0)."""
    return process_index() == 0


def world_devices() -> list[str]:
    """The device of every rank: the list given to initialize_distributed,
    or, in a process that formed no group, its one default device, the
    current card (``cuda``, which raises at use, where there is none)."""
    if _world_devices is not None:
        return list(_world_devices)
    if torch.cuda.is_available():
        return [f"cuda:{torch.cuda.current_device()}"]
    return ["cuda"]


def make_global_mesh(rep: int = 1, sp: int = 1):
    """('data', 'rep', 'sp') mesh over every rank of the world, ``data``
    taking what rep x sp leaves."""
    from .mesh import Mesh
    n = process_count()
    if n % (rep * sp):
        raise ValueError(f"{n} devices not divisible by rep*sp={rep * sp}")
    devices = np.array(world_devices(), dtype=object)
    return Mesh(devices.reshape(n // (rep * sp), rep, sp))


class RanksFailed(RuntimeError):
    """A rank process exited with a non-zero code, or the ranks ran past
    their time; ``exitcodes`` has one entry a rank, None for a rank that
    was still running and was stopped.  ``errors``: the tracebacks that
    ranks reported, by rank (a :class:`RankPool`'s workers send theirs)."""

    def __init__(self, exitcodes: list, errors: dict | None = None):
        self.exitcodes = exitcodes
        self.errors = errors or {}
        last = "".join(f"; rank {r}: {tb.strip().splitlines()[-1]}"
                       for r, tb in sorted(self.errors.items()))
        super().__init__(f"rank exit codes {exitcodes}{last}")

    @property
    def first_error(self) -> int:
        return next((c for c in self.exitcodes if c), 1)


def _rank_entry(rank: int, world_size: int, init_method: str, devices,
                fn, args, out_dir: str, log_level: str) -> None:
    """One rank: form the group, run ``fn(*args)``, keep its result in
    ``out_dir``.  An exception ends the process with its traceback on
    stderr and exit code 1 (multiprocessing's own handling)."""
    initialize_logger(log_level)
    if torch.device(devices[rank]).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    initialize_distributed(init_method, world_size, rank, devices=devices)
    result = fn(*args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    destroy_distributed()


def run_ranks(fn, world_size: int, devices=None, args: tuple = (),
              timeout: float | None = None, log_level: str = "INFO") -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes, one a rank, after
    each has formed the group (``devices``: one a rank, default
    :func:`default_devices`, checked here before any rank starts) through a ``file://`` rendezvous in a temporary directory; ``fn`` must
    be importable (spawn sends it by name).  Returns every rank's return
    value in rank order.  When a rank exits non-zero, or ``timeout``
    seconds pass, the others are stopped and :class:`RanksFailed` raised.
    ``log_level``: the ranks' logger level (the backend choice is INFO)."""
    import multiprocessing
    devices = [str(d) for d in (devices if devices is not None
                                else default_devices(world_size))]
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cga_ranks_")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    procs = [ctx.Process(target=_rank_entry, args=(
        r, world_size, init, devices, fn, args, tmp, log_level))
        for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        t0 = time.monotonic()
        while True:
            codes = [p.exitcode for p in procs]
            late = timeout is not None and time.monotonic() - t0 > timeout
            if late or any(codes) or all(c == 0 for c in codes):
                break
            for p in procs:
                p.join(0.05)
        _stop(procs)
        if not all(c == 0 for c in codes):
            raise RanksFailed(codes)
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _stop(procs) -> None:
    """Terminate the processes still running and reap every one."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        if p.pid is None:
            continue            # never started
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def _worker_cores(world_size: int) -> list:
    """A core for each of ranks 1 .. n-1, none of them the caller's: where
    the caller is pinned to fewer cores than the host has (the benchmark
    pins its process to one, and spawned children inherit that), the
    host's other cores in order; else None, and the workers keep the
    caller's set."""
    if not hasattr(os, "sched_getaffinity"):
        return [None] * (world_size - 1)
    mine = os.sched_getaffinity(0)
    spare = [c for c in range(os.cpu_count() or 1) if c not in mine]
    if len(spare) < world_size - 1:
        return [None] * (world_size - 1)
    return spare[:world_size - 1]


def _pool_worker(rank: int, world_size: int, init_method: str, devices,
                 conn, core, log_level: str) -> None:
    """Rank ``rank`` of a :class:`RankPool`: join the group, then run each
    ``(fn, args)`` that rank 0 sends, answering None, or the traceback and
    leaving (the world is then out of step), until rank 0 sends None or
    goes away."""
    initialize_logger(log_level)
    if core is not None:
        try:
            os.sched_setaffinity(0, {core})
        except OSError:
            pass            # a core the host does not give: keep the set
        torch.set_num_threads(1)
    elif torch.device(devices[rank]).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    initialize_distributed(init_method, world_size, rank, devices=devices)
    while True:
        try:
            task = conn.recv()
        except EOFError:
            task = None                 # rank 0 is gone
        if task is None:
            break
        fn, args = task
        try:
            fn(*args)
        except Exception:
            conn.send(traceback.format_exc())
            os._exit(1)
        conn.send(None)
    destroy_distributed()


class RankPool:
    """A world of ``world_size`` ranks that stays up across calls: the
    caller is rank 0 and :meth:`run` runs one importable function on every
    rank in lockstep.  Ranks 1 .. n-1 are started once (``spawn``), each on
    a core of its own where the caller is pinned (:func:`_worker_cores`),
    and the group is formed through a ``file://`` rendezvous as in
    :func:`run_ranks`; where a rank is on a card, the kernels are built
    before any worker starts.  :meth:`close` (also at interpreter exit)
    ends the group and reaps every worker.

        pool = RankPool(4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
        for parser in jobs:
            result = pool.run(correct_job, parser)   # rank 0's return
        pool.close()
    """

    def __init__(self, world_size: int, devices=None,
                 log_level: str = "INFO"):
        import multiprocessing
        devices = [str(d) for d in (devices if devices is not None
                                    else default_devices(world_size))]
        if len(devices) != world_size:
            raise ValueError(f"{len(devices)} devices for {world_size} ranks")
        if dist.is_initialized():
            raise RuntimeError("this process is already a rank of a group")
        if any(torch.device(d).type == "cuda" for d in devices):
            from ..ops import _build
            _build.build()          # once, before the workers load it
        ctx = multiprocessing.get_context("spawn")
        self._pid = os.getpid()
        self._tmp = tempfile.mkdtemp(prefix="cga_pool_")
        init = f"file://{os.path.join(self._tmp, 'rendezvous')}"
        self._conns, self._procs = [], []
        try:
            for rank, core in zip(range(1, world_size),
                                  _worker_cores(world_size)):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_pool_worker, daemon=True, args=(
                    rank, world_size, init, devices, theirs, core,
                    log_level))
                p.start()
                theirs.close()
                self._conns.append(mine)
                self._procs.append(p)
            initialize_distributed(init, world_size, 0, devices=devices)
        except BaseException:
            self._abort()
            raise
        atexit.register(self.close)

    def run(self, fn, *args):
        """``fn(*args)`` on every rank; -> rank 0's return value.  A rank
        that raises ends the pool: :class:`RanksFailed` for a worker, the
        exception itself for rank 0."""
        if self._procs is None:
            raise RuntimeError("the pool is closed")
        for c in self._conns:
            c.send((fn, args))
        try:
            result = fn(*args)
        except BaseException:
            errors = self._replies(wait=False)
            codes = self._codes(errors)
            self._abort()
            if errors:
                raise RanksFailed(codes, errors)
            raise
        errors = self._replies(wait=True)
        if errors:
            codes = self._codes(errors)
            self._abort()
            raise RanksFailed(codes, errors)
        return result

    def _replies(self, wait: bool) -> dict:
        """The tracebacks the workers sent, by rank; with ``wait``, after
        every worker has answered or ended."""
        from multiprocessing.connection import wait as ready
        errors = {}
        pending = dict(enumerate(self._conns, 1))
        while pending:
            busy = {p.sentinel: r for r, p in enumerate(self._procs, 1)
                    if r in pending}
            got = ready(list(pending.values()) + list(busy),
                        timeout=None if wait else 0)
            if not got:
                break
            for obj in got:
                if obj in busy:
                    r = busy[obj]
                    if r not in pending or pending[r].poll():
                        continue            # its answer is (was) in the pipe
                    errors.setdefault(r, f"rank {r} exited with code "
                                         f"{self._procs[r - 1].exitcode}")
                    pending.pop(r)
                    continue
                r = next(k for k, c in pending.items() if c is obj)
                try:
                    reply = obj.recv()
                except EOFError:
                    reply = f"rank {r} closed its pipe"
                if reply is not None:
                    errors[r] = reply
                pending.pop(r)
        return errors

    def _codes(self, errors: dict) -> list:
        """Every rank's exit code, once the ranks that failed have left
        (None for a rank still running)."""
        for r in errors:
            self._procs[r - 1].join(10)
        return [0] + [p.exitcode for p in self._procs]

    def close(self) -> None:
        """End the group and reap every worker (idempotent; a no-op in a
        process forked from the caller)."""
        if self._procs is None or os.getpid() != self._pid:
            return
        for c in self._conns:
            try:
                c.send(None)
            except OSError:
                pass                    # the worker has gone
        destroy_distributed()
        for p in self._procs:
            p.join(30)
        self._abort()

    def _abort(self) -> None:
        """Stop the workers still running, reap them, end rank 0's group."""
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        _stop(procs)
        for c in self._conns:
            c.close()
        destroy_distributed()
        shutil.rmtree(self._tmp, ignore_errors=True)
        atexit.unregister(self.close)
