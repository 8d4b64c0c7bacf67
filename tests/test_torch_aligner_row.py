"""``create_aligner(..., kernel="row")``: the port's aligner through the
row-layout banded NW (B3) and its row-layout decode, against the same
aligner through the diag kernel (B1), the JAX package's Aligner, the align
golden and the JAX package's chunk sizing.  Integer outputs, compared
exactly."""

import contextlib
import functools
import io
import os

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.models.aligner import (
    create_aligner as jax_create_aligner)
from claragenomicsanalysis_tpu.ops import banded as jax_banded
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.core.status import StatusType
from claragenomicsanalysis_tpu_torch.models import aligner as port_aligner
from claragenomicsanalysis_tpu_torch.ops import banded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
P = 8                    # configured band radius
MAX_LEN = 96


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def bucket_pairs(seed: int) -> list[tuple[str, str]]:
    """Pairs in the band buckets r = P, P + 8 and P + 16, pairs whose query
    Hirschberg splits, repeats (many tied paths), N bases, empty sides and
    an overlong query."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(4):                       # substitutions only: dl == 0
        a = generate_random_genome(int(rng.integers(30, 80)), rng)
        b = list(a)
        for pos in rng.integers(0, len(a), 3):
            b[pos] = "ACGT"[int(rng.integers(0, 4))]
        pairs.append((a, "".join(b)))
    for dl in (1, 5, 8, 11, 16):
        a = generate_random_genome(int(rng.integers(40, 80)), rng)
        pairs.append((a, mutate_sequence(a, 2, rng)[: len(a) - dl]))
    for _ in range(3):
        a = generate_random_genome(int(rng.integers(70, MAX_LEN + 1)), rng)
        pairs.append((a, mutate_sequence(a, 9, rng)[:MAX_LEN]))
    pairs += [("AC" * 45, "AC" * 40), ("ACNNGT" * 10, "ACGT" * 13),
              ("", "ACGT"), ("", ""), ("ACGT" * 24, "TT"),
              ("ACGT" * 30, "ACGT" * 20)]         # the last: query too long
    return pairs


def run_port(pairs, algorithm: str, kernel: str, device="cpu"):
    al = port_aligner.create_aligner(MAX_LEN, MAX_LEN, len(pairs),
                                     band_radius=P, algorithm=algorithm,
                                     device=device, kernel=kernel)
    for a, b in pairs:
        al.add_alignment(a, b)
    return al, [(r.status, r.edit_distance, r.path)
                for r in al.get_alignments()]


@pytest.mark.parametrize("algorithm", port_aligner.ALGORITHMS)
def test_row_kernel_equals_diag_kernel(algorithm, monkeypatch):
    """Paths, distances and statuses of kernel="row" equal kernel="diag"
    for every algorithm, with the launch budget lowered so that band
    buckets split into several launches; ukkonen's also equal the JAX
    package's Aligner."""
    pairs = bucket_pairs(31)
    monkeypatch.setattr(banded, "MEM_BUDGET_PER_DISPATCH", 2 * (
        banded.tb_bytes_per_problem(MAX_LEN, MAX_LEN, P + 16, "row")))
    al, row = run_port(pairs, algorithm, "row")
    _, diag = run_port(pairs, algorithm, "diag")
    assert al.kernel == "row"
    assert row == diag
    statuses = [s for s, _, _ in row]
    assert statuses.count(StatusType.EXCEEDED_MAX_LENGTH) == 1
    assert statuses.count(StatusType.SUCCESS) == len(pairs) - 1
    if algorithm == "ukkonen":
        _, qlen, _, tlen = al._pack()
        plan = al._plan(qlen, tlen)
        assert len(plan) > len({r for r, _ in plan}) >= 3   # split buckets
        jax_al = jax_create_aligner(MAX_LEN, MAX_LEN, len(pairs),
                                    band_radius=P, backend="xla")
        for a, b in pairs:
            jax_al.add_alignment(a, b)
        assert row == [(w.status, w.edit_distance, w.path)
                       for w in jax_al.get_alignments()]


def test_golden_through_row_kernel(monkeypatch):
    """``cli align`` with the aligner built with kernel="row" reproduces
    data/golden/sample_align.txt, as cmd_align prints it."""
    made = []
    create = port_aligner.create_aligner

    def create_row(*args, **kwargs):
        al = create(*args, kernel="row", **kwargs)
        made.append(al)
        return al

    monkeypatch.setattr(port_aligner, "create_aligner", create_row)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["align", f"{DATA}/sample_queries.fasta",
                         f"{DATA}/sample_targets.fasta", "--band-radius",
                         "64", "--device", "cpu"]) == 0
    assert [al.kernel for al in made] == ["row"]
    with open(os.path.join(DATA, "golden", "sample_align.txt")) as f:
        assert buf.getvalue() == f.read()


def test_all_empty_queries_through_row_kernel():
    """max_query_length 0: the row traceback has no row at all (and no
    bytes to size a launch by); every path is the deletion tail of row 0."""
    results = {}
    for kernel in banded.KERNELS:
        al = port_aligner.create_aligner(0, 8, 3, device="cpu",
                                         kernel=kernel)
        for b in ("ACG", "", "ACGTACGT"):
            al.add_alignment("", b)
        results[kernel] = [(r.status, r.edit_distance, r.path)
                           for r in al.get_alignments()]
    assert results["row"] == results["diag"] == [
        (StatusType.SUCCESS, 3, [3] * 3), (StatusType.SUCCESS, 0, []),
        (StatusType.SUCCESS, 8, [3] * 8)]


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="kernel"):
        banded.resolve("cpu", "pallas-row")
    for device in ("cpu", "cuda"):            # checked before the device
        with pytest.raises(ValueError, match="kernel"):
            port_aligner.create_aligner(16, 16, 1, device=device,
                                        kernel="auto")
    with pytest.raises(ValueError, match="kernel"):
        banded.launch_chunks(range(4), 16, 16, 8, "xla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_aligner.create_aligner(16, 16, 1, device="cuda",
                                        kernel="row")


def test_tb_bytes_and_chunks_follow_the_kernel(monkeypatch):
    """tb_bytes_per_problem equals the JAX package's for both layouts, and
    launch_chunks cuts a row launch by the row layout's bytes."""
    for Lq in (1, 16, 72, 1000, 10001):
        for Lt in (8, 56, 10008):
            for r in (1, 3, 8, 64, 600):
                for kernel in banded.KERNELS:
                    assert banded.tb_bytes_per_problem(Lq, Lt, r, kernel) \
                        == jax_banded.tb_bytes_per_problem(Lq, Lt, r, kernel)
    per_row = banded.tb_bytes_per_problem(10000, 10008, 72, "row")
    per_diag = banded.tb_bytes_per_problem(10000, 10008, 72, "diag")
    assert per_row == 2500 * 152 and per_diag == 5004 * 80
    monkeypatch.setattr(banded, "MEM_BUDGET_PER_DISPATCH", 3 * per_row)
    chunks = banded.launch_chunks(range(10), 10000, 10008, 72, "row")
    assert [len(c) for c in chunks] == [3, 3, 3, 1]
    assert [len(c) for c in banded.launch_chunks(
        range(10), 10000, 10008, 72, "diag")] == [2, 2, 2, 2, 2]
    resolved = banded.resolve("cpu", "row")
    assert resolved[0].__name__ == "banded_nw_row"
    assert isinstance(resolved[1], functools.partial)
    assert resolved[1].keywords == {"kernel": "row"}


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", port_aligner.ALGORITHMS)
def test_row_kernel_on_card_matches_cpu(cuda_device, algorithm):
    """kernel="row" on the card launches B3 and B2's row decode, never the
    diag kernels, and equals kernel="diag" on the CPU."""
    from claragenomicsanalysis_tpu_torch.utils import profiling
    pairs = bucket_pairs(32)
    with profiling.stage_times() as st:
        _, card = run_port(pairs, algorithm, "row", cuda_device)
        torch.cuda.synchronize()
    added = [st.launches().get(k, 0) for k in (
        "nw_row", "tb_decode_row", "nw_diag", "tb_decode")]
    assert added[0] > 0 and added[1] > 0 and added[2:] == [0, 0]
    assert card == run_port(pairs, algorithm, "diag")[1]
