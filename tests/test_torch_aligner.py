"""The port's Aligner and CLI (claragenomicsanalysis_tpu_torch) against the
JAX package's Aligner, the NW oracle and the CLI golden.  Integer outputs,
compared exactly."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core.bufferplan import plan_aligner_batch
from claragenomicsanalysis_tpu.core.config import AlignerConfig
from claragenomicsanalysis_tpu.core.status import StatusType
from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.models.aligner import (
    Aligner as JaxAligner, create_aligner as jax_create_aligner)
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch import cli
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


def mixed_pairs(seed: int) -> list[tuple[str, str]]:
    """Buckets r = P (equal lengths), P + 8 (dl <= 8) and P + 16
    (P < dl <= 16, beyond the configured radius), plus an overlong pair."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(4):                       # substitutions only: dl == 0
        a = generate_random_genome(int(rng.integers(30, 80)), rng)
        b = list(a)
        for pos in rng.integers(0, len(a), 3):
            b[pos] = "ACGT"[int(rng.integers(0, 4))]
        pairs.append((a, "".join(b)))
    for dl in (1, 5, 8):
        a = generate_random_genome(int(rng.integers(40, 80)), rng)
        pairs.append((a, mutate_sequence(a, 2, rng)[: len(a) - dl]))
    for dl in (11, 16):
        a = generate_random_genome(int(rng.integers(40, 80)), rng)
        pairs.append((a, a[dl:]))
    pairs.append(("ACGT" * 30, "ACGT" * 20))   # query over MAX_LEN
    return pairs


def jax_budget_for(pairs_per_launch: int) -> int:
    """A dispatch budget that the JAX package's core.bufferplan turns into
    `pairs_per_launch` problems per launch for every bucket of these tests
    (r < 64)."""
    cfg = AlignerConfig(MAX_LEN, MAX_LEN, 1 << 20, P)
    return pairs_per_launch * plan_aligner_batch(cfg, 1).bytes_per_problem


def budget_for(pairs_per_launch: int) -> int:
    """A dispatch budget that ops.banded.launch_chunks turns into
    `pairs_per_launch` problems per launch at the widest bucket of these
    tests (r = P + 16), and more at the narrower ones."""
    return pairs_per_launch * banded.tb_bytes_per_problem(MAX_LEN, MAX_LEN,
                                                          P + 16)


def run_both(pairs, max_alignments, monkeypatch):
    """Same pairs through both aligners; the dispatch budget is lowered on
    both so that band buckets split into several launches."""
    monkeypatch.setattr(JaxAligner, "MEM_BUDGET_PER_DISPATCH",
                        jax_budget_for(2))
    monkeypatch.setattr(banded, "MEM_BUDGET_PER_DISPATCH", budget_for(2))
    jax_al = jax_create_aligner(MAX_LEN, MAX_LEN, max_alignments,
                                band_radius=P, backend="xla")
    port_al = port_aligner.create_aligner(MAX_LEN, MAX_LEN, max_alignments,
                                          band_radius=P, device="cpu")
    added = [(jax_al.add_alignment(a, b), port_al.add_alignment(a, b))
             for a, b in pairs]
    return added, jax_al.get_alignments(), port_al.get_alignments()


def test_aligner_matches_jax_aligner(monkeypatch):
    pairs = mixed_pairs(21)
    pairs += [("ACGT", "ACGT")] * 2          # past max_alignments
    added, want, got = run_both(pairs, len(pairs) - 2, monkeypatch)
    assert [a for a, _ in added] == [b for _, b in added]
    assert [a for a, _ in added][-3:] == [
        StatusType.EXCEEDED_MAX_LENGTH, StatusType.EXCEEDED_MAX_ALIGNMENTS,
        StatusType.EXCEEDED_MAX_ALIGNMENTS]
    assert len(got) == len(want) == len(pairs) - 2
    for w, g in zip(want, got):
        assert (g.query, g.target, g.status) == (w.query, w.target, w.status)
        assert (g.edit_distance, g.path) == (w.edit_distance, w.path)
        assert g.convert_to_cigar() == w.convert_to_cigar()
        assert g.format_alignment() == w.format_alignment()
    assert [g.status for g in got].count(StatusType.SUCCESS) == len(got) - 1
    assert got[-1].status == StatusType.EXCEEDED_MAX_LENGTH


def test_band_buckets_split_into_chunks(monkeypatch):
    """The chunking the parity test relies on: with the lowered budget the
    r = P + 8 and P + 16 buckets (3 pairs each) run as launches of 2 and 1,
    and the narrower r = P bucket's 4 pairs fit one launch."""
    calls = []
    pairs = mixed_pairs(22)
    port_al = port_aligner.create_aligner(MAX_LEN, MAX_LEN, len(pairs),
                                          band_radius=P, device="cpu")
    nw_fn = port_al._nw

    def counting_nw(q, qlen, t, tlen, r):
        calls.append((r, q.shape[0]))
        return nw_fn(q, qlen, t, tlen, r)

    monkeypatch.setattr(port_al, "_nw", counting_nw)
    monkeypatch.setattr(banded, "MEM_BUDGET_PER_DISPATCH", budget_for(2))
    for a, b in pairs:
        port_al.add_alignment(a, b)
    port_al.align_all()
    assert calls == [(P, 4), (P + 8, 2), (P + 8, 1), (P + 16, 2),
                     (P + 16, 1)]
    _, qlen, _, tlen = port_al._pack()
    assert [(r, len(sel)) for r, sel in port_al._plan(qlen, tlen)] == calls


def test_band_overflow_maps_to_status(monkeypatch):
    """The adaptive band always holds a global path, so an INF score needs
    the band held at the configured radius; rows beyond it then report
    EXCEEDED_MAX_ALIGNMENT_DIFFERENCE and the rest equal the banded
    oracle."""
    monkeypatch.setattr(port_aligner, "bucket_radius", lambda p, dl: p)
    pairs = mixed_pairs(23)[:-1]
    al = port_aligner.create_aligner(MAX_LEN, MAX_LEN, len(pairs),
                                     band_radius=P, device="cpu")
    for a, b in pairs:
        al.add_alignment(a, b)
    for res, (a, b) in zip(al.get_alignments(), pairs):
        path, dist, status = nw_oracle.align(a, b, band_radius=P)
        assert res.status == status
        if status == StatusType.SUCCESS:
            assert (res.path, res.edit_distance) == (path, dist)
        else:
            assert (res.path, res.edit_distance) == ([], -1)
    assert sum(r.status == StatusType.EXCEEDED_MAX_ALIGNMENT_DIFFERENCE
               for r in al.get_alignments()) == 2


def test_cli_align_golden_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["align", f"{DATA}/sample_queries.fasta",
                         f"{DATA}/sample_targets.fasta", "--band-radius",
                         "64", "--device", "cpu"]) == 0
    with open(os.path.join(DATA, "golden", "sample_align.txt")) as f:
        assert buf.getvalue() == f.read()


#: imports every module of the port, runs its CPU path through all four
#: algorithms (banded-escalate through both banded-NW kernels), POA
#: consensus and the mapper, and fails if any module of the JAX package or
#: jax got loaded
NO_JAX_PROBE = """
import contextlib, io, pkgutil, sys, importlib
import claragenomicsanalysis_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from claragenomicsanalysis_tpu_torch import cli, create_aligner
data = sys.argv[1]
for alg in ("ukkonen", "myers", "hirschberg-myers"):
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["align", f"{data}/sample_queries.fasta",
                         f"{data}/sample_targets.fasta", "--algorithm", alg,
                         "--device", "cpu"]) == 0
with contextlib.redirect_stdout(io.StringIO()):
    assert cli.main(["poa", f"{data}/sample-windows.txt", "--max-windows",
                     "2", "--device", "cpu"]) == 0
    assert cli.main(["poa", f"{data}/sample-windows.txt", "--max-windows",
                     "2", "--msa", "--device", "cpu"]) == 0
    assert cli.main(["map", f"{data}/sample_reads.fasta", "--device",
                     "cpu"]) == 0
from claragenomicsanalysis_tpu_torch import create_batch
b = create_batch(max_poas=1, device="cpu", kernel="window", output_mask=3)
b.add_poa_group(["ACGT", "AGT"])
assert b.get_msa()[0] == [["ACGT", "A-GT"]]
assert "digraph" in b.get_graphs()[0].serialize_to_dot()
for kernel in ("diag", "row"):
    al = create_aligner(300, 300, 2, algorithm="banded-escalate",
                        device="cpu", kernel=kernel)
    al.add_alignment("ACGT" * 50, "ACGT" * 48)
    assert al.get_alignments()[0].edit_distance == 8
bad = sorted(n for n in sys.modules
             if n in ("jax", "claragenomicsanalysis_tpu")
             or n.startswith(("jax.", "claragenomicsanalysis_tpu.")))
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", NO_JAX_PROBE, DATA], check=True,
                   env=env, cwd=ROOT, timeout=300)


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_aligner.create_aligner(16, 16, 1, device="cuda")


def long_and_short_pairs(seed: int) -> list[tuple[str, str]]:
    """mixed_pairs plus pairs whose query splits two Hirschberg levels
    deep, repeats and a pair far beyond the configured band."""
    rng = np.random.default_rng(seed)
    pairs = mixed_pairs(seed)
    for _ in range(3):
        a = generate_random_genome(int(rng.integers(70, MAX_LEN + 1)), rng)
        pairs.append((a, mutate_sequence(a, 9, rng)[:MAX_LEN]))
    pairs += [("AC" * 45, "AC" * 40), ("", "ACGT"), ("", ""),
              ("ACGT" * 24, "TT")]
    return pairs


@pytest.mark.parametrize("algorithm",
                         ["myers", "hirschberg-myers", "banded-escalate"])
def test_algorithms_match_jax_aligner(algorithm):
    """Statuses, distances, paths and CIGARs equal the JAX Aligner's (XLA
    kind), the overlong pair included."""
    pairs = long_and_short_pairs(25)
    jax_al = jax_create_aligner(MAX_LEN, MAX_LEN, len(pairs), band_radius=P,
                                algorithm=algorithm, backend="xla")
    port_al = port_aligner.create_aligner(MAX_LEN, MAX_LEN, len(pairs),
                                          band_radius=P, algorithm=algorithm,
                                          device="cpu")
    for a, b in pairs:
        assert jax_al.add_alignment(a, b) == port_al.add_alignment(a, b)
    want, got = jax_al.get_alignments(), port_al.get_alignments()
    assert len(got) == len(want) == len(pairs)
    for w, g in zip(want, got):
        assert (g.status, g.edit_distance, g.path) == (
            w.status, w.edit_distance, w.path)
        assert g.convert_to_cigar() == w.convert_to_cigar()
    statuses = [g.status for g in got]
    assert statuses.count(StatusType.EXCEEDED_MAX_LENGTH) == 1
    assert statuses.count(StatusType.SUCCESS) == len(got) - 1


@pytest.mark.parametrize("algorithm", ["myers", "hirschberg-myers"])
def test_cli_algorithms_equal_jax_cli(algorithm):
    from claragenomicsanalysis_tpu import cli as jax_cli
    files = [f"{DATA}/sample_queries.fasta", f"{DATA}/sample_targets.fasta"]
    outs = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["align", *files, "--algorithm", algorithm,
                         "--print-alignments", *extra]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) > 24


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        port_aligner.create_aligner(16, 16, 1, algorithm="smith-waterman",
                                    device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", port_aligner.ALGORITHMS)
def test_aligner_on_card_matches_cpu(cuda_device, algorithm):
    pairs = long_and_short_pairs(24)
    results = []
    for device in (cuda_device, "cpu"):
        al = port_aligner.create_aligner(MAX_LEN, MAX_LEN, len(pairs),
                                         band_radius=P, algorithm=algorithm,
                                         device=device)
        for a, b in pairs:
            al.add_alignment(a, b)
        results.append([(r.status, r.edit_distance, r.path)
                        for r in al.get_alignments()])
    assert results[0] == results[1]
