"""The port's POA batch and ``cli poa`` (claragenomicsanalysis_tpu_torch)
against the JAX package's ``create_batch(..., backend="xla")``, its one-kernel
POA in interpret mode, its CLI, ``cpu.poa_oracle`` and the consensus and MSA
goldens.  Integer outputs and strings, compared exactly (tolerance 0)."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu import cli as jax_cli
from claragenomicsanalysis_tpu.core.config import BatchSize as JaxBatchSize
from claragenomicsanalysis_tpu.models.poa import Batch as JaxBatch
from claragenomicsanalysis_tpu.core.status import StatusType as JaxStatus
from claragenomicsanalysis_tpu.models.poa import create_batch as jax_batch
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.core.config import BatchSize
from claragenomicsanalysis_tpu_torch.core.status import (OutputType,
                                                         StatusType)
from claragenomicsanalysis_tpu_torch.models import poa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")

#: the three shapes of tests/test_torch_poa_ops.py: (BatchSize keywords,
#: banded, edits per support)
SHAPES = {
    "small": (dict(max_sequence_size=48, max_sequences_per_poa=4,
                   max_pred_per_node=4, max_aligned_per_node=4,
                   max_nodes_per_window=96), False, 4),
    "banded": (dict(max_sequence_size=48, max_sequences_per_poa=4,
                    max_pred_per_node=4, max_aligned_per_node=4,
                    max_nodes_per_window=96, band_width=16), True, 6),
    "overflow": (dict(max_sequence_size=32, max_sequences_per_poa=6,
                      max_pred_per_node=2, max_aligned_per_node=2,
                      max_nodes_per_window=40), False, 8),
}


def windows_for(name: str, seed: int = 0) -> list[list[str]]:
    """Seeded pileups plus the edge windows: too many sequences, a
    sequence over max_sequence_size, no sequence, an empty first sequence,
    one sequence, and N bases."""
    kw, _, n_mut = SHAPES[name]
    L, S = kw["max_sequence_size"], kw["max_sequences_per_poa"]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        base = generate_random_genome(L - 8, rng)
        out.append([mutate_sequence(base, n_mut, rng)[:L] for _ in range(S)])
    out[2][1] = out[2][1][:5] + "NNN" + out[2][1][8:]
    base = generate_random_genome(L - 8, rng)
    out += [[base] * (S + 1), [base, base + "A" * 20], [],
            ["", base, base], [base], out[0][:2]]
    return out


MSA = OutputType.CONSENSUS | OutputType.MSA


def port_batch(name: str, windows, device="cpu", **kw_batch):
    kw, banded, _ = SHAPES[name]
    b = poa.create_batch(BatchSize(**kw), max_poas=len(windows),
                         banded_alignment=banded, device=device, **kw_batch)
    return b, [b.add_poa_group(w) for w in windows]


def jax_ref_batch(name: str, windows, **kw_batch):
    kw, banded, _ = SHAPES[name]
    b = jax_batch(JaxBatchSize(**kw), max_poas=len(windows),
                  banded_alignment=banded, backend="xla", **kw_batch)
    return b, [b.add_poa_group(w) for w in windows]


def run_port(name: str, windows, device="cpu", **kw_batch):
    b, stats = port_batch(name, windows, device, **kw_batch)
    return stats, b.get_consensus()


def run_jax(name: str, windows):
    b, stats = jax_ref_batch(name, windows)
    return stats, b.get_consensus()


def as_ints(result):
    stats, (cons, covs, st) = result
    return [int(s) for s in stats], (cons, covs, [int(s) for s in st])


@pytest.mark.parametrize("name", list(SHAPES))
def test_batch_matches_jax_batch(name):
    """Consensus strings, coverages and statuses equal the JAX batch's,
    host-refused, overflowed and band-failed windows included."""
    windows = windows_for(name)
    got = as_ints(run_port(name, windows))
    want = as_ints(run_jax(name, windows))
    assert got == want
    statuses = set(got[1][2])
    assert {int(StatusType.SUCCESS),
            int(StatusType.EXCEEDED_MAXIMUM_SEQUENCES_PER_POA),
            int(StatusType.EXCEEDED_MAXIMUM_SEQUENCE_SIZE),
            int(StatusType.EXCEEDED_BAND_WIDTH)} <= statuses
    if name == "overflow":
        assert int(JaxStatus.NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE) in \
            statuses or int(JaxStatus.EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE) \
            in statuses


def test_launch_chunks_never_change_a_result(monkeypatch):
    bs = BatchSize(**SHAPES["small"][0])
    windows = windows_for("small", seed=5)
    want = run_port("small", windows)
    monkeypatch.setattr(poa, "POA_MEM_BUDGET", 3 * poa.window_bytes(bs))
    chunks = poa.launch_chunks(len(windows), bs)
    assert [len(c) for c in chunks] == [3, 3, 3, 3]
    assert [i for c in chunks for i in c] == list(range(len(windows)))
    assert run_port("small", windows) == want
    monkeypatch.setattr(poa, "POA_MEM_BUDGET", 1)
    assert len(poa.launch_chunks(len(windows), bs)) == len(windows)


def test_window_bytes_counts_the_score_plane():
    bs = BatchSize(max_sequence_size=256, max_nodes_per_window=384,
                   max_sequences_per_poa=8, max_pred_per_node=8,
                   max_aligned_per_node=4)
    assert 385 * 257 * 4 == 395_780 < poa.window_bytes(bs) < 500_000
    # the correction shape's 4,096 windows need more than one launch
    assert len(poa.launch_chunks(4096, bs)) == 2
    # the MSA adds the two states' paths (S x L) and the rows (S x N)
    assert poa.window_bytes(bs, msa=True) - poa.window_bytes(bs) == \
        4 * (2 * 8 * 256 + 8 * 384)
    assert len(poa.launch_chunks(4096, bs, msa=True)[0]) < \
        len(poa.launch_chunks(4096, bs)[0])


def test_batch_api_surface():
    b = poa.create_batch(BatchSize(**SHAPES["small"][0]), max_poas=2,
                         device="cpu", gap_score=-4)
    assert b.scores.gap_score == -4 and b.scores.match_score == 8
    assert b.get_consensus() == ([], [], [])
    assert b.add_poa_group(["ACGT", "ACGT"]) == StatusType.SUCCESS
    assert b.add_poa_group(["ACGT"]) == StatusType.SUCCESS
    assert b.add_poa_group(["ACGT"]) == StatusType.EXCEEDED_MAXIMUM_POAS
    assert b.get_total_poas() == 2
    assert b.get_consensus()[0] == ["ACGT", "ACGT"]
    assert b.get_msa() == ([[], []],
                           [StatusType.OUTPUT_TYPE_UNAVAILABLE] * 2)
    assert [g.serialize_to_dot().count("->") for g in b.get_graphs()] == \
        [3, 3]
    b.reset()
    assert b.get_total_poas() == 0 and b.get_graphs() == []
    for kernel in poa.KERNELS:
        m = poa.create_batch(BatchSize(**SHAPES["small"][0]), max_poas=2,
                             output_mask=MSA, device="cpu", kernel=kernel)
        assert m.kernel == kernel and m.get_msa() == ([], [])
        m.add_poa_group(["ACGT", "AGT"])
        assert m.get_msa() == ([["ACGT", "A-GT"]], [StatusType.SUCCESS])
    with pytest.raises(ValueError, match="kernel"):
        poa.create_batch(device="cpu", kernel="auto")
    # the JAX Batch's whole surface but its mesh
    public = {n for n in vars(JaxBatch) if not n.startswith("_")}
    assert public <= {n for n in vars(poa.Batch) if not n.startswith("_")}
    assert {"add_poa_group", "generate_poa", "get_consensus", "get_msa",
            "get_graphs", "get_total_poas", "batch_id", "reset"} <= public
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            poa.create_batch(device="cuda")


def run_cli(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_poa_golden_on_cpu():
    rc, out = run_cli(cli.main, ["poa", f"{DATA}/sample-windows.txt",
                                 "--device", "cpu"])
    with open(os.path.join(DATA, "golden", "sample_consensus.txt")) as f:
        assert (rc, out) == (0, f.read())


def test_cli_poa_banded_equals_jax_cli():
    argv = ["poa", f"{DATA}/sample-windows.txt", "--banded",
            "--max-windows", "8"]
    rc, out = run_cli(cli.main, argv + ["--device", "cpu"])
    assert (rc, out) == run_cli(jax_cli.main, argv)
    assert len(out.splitlines()) == 8


def test_cli_poa_msa_golden_on_cpu():
    rc, out = run_cli(cli.main, ["poa", f"{DATA}/sample-windows.txt", "--msa",
                                 "--device", "cpu"])
    with open(os.path.join(DATA, "golden", "sample_msa.txt")) as f:
        assert (rc, out) == (0, f.read())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_batch_on_card_equals_cpu(name):
    """The kernels' Batch on the card gives the CPU plain path's consensus,
    coverage and statuses, on every edge window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    windows = windows_for(name)
    assert run_port(name, windows, "cuda") == run_port(name, windows, "cpu")
