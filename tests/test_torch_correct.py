"""The port's read correction (claragenomicsanalysis_tpu_torch/models/
correct.py, ``cli correct``) on the CPU: the golden byte for byte (with
``--timings``), the host stages against the JAX package's functions (no
JAX compile: they are NumPy), batching and both POA routes, resume, and
``write_fasta``.  The ``cuda`` twins skip without a card."""

import contextlib
import io
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core import config as jax_config
from claragenomicsanalysis_tpu.core import types as jax_types
from claragenomicsanalysis_tpu.io import fasta as jax_fasta
from claragenomicsanalysis_tpu.models import correct as jax_correct
from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                         MapperConfig)
from claragenomicsanalysis_tpu_torch.core.status import StatusType
from claragenomicsanalysis_tpu_torch.core.types import Overlap
from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                      FastaSequence,
                                                      create_fasta_parser)
from claragenomicsanalysis_tpu_torch.models import correct
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
MAP_ARGS = ["-k", "15", "-w", "5", "--min-overlap-len", "100",
            "--min-overlap-fraction", "0.3", "--min-bases-per-residue", "500"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these small shapes run on one thread: pytest-
    xdist runs several test processes at once, and torch's default pool of
    a thread a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name) -> str:
    with open(os.path.join(DATA, "golden", name)) as f:
        return f.read()


def test_cli_correct_cpu_equals_golden_with_timings(capsys):
    """``cli --timings correct --device cpu`` prints the golden on stdout
    and, last on stderr, each stage's host seconds and entries as JSON in
    the JAX package's stage_timings() layout."""
    assert cli.main(["--timings", "correct", f"{DATA}/sample_reads.fasta",
                     *MAP_ARGS, "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out == _golden("sample_corrected.fasta")
    timings = json.loads(err.strip().splitlines()[-1])
    assert {"correct.map", "correct.align", "correct.windows",
            "correct.poa"} <= set(timings)
    for v in timings.values():
        assert set(v) == {"total_s", "count"}
        assert v["total_s"] >= 0 and v["count"] >= 1
    assert timings["correct.map"]["count"] == 1


# ----------------------------------------------- host stages against JAX

def _random_path(rng, n: int, lead: int, tail: int) -> list[int]:
    """n columns of AlignmentState codes (0 match, 1 mismatch, 2
    insertion, 3 deletion) with an I/D run of ``lead`` and ``tail``
    columns at its ends."""
    mid = rng.choice(4, size=n, p=[0.8, 0.08, 0.06, 0.06]).tolist()
    ends = [int(rng.integers(2, 4))] * lead, [int(rng.integers(2, 4))] * tail
    return ends[0] + mid + ends[1]


def _both(cls_ours, cls_theirs, *args):
    return cls_ours(*args), cls_theirs(*args)


@pytest.fixture(scope="module")
def host_cases():
    """Random reads and overlaps with paths on both strands, empty paths,
    I/D runs at the ends, windows past the read end and deletion runs that
    stretch a segment over 2W: (port parser, JAX parser, read, [(port
    overlap, JAX overlap, path)])."""
    rng = np.random.default_rng(5)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, n))
            for n in (700, 900, 650, 800)]
    recs = [(f"r{i}", s) for i, s in enumerate(seqs)]
    port_p = FastaParser("<mem>", records=[FastaSequence(*r) for r in recs])
    jax_p = jax_fasta.FastaParser("<mem>", records=[
        jax_fasta.FastaSequence(*r) for r in recs])
    cases = []
    for k in range(40):
        tid = 1 + k % 3
        strand = "+-"[k % 2]
        if k % 10 == 9:
            path = []
        elif k % 10 == 7:          # a deletion run wider than 2W = 64
            path = [0] * 20 + [3] * 90 + [0] * 30
        else:
            path = _random_path(rng, int(rng.integers(1, 220)),
                                int(rng.integers(0, 6)),
                                int(rng.integers(0, 6)))
        qn = sum(c != 3 for c in path)
        tn = sum(c != 2 for c in path)
        qs = int(rng.integers(0, 700 - qn + 60))   # may pass the read end
        ts = int(rng.integers(0, len(seqs[tid]) - tn + 1))
        args = (0, tid, qs, qs + qn, ts, ts + tn, 5, strand)
        o, jo = _both(Overlap, jax_types.Overlap, *args)
        cases.append((o, jo, path))
    return port_p, jax_p, seqs[0], cases


def test_matched_pairs_equal_jax(host_cases):
    for o, jo, path in host_cases[3]:
        ours, theirs = (correct._matched_pairs(path, o),
                        jax_correct._matched_pairs(path, jo))
        for a, b in zip(ours, theirs, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if path:
            n = sum(c <= 1 for c in path)
            assert len(ours[0]) == n


@pytest.mark.parametrize("window,max_support,min_matched",
                         [(32, 7, 8), (32, 2, 8), (64, 15, 1), (100, 3, 20)])
def test_window_supports_equal_jax(host_cases, window, max_support,
                                   min_matched):
    """Both strands, empty paths, the max_support cap, segments over 2W and
    windows past the read end (the read is cut short of its overlaps)."""
    port_p, jax_p, read, cases = host_cases
    kw = dict(window_length=window, max_support=max_support,
              min_matched_bases=min_matched)
    cfg, jcfg = CorrectConfig(**kw), jax_config.CorrectConfig(**kw)
    for cut in (len(read), 500):
        overlaps = [c[0] for c in cases]
        ours = correct._window_supports(
            read[:cut], overlaps,
            correct._columns(overlaps, [c[2] for c in cases]), port_p, cfg)
        theirs = jax_correct._window_supports(
            read[:cut], [c[1] for c in cases], [c[2] for c in cases],
            jax_p, jcfg)
        assert ours == theirs
        assert len(ours) == -(-cut // window)
        most = max(map(len, ours))
        assert most <= max_support and (most == max_support
                                        or max_support > 3)


def test_polish_batch_size_equals_jax():
    for window in (32, 100, 128, 500):
        for max_support in (2, 7, 15):
            cfg = CorrectConfig(window_length=window, max_support=max_support)
            jcfg = jax_config.CorrectConfig(window_length=window,
                                            max_support=max_support)
            for depth in (1, 2, 3, 4, 5, 8, 9, 16, 31):
                assert vars(correct._polish_batch_size(cfg, depth)) == vars(
                    jax_correct._polish_batch_size(jcfg, depth))
    for n in range(1, 40):
        for ms in (1, 3, 7, 15, 31):
            want = min(max(4, 1 << (n - 1).bit_length()), ms + 1)
            assert correct.depth_bucket(n, ms) == want


# ----------------------------------------------------------- polish stage

def _mutate(rng, s: str, n: int) -> str:
    s = list(s)
    for _ in range(n):
        s[int(rng.integers(0, len(s)))] = "ACGT"[int(rng.integers(0, 4))]
    return "".join(s)


#: the polish jobs' config: short windows keep the plain versions quick
POLISH = CorrectConfig(window_length=32, max_support=7)


@pytest.fixture(scope="module")
def jobs():
    """Pileups of depth 2-8 (the 4- and 8-deep buckets) over 30-base
    backbones, and one whose support passes max_sequence_size (its POA
    fails on the host: the backbone is kept)."""
    rng = np.random.default_rng(7)
    out = []
    for depth in (2, 3, 5, 8, 4, 8, 2):
        bb = "".join("ACGT"[c] for c in rng.integers(0, 4, 30))
        out.append([bb] + [_mutate(rng, bb, 3) for _ in range(depth - 1)])
    out.insert(3, [out[0][0], "A" * 65, out[0][1]])
    return out


@pytest.fixture(scope="module")
def polished(jobs):
    cons, n_failed = correct._polish_windows(jobs, POLISH, None, "cpu")
    assert n_failed == 1 and cons[3] == jobs[3][0] and all(cons)
    return cons, n_failed


@pytest.mark.parametrize("windows_per_dispatch", [1, 5])
def test_windows_per_dispatch_keeps_result(jobs, polished,
                                           windows_per_dispatch):
    assert correct._polish_windows(jobs, POLISH, windows_per_dispatch,
                                   "cpu") == polished


def test_window_route_equals_lockstep(jobs, polished):
    """poa_backend "pallas" runs models.poa's kernel="window"; the others
    kernel="lockstep"; both give the same consensus."""
    assert [correct.poa_kernel(replace(POLISH, poa_backend=b))
            for b in ("auto", "xla", "pallas", "pallas2")] == \
        ["lockstep", "lockstep", "window", "lockstep"]
    with pytest.raises(ValueError):
        correct.poa_kernel(replace(POLISH, poa_backend="cuda"))
    assert correct._polish_windows(
        jobs, replace(POLISH, poa_backend="pallas"), None, "cpu") == polished


def test_depth_buckets_equal_one_global_shape(jobs, polished):
    """A window's consensus does not depend on its depth bucket: one batch
    at the max_support + 1 shape gives the same (the JAX package's
    test_polish_depth_buckets_match_global_shape)."""
    bs = correct._polish_batch_size(POLISH, POLISH.max_support + 1)
    batch = correct.create_batch(batch_size=bs, max_poas=len(jobs),
                                 device="cpu")
    for seqs in jobs:
        batch.add_poa_group(seqs)
    cons, _, stats = batch.get_consensus()
    assert [c if st == StatusType.SUCCESS and c else seqs[0]
            for seqs, c, st in zip(jobs, cons, stats)] == polished[0]
    assert polished[1] == sum(st != StatusType.SUCCESS for st in stats)


# ------------------------------------------------------ resume, write_fasta

@pytest.fixture(scope="module")
def small():
    """6 noisy reads of about 200 bases from a 600-base genome, both
    strands, and a config that polishes about half of their 32-base
    windows."""
    genome = PoissonGenomeSimulator(seed=11).build_reference(600)
    reads = NoisyReadSimulator(seed=11, error_rate=0.04).generate_reads(
        genome, 6, 200)
    parser = FastaParser("<mem>", records=[FastaSequence(r.name, r.seq)
                                           for r in reads])
    cfg = CorrectConfig(
        mapper=MapperConfig(kmer_size=11, window_size=5, min_overlap_len=50,
                            min_overlap_fraction=0.2,
                            min_bases_per_residue=500),
        window_length=32, max_support=7)
    res = correct.correct_reads(parser, cfg, device="cpu")
    assert res.n_polished > res.n_windows // 3
    assert res.seqs != [r.seq for r in reads]
    return parser, cfg, res


def test_resume_after_failure_equals_uninterrupted(small, tmp_path):
    parser, cfg, res = small
    work = str(tmp_path / "work")
    with pytest.raises(RuntimeError, match="injected failure"):
        correct.correct_reads(parser, cfg, work_dir=work, part_size=3,
                              fail_after_parts=1, device="cpu")
    with open(os.path.join(work, "correct_manifest.json")) as f:
        assert json.load(f) == {"0": True}
    again = correct.correct_reads(parser, cfg, work_dir=work, part_size=3,
                                  device="cpu")
    assert again == res
    assert sorted(os.listdir(work)) == ["correct_manifest.json",
                                        "corrected_part_0.json",
                                        "corrected_part_1.json", "map"]


def test_write_fasta_round_trips(small, tmp_path):
    _, _, res = small
    path = str(tmp_path / "corrected.fasta")
    correct.write_fasta(res, path)
    back = create_fasta_parser(path)
    assert [(back.get_sequence_by_id(i).name, back.get_sequence_by_id(i).seq)
            for i in range(back.get_num_sequences())] == \
        list(zip(res.names, res.seqs))


def test_correct_reads_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parser = FastaParser("<mem>", records=[FastaSequence("a", "ACGT" * 40)])
    with pytest.raises(RuntimeError, match="CUDA"):
        correct.correct_reads(parser, CorrectConfig())


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cli_correct_cuda_equals_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cli correct --device cuda")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["correct", f"{DATA}/sample_reads.fasta", *MAP_ARGS,
                         "--device", "cuda"]) == 0
    assert buf.getvalue() == _golden("sample_corrected.fasta")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_polish_on_card_equals_cpu(jobs, polished, backend):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the polish kernels")
    cfg = replace(POLISH, poa_backend=backend)
    assert correct._polish_windows(jobs, cfg, None, "cuda") == polished
