"""The port's resumable all-vs-all map (claragenomicsanalysis_tpu_torch/
parallel/manifest.py), ``cli simulate`` / ``cli evaluate`` and the CLI's
global flags on the CPU: the resumable map against ``map_all_vs_all`` and
the JAX package's reader of the same work directory, simulate and evaluate
byte for byte against the JAX CLI (both are pure Python), ``--profile-dir``
and the exit status on a closed pipe."""

import json
import logging
import os
import subprocess
import sys

import pytest
import torch

from claragenomicsanalysis_tpu import cli as jax_cli
from claragenomicsanalysis_tpu.core.config import MapperConfig as JaxCfg
from claragenomicsanalysis_tpu.io.fasta import FastaParser as JaxParser
from claragenomicsanalysis_tpu.io.fasta import FastaSequence as JaxSeq
from claragenomicsanalysis_tpu.parallel import manifest as jax_manifest
from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                      FastaSequence)
from claragenomicsanalysis_tpu_torch.models import mapper
from claragenomicsanalysis_tpu_torch.parallel import manifest
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
CFG = dict(min_overlap_fraction=0.8, min_residues=3)
#: index budgets (MB of bases) that cut the 48 kb of reads into 1 and 4
#: chunks
BUDGETS = {1: 30, 4: 0.012}


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
def reads():
    """32 noisy reads of about 1.5 kb, both strands, from a 12 kb genome."""
    genome = PoissonGenomeSimulator(seed=3).build_reference(12_000)
    rs = NoisyReadSimulator(seed=3, error_rate=0.05).generate_reads(
        genome, 32, 1500)
    return [(r.name, r.seq) for r in rs]


@pytest.fixture(scope="module")
def parser(reads):
    return FastaParser("<mem>", records=[FastaSequence(*r) for r in reads])


def _cfg(n_chunks):
    return MapperConfig(index_size_mb=BUDGETS[n_chunks], **CFG)


def _dicts(overlaps):
    return [vars(o) for o in overlaps]


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_resumable_equals_map_all_vs_all(parser, tmp_path, n_chunks):
    cfg = _cfg(n_chunks)
    assert len(parser.get_chunks(cfg.index_size_mb * 1_000_000)) == n_chunks
    want = mapper.map_all_vs_all(parser, cfg, device="cpu").overlaps
    assert len(want) > 0
    got, computed, skipped = manifest.map_all_vs_all_resumable(
        parser, cfg, str(tmp_path), device="cpu")
    assert _dicts(got) == _dicts(want)
    assert (computed, skipped) == (n_chunks ** 2, 0)
    with open(tmp_path / "manifest.json") as f:
        assert len(json.load(f)) == n_chunks ** 2
    # a second call finds every pair done and computes nothing
    again, computed, skipped = manifest.map_all_vs_all_resumable(
        parser, cfg, str(tmp_path), device="cpu")
    assert _dicts(again) == _dicts(want)
    assert (computed, skipped) == (0, n_chunks ** 2)


def test_resume_after_failure_and_jax_reads_the_work_dir(reads, parser,
                                                         tmp_path):
    """A run stopped after one pair resumes to the uninterrupted overlaps;
    the JAX package's reader of the finished directory returns the same
    overlaps without computing a pair; write_merged_paf writes the JAX
    package's PAF."""
    cfg = _cfg(4)
    want = mapper.map_all_vs_all(parser, cfg, device="cpu").overlaps
    work = str(tmp_path / "map")
    with pytest.raises(RuntimeError, match="injected failure"):
        manifest.map_all_vs_all_resumable(parser, cfg, work,
                                          fail_after_pairs=1, device="cpu")
    got, computed, skipped = manifest.map_all_vs_all_resumable(
        parser, cfg, work, device="cpu")
    assert (computed, skipped) == (15, 1)
    assert _dicts(got) == _dicts(want)
    # the first pair's reads start at 0, the others' not: global read ids
    assert {o.query_read_id for o in got} == set(range(len(reads)))

    jp = JaxParser("<mem>", records=[JaxSeq(*r) for r in reads])
    theirs, computed, skipped = jax_manifest.map_all_vs_all_resumable(
        jp, JaxCfg(index_size_mb=BUDGETS[4], **CFG), work)
    assert (computed, skipped) == (0, 16)
    assert _dicts(theirs) == _dicts(got)
    manifest.write_merged_paf(got, parser, str(tmp_path / "ours.paf"))
    jax_manifest.write_merged_paf(theirs, jp, str(tmp_path / "theirs.paf"))
    assert (tmp_path / "ours.paf").read_bytes() == \
        (tmp_path / "theirs.paf").read_bytes()


def test_resumable_defaults_to_the_card(parser, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        manifest.map_all_vs_all_resumable(parser, _cfg(1), str(tmp_path))


# ------------------------------------------------------ simulate, evaluate

def _both_clis(argv, capsys, tmp_path, outputs=()):
    """argv through the JAX CLI and the port's: (their stdout, ours), and
    each named output file's bytes from both runs (``{name}`` in argv
    stands for the file's path)."""
    res = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        files = {k: str(tmp_path / f"{tag}_{k}") for k in outputs}
        assert main([a.format(**files) for a in argv]) == 0
        res.append((capsys.readouterr().out,
                    {k: open(p, "rb").read() for k, p in files.items()}))
    return res


@pytest.mark.parametrize("argv", [
    ["simulate", "--genome-length", "3000", "--seed", "4"],
    ["simulate", "--genome-length", "5000", "--reads", "12",
     "--read-length", "900", "--error-rate", "0.08", "--seed", "9",
     "--markov", "--truth-out", "{truth}", "--reference-out", "{ref}"],
])
def test_cli_simulate_equals_jax(argv, capsys, tmp_path):
    outputs = ("truth", "ref") if "--reads" in argv else ()
    (theirs, tfiles), (ours, ofiles) = _both_clis(argv, capsys, tmp_path,
                                                  outputs)
    assert ours == theirs and ours.startswith(">")
    assert ofiles == tfiles
    if outputs:
        assert ours.count(">") == 12 and tfiles["truth"].count(b"\n") == 12


def test_cli_evaluate_equals_jax(capsys, tmp_path):
    """Reads simulated with their truth, mapped by the port's ``cli map``;
    ``cli evaluate`` prints the JAX CLI's metrics."""
    fa, truth = tmp_path / "reads.fa", tmp_path / "truth.tsv"
    assert cli.main(["--log-level", "WARNING", "simulate", "--genome-length",
                     "20000", "--reads", "40", "--read-length", "1500",
                     "--seed", "2", "--truth-out", str(truth)]) == 0
    assert logging.getLogger(
        "claragenomicsanalysis_tpu_torch").level == logging.WARNING
    fa.write_text(capsys.readouterr().out)
    assert cli.main(["map", str(fa), "-k", "15", "-w", "5",
                     "--min-overlap-fraction", "0.3", "--device", "cpu"]) == 0
    paf = tmp_path / "reads.paf"
    paf.write_text(capsys.readouterr().out)
    argv = ["evaluate", str(truth), str(paf), "--min-overlap-bases", "300"]
    (theirs, _), (ours, _) = _both_clis(argv, capsys, tmp_path)
    assert ours == theirs
    metrics = json.loads(ours)
    assert 0 < metrics["found_true_pairs"] <= metrics["reported_pairs"]
    assert 0 < metrics["recall"] <= 1 and 0 < metrics["precision"] <= 1


# -------------------------------------------------------- the global flags

def test_profile_dir_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "prof"
    assert cli.main(["--profile-dir", str(out), "map",
                     f"{DATA}/sample_reads.fasta", "--device", "cpu"]) == 0
    assert capsys.readouterr().out
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"mapper.sketch", "mapper.match", "mapper.chain"} <= names


def test_closed_pipe_exits_141():
    """``cli simulate ... | head -1``: the reader leaves after one line and
    the CLI exits 141 (128 + SIGPIPE) with nothing on stderr."""
    p = subprocess.Popen(
        [sys.executable, "-m", "claragenomicsanalysis_tpu_torch.cli",
         "simulate", "--genome-length", "400000", "--reads", "200",
         "--read-length", "3000"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.stdout.readline().startswith(b">read_0")
    p.stdout.close()
    err = p.stderr.read()
    assert p.wait(timeout=120) == 141, err
    assert err == b""
