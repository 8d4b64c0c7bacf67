"""The port's overlap -> CIGAR pipeline (claragenomicsanalysis_tpu_torch/
models/pipeline.py, ``cli pipeline``) on the CPU: the golden byte for byte,
its CIGARs against their spans and against the list route's, batching, the
length filter and the span buckets against the JAX package's expression.
The ``cuda`` twin of the golden skips without a card."""

import contextlib
import io
import os
import re
from dataclasses import replace

import pytest
import torch

from claragenomicsanalysis_tpu_torch import cli
from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                         MapperConfig,
                                                         PipelineConfig)
from claragenomicsanalysis_tpu_torch.core.status import StatusType
from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                      FastaSequence)
from claragenomicsanalysis_tpu_torch.models import pipeline
from claragenomicsanalysis_tpu_torch.models.aligner import create_aligner
from claragenomicsanalysis_tpu_torch.models.correct import correct_reads
from claragenomicsanalysis_tpu_torch.models.mapper import map_all_vs_all
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.utils.cigar import path_to_cigar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
MAP_ARGS = ["-k", "15", "-w", "5", "--min-overlap-len", "100",
            "--min-overlap-fraction", "0.3", "--min-bases-per-residue", "500"]
#: MAP_ARGS as a PipelineConfig (the golden's settings)
CFG = PipelineConfig(mapper=MapperConfig(
    kmer_size=15, window_size=5, min_overlap_len=100,
    min_overlap_fraction=0.3, min_bases_per_residue=500))


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


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def cpu_paf():
    return _cli(["pipeline", f"{DATA}/sample_reads.fasta", *MAP_ARGS,
                 "--band-radius", "256", "--device", "cpu"])


def test_cli_pipeline_cpu_equals_golden(cpu_paf):
    assert cpu_paf == _golden("sample_pipeline.paf")


def test_cli_pipeline_cigars_consume_their_spans(cpu_paf):
    """Every row has a cg:Z whose M/I ops consume exactly its query span
    and M/D ops its target span."""
    lines = cpu_paf.splitlines()
    assert lines
    for line in lines:
        cols = line.split("\t")
        cg = [c for c in cols if c.startswith("cg:Z:")]
        assert len(cg) == 1, line
        qc = tc = 0
        for num, op in re.findall(r"(\d+)([MID])", cg[0][5:]):
            qc += int(num) * (op in "MI")
            tc += int(num) * (op in "MD")
        assert (qc, tc) == (int(cols[3]) - int(cols[2]),
                            int(cols[8]) - int(cols[7])), line


#: the small run's mapper settings (k = 11 for 200-base reads)
SMALL = PipelineConfig(mapper=MapperConfig(
    kmer_size=11, window_size=5, min_overlap_len=50, min_overlap_fraction=0.2,
    min_bases_per_residue=500))


@pytest.fixture(scope="module")
def small_parser():
    """6 noisy reads of about 200 bases from a 600-base genome: 14
    overlaps on both strands, in the span buckets 128 and 256."""
    genome = PoissonGenomeSimulator(seed=11).build_reference(600)
    reads = NoisyReadSimulator(seed=11, error_rate=0.04).generate_reads(
        genome, 6, 200)
    return FastaParser("<mem>", records=[FastaSequence(r.name, r.seq)
                                         for r in reads])


@pytest.fixture(scope="module")
def small_run(small_parser):
    res = pipeline.run_pipeline(small_parser, SMALL, device="cpu")
    assert {o.relative_strand for o in res.overlaps} == {"+", "-"}
    return res


#: the mixed run's mapper settings
MIXED = MapperConfig(kmer_size=11, window_size=5, min_overlap_len=50,
                     min_overlap_fraction=0.2, min_bases_per_residue=500)


@pytest.fixture(scope="module")
def mixed_parser():
    """Three reads of 2,500 bases, whose overlaps pad past 2,048 and go to
    Hirschberg, and five of 400, whose overlaps stay banded."""
    genome = PoissonGenomeSimulator(seed=5).build_reference(2800)
    sim = NoisyReadSimulator(seed=5, error_rate=0.04)
    reads = (sim.generate_reads(genome, 3, 2500, "long")
             + sim.generate_reads(genome, 5, 400, "short"))
    return FastaParser("<mem>", records=[FastaSequence(r.name, r.seq)
                                         for r in reads])


def test_cigars_made_on_the_device_equal_the_list_route(mixed_parser):
    """Every overlap's CIGAR, from the paths kept packed on the device, is
    path_to_cigar of get_alignments()' path; the counters name the paths,
    segments (a leaf each past Hirschberg) and bytes the kernel wrote."""
    with profiling.stage_times() as st:
        res = pipeline.run_pipeline(mixed_parser, PipelineConfig(
            mapper=MIXED), device="cpu")
    spans = pipeline.overlap_spans(res.overlaps, mixed_parser)
    buckets = pipeline.span_buckets(spans)
    want, n_fail = [""] * len(spans), 0
    for blen, idxs in buckets.items():
        al = create_aligner(blen, blen, len(idxs),
                            band_radius=min(256, blen), algorithm="myers",
                            device="cpu")
        for i in idxs:
            al.add_alignment(*spans[i])
        for i, a in zip(idxs, al.get_alignments()):
            if a.status == StatusType.SUCCESS:
                want[i] = path_to_cigar(a.path)
            else:
                n_fail += 1
    assert max(buckets) > 2048 and min(buckets) <= 512
    assert [o.cigar for o in res.overlaps] == want
    assert (res.n_aligned, res.n_align_failed) == (len(spans) - n_fail,
                                                   n_fail)
    c = st.counters
    assert 0 < c["hirschberg.pairs"] < res.n_aligned
    assert c["cigar.paths"] == res.n_aligned
    assert c["cigar.segments"] > c["cigar.paths"]
    assert c["cigar.bytes"] == sum(len(o.cigar) + 1 for o in res.overlaps
                                   ) - n_fail
    assert "tb.unpack" not in st.calls


def test_correct_makes_no_cigars(mixed_parser):
    """cli correct reads its paths as code lists: the CIGAR kernel never
    runs, while its Hirschberg and banded paths are unpacked."""
    with profiling.stage_times() as st:
        correct_reads(mixed_parser, CorrectConfig(mapper=MIXED,
                                                  max_support=7),
                      device="cpu")
    assert st.counters.get("cigar.paths", 0) == 0
    assert st.counters["hirschberg.pairs"] > 0
    assert "tb.unpack" in st.calls


@pytest.mark.parametrize("batch_size", [1, 7])
def test_batch_size_keeps_rows(small_parser, small_run, batch_size):
    """Chunks of 1 or 7 spans a launch give the rows of one chunk (2048)."""
    assert small_run.n_aligned > 7 and small_run.n_align_failed == 0
    res = pipeline.run_pipeline(small_parser, SMALL, batch_size=batch_size,
                                device="cpu")
    assert res.paf_rows == small_run.paf_rows
    assert (res.n_aligned, res.n_align_failed) == (small_run.n_aligned, 0)


def test_max_alignment_length_filter_at_its_edge(small_parser, small_run,
                                                 monkeypatch):
    """Overlaps whose longer span equals max_alignment_length are kept and
    aligned; one base lower drops them and only them."""
    spans = [max(o.query_end_position_in_read
                 - o.query_start_position_in_read,
                 o.target_end_position_in_read
                 - o.target_start_position_in_read)
             for o in small_run.overlaps]
    edge = sorted(set(spans))[len(set(spans)) // 2]
    want = {True: [r for r, s in zip(small_run.paf_rows, spans) if s <= edge],
            False: [r for r, s in zip(small_run.paf_rows, spans)
                    if s <= edge - 1]}
    assert len(want[False]) < len(want[True]) < len(spans)
    # the map result is the same both times; align only what is kept
    mapped = map_all_vs_all(small_parser, SMALL.mapper, device="cpu")
    monkeypatch.setattr(pipeline, "map_all_vs_all",
                        lambda *a, **k: replace(mapped, overlaps=[
                            replace(o) for o in mapped.overlaps]))
    for at_edge, limit in ((True, edge), (False, edge - 1)):
        res = pipeline.run_pipeline(
            small_parser, replace(SMALL, max_alignment_length=limit),
            device="cpu")
        assert res.paf_rows == want[at_edge]


def _jax_bucket(q_len, t_len):
    # models/pipeline.py:62 and models/correct.py:96 of the JAX package
    return max(64, 1 << (max(q_len, t_len, 1) - 1).bit_length())


def test_span_bucket_equals_jax_expression():
    for n in range(0, 70_001):
        for q, t in ((n, 0), (0, n), (n, n // 3), (n // 2, n)):
            assert pipeline.span_bucket(q, t) == _jax_bucket(q, t), (q, t)
    spans = [("A" * a, "C" * b) for a, b in ((0, 0), (64, 1), (65, 3),
                                             (5, 512), (513, 2), (70, 60))]
    assert pipeline.span_buckets(spans) == {64: [0, 1], 128: [2, 5],
                                            512: [3], 1024: [4]}


def test_run_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parser = FastaParser("<mem>", records=[FastaSequence("a", "ACGT" * 40)])
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run_pipeline(parser, CFG)


@pytest.mark.cuda
def test_cli_pipeline_cuda_equals_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cli pipeline --device cuda")
    out = _cli(["pipeline", f"{DATA}/sample_reads.fasta", *MAP_ARGS,
                "--band-radius", "256", "--device", "cuda"])
    assert out == _golden("sample_pipeline.paf")
