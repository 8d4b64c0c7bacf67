"""The port's own copies of the JAX package's framework-free modules
(claragenomicsanalysis_tpu_torch/{core,io,utils}) against the originals."""

import gzip
import os

import numpy as np
import pytest

from claragenomicsanalysis_tpu.core import config as jax_config
from claragenomicsanalysis_tpu.core import status as jax_status
from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.io import fasta as jax_fasta
from claragenomicsanalysis_tpu.io import windows as jax_windows
from claragenomicsanalysis_tpu.utils import genomeutils as jax_genomeutils
from claragenomicsanalysis_tpu.utils import graph as jax_graph
from claragenomicsanalysis_tpu.utils import mathutils as jax_mathutils
from claragenomicsanalysis_tpu_torch.core import config, status
from claragenomicsanalysis_tpu_torch.io import fasta, windows
from claragenomicsanalysis_tpu_torch.ops import banded
from claragenomicsanalysis_tpu_torch.utils import (cigar, genomeutils, graph,
                                                   mathutils)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["StatusType", "AlignmentType",
                                  "AlignmentState", "OutputType"])
def test_enums_equal(name):
    ours, theirs = getattr(status, name), getattr(jax_status, name)
    assert [(m.name, int(m)) for m in ours] == [(m.name, int(m))
                                                for m in theirs]


def test_cigar_maps_equal():
    assert status.CIGAR_OP_COMPACT == jax_status.CIGAR_OP_COMPACT
    assert status.CIGAR_OP_EXTENDED == jax_status.CIGAR_OP_EXTENDED


def test_encode_decode_equal():
    every_byte = bytes(range(256)).decode("latin-1")
    assert genomeutils.encode(every_byte).tolist() == \
        jax_genomeutils.encode(every_byte).tolist()
    assert (genomeutils.BASES, genomeutils.PAD) == (jax_genomeutils.BASES,
                                                    jax_genomeutils.PAD)
    s = "ACGTNacgtRYN"
    assert genomeutils.encode(s, 16).tolist() == \
        jax_genomeutils.encode(s, 16).tolist()
    codes = genomeutils.encode(s, 16)
    assert genomeutils.decode(codes) == jax_genomeutils.decode(codes)
    assert genomeutils.decode(codes, 14) == jax_genomeutils.decode(codes, 14)
    with pytest.raises(ValueError):
        genomeutils.encode("ACGT", 3)


def test_round_up_equal():
    for x in range(0, 40):
        for m in (1, 8, 16, 128):
            assert mathutils.round_up(x, m) == jax_mathutils.round_up(x, m)


def test_aligner_config_and_plan_equal(monkeypatch):
    """The config's padded shapes equal the JAX package's.  The port plans
    its launches by its own traceback layout (ops.banded.launch_chunks, in
    place of the TPU's core.bufferplan): every problem once, in order, and
    each launch of more than one problem within the budget."""
    for lq in (1, 7, 96, 1000, 10001):
        for lt in (1, 8, 300, 10008):
            for r in (0, 8, 63, 64, 200):
                ours = config.AlignerConfig(lq, lt, 1000, r)
                theirs = jax_config.AlignerConfig(lq, lt, 1000, r)
                Lq, Lt = ours.padded_query_length, ours.padded_target_length
                assert (Lq, Lt) == (theirs.padded_query_length,
                                    theirs.padded_target_length)
                per = banded.tb_bytes_per_problem(Lq, Lt, r)
                for budget in (1, 1 << 20, 1 << 28):
                    monkeypatch.setattr(banded, "MEM_BUDGET_PER_DISPATCH",
                                        budget)
                    chunks = banded.launch_chunks(range(1000), Lq, Lt, r)
                    assert np.array_equal(np.concatenate(chunks),
                                          np.arange(1000))
                    assert all(len(c) * per <= budget or len(c) == 1
                               for c in chunks)
                    assert len(chunks) == -(-1000 // max(1, budget // per))


def test_fasta_parser_equal(tmp_path):
    fq = tmp_path / "reads.fq"
    fq.write_text("@r1 desc\nACGT\n+\nIIII\n@r2\nGGNA\n+\nIIII\n")
    fa = tmp_path / "wrapped.fa.gz"
    with gzip.open(fa, "wt") as f:
        f.write(">a x\nACG\r\nTT\n\n>b\n>c\nNNA\n")
    paths = [os.path.join(ROOT, "data", n) for n in
             ("sample_queries.fasta", "sample_targets.fasta")] + [fq, fa]
    for path in paths:
        ours = fasta.create_fasta_parser(path)
        theirs = jax_fasta.FastaParser(str(path))    # pure-Python path
        n = theirs.get_num_sequences()
        assert ours.get_num_sequences() == n > 0
        for i in range(n):
            a, b = ours.get_sequence_by_id(i), theirs.get_sequence_by_id(i)
            assert (a.name, a.seq) == (b.name, b.seq)
    bad = tmp_path / "bad.txt"
    bad.write_text("hello\n")
    with pytest.raises(ValueError):
        fasta.create_fasta_parser(bad)


def test_cigar_and_format_equal():
    rng = np.random.default_rng(8)
    q = "".join(rng.choice(list("ACGT"), 150))
    t = q[:40] + "GG" + q[45:]
    path, _, _ = nw_oracle.align(q, t)
    for extended in (False, True):
        assert cigar.path_to_cigar(path, extended) == \
            nw_oracle.path_to_cigar(path, extended)
    assert cigar.path_to_cigar([]) == ""
    with pytest.raises(ValueError):
        cigar.path_to_cigar([0, 4])
    for width in (80, 33):
        assert cigar.format_alignment(path, q, t, width) == \
            nw_oracle.format_alignment(path, q, t, width)
    qc, tc = genomeutils.encode(q), genomeutils.encode(t)
    assert cigar.format_alignment(path, qc, tc) == \
        nw_oracle.format_alignment(path, qc, tc)


def test_poa_configs_equal():
    """PoaScores and BatchSize: the same defaults, the same derived limits
    (max_consensus_size, max_nodes_per_window) and padded shapes."""
    assert vars(config.PoaScores()) == vars(jax_config.PoaScores())
    for kw in ({}, dict(max_sequence_size=100), dict(max_sequence_size=48,
               max_nodes_per_window=97, max_consensus_size=5),
               dict(max_sequence_size=256, max_nodes_per_window=384,
                    max_sequences_per_poa=8, max_pred_per_node=8,
                    band_width=64)):
        ours, theirs = config.BatchSize(**kw), jax_config.BatchSize(**kw)
        assert vars(ours) == vars(theirs)
        assert (ours.padded_nodes, ours.padded_seq) == (theirs.padded_nodes,
                                                        theirs.padded_seq)
    assert config.BatchSize() == config.BatchSize()      # frozen, hashable
    assert hash(config.BatchSize(max_sequence_size=7)) is not None


def test_read_write_windows_equal(tmp_path):
    path = os.path.join(ROOT, "data", "sample-windows.txt")
    for n in (None, 0, 1, 5):
        assert windows.read_windows(path, n) == \
            jax_windows.read_windows(path, n)
    ws = [["ACGT", "ACG"], ["T"], ["GG", "GA", "G"]]
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    windows.write_windows(ws, str(ours))
    jax_windows.write_windows(ws, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert windows.read_windows(str(ours)) == ws


def test_directed_graph_equal():
    """The same calls give the same nodes, neighbours, weights and DOT text:
    a repeated edge sums its weights, an unlabelled node prints its id."""
    graphs = graph.DirectedGraph(), jax_graph.DirectedGraph()
    for g in graphs:
        g.add_edge(0, 1, 3)
        g.add_edge(0, 1)
        g.add_edge(2, 1, 5)
        g.add_edge(1, 7)
        g.set_node_label(0, "A:2")
        g.set_node_label(7, "T:1")
    ours, theirs = graphs
    assert ours.serialize_to_dot() == theirs.serialize_to_dot()
    assert ours.nodes() == theirs.nodes() == [0, 1, 2, 7]
    for n in ours.nodes() + [9]:
        assert ours.adjacent(n) == theirs.adjacent(n)
    assert ours.edge_weight(0, 1) == theirs.edge_weight(0, 1) == 4
    assert ours.edge_weight(1, 0) == theirs.edge_weight(1, 0) == 0
    assert graph.DirectedGraph().serialize_to_dot() == \
        jax_graph.DirectedGraph().serialize_to_dot()


def _mapper_copy_mapper_config():
    from claragenomicsanalysis_tpu.core.config import MapperConfig as Theirs
    from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
    assert vars(MapperConfig()) == vars(Theirs())
    kw = dict(kmer_size=31, window_size=7, filtering_parameter=0.01,
              min_overlap_fraction=0.3, index_size_mb=3)
    assert vars(MapperConfig(**kw)) == vars(Theirs(**kw))
    for bad in (dict(kmer_size=0), dict(kmer_size=32),
                dict(kmer_size=16, hash_representations=False)):
        for cls in (MapperConfig, Theirs):
            with pytest.raises(ValueError):
                cls(**bad)
    assert MapperConfig(kmer_size=15, hash_representations=False)


def _mapper_copy_types():
    from claragenomicsanalysis_tpu.core import types as theirs
    from claragenomicsanalysis_tpu_torch.core import types as ours
    assert ours.SketchElement(5, 1, 2, 1) == ours.SketchElement(5, 1, 2, 1)
    assert vars(ours.Anchor(1, 2, 3, 4)) == vars(theirs.Anchor(1, 2, 3, 4))
    for strand in "+-":
        a = ours.Overlap(3, 1, 10, 90, 7, 88, 9, strand, "4M")
        b = theirs.Overlap(3, 1, 10, 90, 7, 88, 9, strand, "4M")
        assert vars(a) == vars(b) and a.key() == b.key()


def _mapper_copy_paf(tmp_path):
    from claragenomicsanalysis_tpu.core.types import Overlap as TheirOverlap
    from claragenomicsanalysis_tpu.io import paf as theirs
    from claragenomicsanalysis_tpu_torch.core.types import Overlap
    from claragenomicsanalysis_tpu_torch.io import paf as ours
    for cigar in ("", "10M2I3D"):
        args = (0, 1, 5, 400, 20, 430, 12, "-", cigar)
        row = ours.format_paf_row(Overlap(*args), "q", 500, "t", 600)
        assert row == theirs.format_paf_row(TheirOverlap(*args), "q", 500,
                                            "t", 600)
        ours.write_paf([row, "short\tline"], str(tmp_path / "o.paf"))
        theirs.write_paf([row, "short\tline"], str(tmp_path / "t.paf"))
        assert (tmp_path / "o.paf").read_bytes() == \
            (tmp_path / "t.paf").read_bytes()
        assert ours.read_paf(str(tmp_path / "o.paf")) == \
            theirs.read_paf(str(tmp_path / "t.paf"))


def _mapper_copy_get_chunks(tmp_path):
    path = tmp_path / "r.fa"
    path.write_text("".join(f">r{i}\n{'ACGT' * (i % 7 + 1)}\n"
                            for i in range(40)))
    for min_len, shuffle in ((0, False), (9, False), (0, True), (12, True)):
        ours = fasta.create_fasta_parser(path, min_len, shuffle)
        theirs = jax_fasta.FastaParser(str(path), min_len, shuffle)
        n = theirs.get_num_sequences()
        assert ours.get_num_seqences() == n
        assert [ours.get_sequence_by_id(i) == fasta.FastaSequence(
            *vars(theirs.get_sequence_by_id(i)).values())
            for i in range(n)] == [True] * n
        for budget in (1, 20, 64, 10**6):
            for first, past in ((0, None), (3, n - 2)):
                assert ours.get_chunks(budget, first, past) == \
                    theirs.get_chunks(budget, first, past)
    recs = [fasta.FastaSequence("a", "ACG"), fasta.FastaSequence("b", "A")]
    mem = fasta.FastaParser("<mem>", min_seq_len=2, records=recs)
    assert mem.get_num_sequences() == 1 and mem.get_chunks(5) == [(0, 1)]


def _mapper_copy_reverse_complement():
    for s in ("", "ACGTN", "acgtRYacgT", bytes(range(32, 127)).decode()):
        assert genomeutils.reverse_complement(s) == \
            jax_genomeutils.reverse_complement(s)


def _mapper_copy_simulators():
    from claragenomicsanalysis_tpu import simulators as theirs
    from claragenomicsanalysis_tpu_torch import simulators as ours
    for seed in (0, 11):
        g = ours.PoissonGenomeSimulator(seed).build_reference(3000)
        assert g == theirs.PoissonGenomeSimulator(seed).build_reference(3000)
        assert ours.MarkovGenomeSimulator(seed).build_reference(500) == \
            theirs.MarkovGenomeSimulator(seed).build_reference(500)
        a = ours.NoisyReadSimulator(seed, 0.05).generate_reads(g, 12, 400)
        b = theirs.NoisyReadSimulator(seed, 0.05).generate_reads(g, 12, 400)
        assert [vars(r) for r in a] == [vars(r) for r in b]


def _mapper_copy_index_store_key():
    from claragenomicsanalysis_tpu.core.config import MapperConfig as Theirs
    from claragenomicsanalysis_tpu.parallel import index_store as theirs
    from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
    from claragenomicsanalysis_tpu_torch.parallel import index_store as ours
    path = os.path.join(ROOT, "data", "sample_reads.fasta")
    op, tp = fasta.create_fasta_parser(path), jax_fasta.FastaParser(path)
    for kw in ({}, dict(kmer_size=19, window_size=5,
                        hash_representations=True, filtering_parameter=0.5)):
        for first, past in ((0, 16), (3, 7)):
            assert ours.index_key(op, first, past, MapperConfig(**kw)) == \
                theirs.index_key(tp, first, past, Theirs(**kw))


@pytest.mark.parametrize("copy", [
    "mapper_config", "types", "paf", "get_chunks", "reverse_complement",
    "simulators", "index_store_key"])
def test_mapper_copies_equal(copy, tmp_path):
    """The mapper slice's copies: MapperConfig, the record types, io/paf,
    the parser's filtering, shuffle and get_chunks, reverse_complement, the
    simulators on a seed and the index store's content key."""
    fn = globals()[f"_mapper_copy_{copy}"]
    fn(tmp_path) if fn.__code__.co_argcount else fn()


def _composition_copy_pipeline_config():
    from claragenomicsanalysis_tpu.core.config import PipelineConfig as Theirs
    from claragenomicsanalysis_tpu_torch.core.config import PipelineConfig
    assert vars(PipelineConfig().mapper) == vars(Theirs().mapper)
    ours, theirs = PipelineConfig(), Theirs()
    assert (ours.aligner_band_radius, ours.max_alignment_length) == \
        (theirs.aligner_band_radius, theirs.max_alignment_length)
    assert [f for f in vars(ours)] == [f for f in vars(theirs)]


def _composition_copy_correct_config():
    from claragenomicsanalysis_tpu.core.config import CorrectConfig as Theirs
    from claragenomicsanalysis_tpu_torch.core.config import CorrectConfig
    for kw in ({}, dict(window_length=100, max_support=15,
                        poa_backend="pallas", min_supports_for_poa=3)):
        ours, theirs = CorrectConfig(**kw), Theirs(**kw)
        a = {k: v for k, v in vars(ours).items() if k != "mapper"}
        b = {k: v for k, v in vars(theirs).items() if k != "mapper"}
        assert a == b and list(vars(ours)) == list(vars(theirs))
        assert vars(ours.mapper) == vars(theirs.mapper)
    assert CorrectConfig().max_support == 7      # the CLI's default is 15


def _composition_copy_evaluation(tmp_path):
    from claragenomicsanalysis_tpu import evaluation as theirs
    from claragenomicsanalysis_tpu_torch import evaluation as ours
    from claragenomicsanalysis_tpu_torch.simulators import (
        NoisyReadSimulator, PoissonGenomeSimulator)
    g = PoissonGenomeSimulator(6).build_reference(8000)
    reads = NoisyReadSimulator(6, 0.05).generate_reads(g, 30, 700)
    ours.write_truth(reads, str(tmp_path / "o.tsv"))
    theirs.write_truth(reads, str(tmp_path / "t.tsv"))
    assert (tmp_path / "o.tsv").read_bytes() == \
        (tmp_path / "t.tsv").read_bytes()
    with open(tmp_path / "o.tsv", "a") as f:
        f.write("short\tline\n")
    truth = ours.read_truth(str(tmp_path / "o.tsv"))
    their_truth = theirs.read_truth(str(tmp_path / "o.tsv"))
    assert {k: vars(v) for k, v in truth.items()} == \
        {k: vars(v) for k, v in their_truth.items()}
    for m in (1, 100, 400):
        assert ours.true_pairs(truth, m) == theirs.true_pairs(their_truth, m)
    rng = np.random.default_rng(6)
    names = [r.name for r in reads]
    paf = [{"query_name": names[a], "target_name": names[b]}
           for a, b in rng.integers(0, len(names), (60, 2))]
    for recs in (paf, [], paf[:1]):
        for m in (50, 250):
            assert ours.evaluate_paf(recs, truth, m) == \
                theirs.evaluate_paf(recs, their_truth, m)
    assert ours.evaluate_paf([], {}) == theirs.evaluate_paf([], {})


@pytest.mark.parametrize("copy", ["pipeline_config", "correct_config",
                                  "evaluation"])
def test_composition_copies_equal(copy, tmp_path):
    """The compositions' copies: PipelineConfig, CorrectConfig (both
    max_support defaults) and evaluation.py (truth files, true pairs,
    metrics)."""
    fn = globals()[f"_composition_copy_{copy}"]
    fn(tmp_path) if fn.__code__.co_argcount else fn()
