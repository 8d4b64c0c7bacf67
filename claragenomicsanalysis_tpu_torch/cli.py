"""Command-line interface of the port: align | poa | map | pipeline |
correct | simulate | evaluate.

Run as ``python -m claragenomicsanalysis_tpu_torch.cli <subcommand> ...``,
e.g. ``... cli align q.fa t.fa``, ``... cli poa windows.txt [--msa]``,
``... cli map reads.fa [targets.fa]``, ``... cli pipeline reads.fa``,
``... cli correct reads.fa``.  Output and flags are those of the JAX
package's CLI, the global ``--log-level``, ``--timings`` and
``--profile-dir`` included, plus ``--device {cuda,cpu}`` on every
subcommand that runs on a device (``simulate`` and ``evaluate`` do not).

``-d/--devices N`` (align, poa, map, pipeline, correct) starts N rank
processes (parallel/multihost.run_ranks), one a card under ``--device
cuda`` (NCCL; N above the cards present exits with the JAX message) or N
gloo ranks on the CPU under ``--device cpu``.  The ranks lay a mesh over
the axis the subcommand shards, as the JAX CLI does: align
``hirschberg-myers`` on 'sp', the other algorithms on 'data'; poa on
'data'; map on 'rep'; pipeline and correct both views.  Every rank reads
the same inputs; rank 0 alone writes stdout, the summaries on stderr,
``--timings`` and ``--profile-dir``, and the CLI exits with the first
non-zero rank's code.  ``-d 1`` forms no process group.
"""

import argparse
import contextlib
import json
import os
import sys

from .core.config import BatchSize, MapperConfig, PipelineConfig
from .core.status import OutputType, StatusType
from .io.fasta import create_fasta_parser
from .parallel.multihost import is_writer
from .utils.logging import initialize_logger


def _note(msg: str) -> None:
    """A summary line on stderr, from rank 0 only."""
    if is_writer():
        print(msg, file=sys.stderr)


def _cli_mesh(args, sp: bool = False):
    """The mesh of a rank of ``-d N``: every rank on 'data' (on 'sp' with
    ``sp``); None without ranks."""
    from .parallel.mesh import make_mesh
    from .parallel.multihost import process_count
    n = process_count()
    if n <= 1:
        return None
    return make_mesh(data=1, sp=n) if sp else make_mesh(data=n)


def cmd_align(args) -> int:
    from .models.aligner import create_aligner
    qp = create_fasta_parser(args.queries)
    tp = create_fasta_parser(args.targets)
    n = min(qp.get_num_sequences(), tp.get_num_sequences())
    max_q = max(len(qp.get_sequence_by_id(i).seq) for i in range(n))
    max_t = max(len(tp.get_sequence_by_id(i).seq) for i in range(n))
    # -d: hirschberg-myers puts the ranks on the 'sp' ring (one pair's DP
    # split by target stripes, the threshold automatic), the batch
    # algorithms on 'data'
    mesh = _cli_mesh(args, sp=args.algorithm == "hirschberg-myers")
    aligner = create_aligner(max_q, max_t, n, band_radius=args.band_radius,
                             algorithm=args.algorithm, device=args.device,
                             mesh=mesh)
    for i in range(n):
        aligner.add_alignment(qp.get_sequence_by_id(i).seq,
                              tp.get_sequence_by_id(i).seq)
    for i, a in enumerate(aligner.get_alignments()):
        names = (f"{qp.get_sequence_by_id(i).name}\t"
                 f"{tp.get_sequence_by_id(i).name}")
        if a.status == StatusType.SUCCESS:
            print(f"{names}\t{a.edit_distance}\t{a.convert_to_cigar()}")
            if args.print_alignments:
                print(a.format_alignment())
        else:
            print(f"{names}\t-1\t*\t{a.status.name}")
    return 0


def cmd_poa(args) -> int:
    from .io.windows import read_windows
    from .models.poa import create_batch
    windows = read_windows(args.windows, max_windows=args.max_windows or None)
    max_len = max((len(s) for w in windows for s in w), default=1)
    max_seqs = max((len(w) for w in windows), default=1)
    bs = BatchSize(max_sequence_size=max(64, max_len),
                   max_sequences_per_poa=max(2, max_seqs),
                   band_width=args.band_width)
    mask = OutputType.CONSENSUS | (OutputType.MSA if args.msa else 0)
    batch = create_batch(batch_size=bs, output_mask=mask,
                         max_poas=len(windows), banded_alignment=args.banded,
                         device=args.device, mesh=_cli_mesh(args))
    for w in windows:
        batch.add_poa_group(w)
    cons, _, stats = batch.get_consensus()
    for c, st in zip(cons, stats):
        if st == StatusType.SUCCESS:
            print(c)
        else:
            print(f"*\t{st.name}")
    if args.msa:
        msas, _ = batch.get_msa()
        for i, m in enumerate(msas):
            print(f"> window {i}")
            for row in m:
                print(row)
    return 0


def _add_mapper_flags(p):
    p.add_argument("-k", "--kmer-size", type=int, default=15)
    p.add_argument("-w", "--window-size", type=int, default=15)
    p.add_argument("-F", "--filtering-parameter", type=float, default=1.0)
    p.add_argument("-i", "--index-size", type=int, default=30,
                   help="index batch budget, MB of bases")
    p.add_argument("--min-residues", type=int, default=4)
    p.add_argument("--min-overlap-len", type=int, default=50)
    p.add_argument("--min-overlap-fraction", type=float, default=0.8)
    p.add_argument("--min-bases-per-residue", type=int, default=100)
    p.add_argument("--max-anchor-gap", type=int, default=5000)
    p.add_argument("--no-hashing", action="store_true")


def _mapper_cfg(args) -> MapperConfig:
    return MapperConfig(
        kmer_size=args.kmer_size, window_size=args.window_size,
        hash_representations=not args.no_hashing,
        filtering_parameter=args.filtering_parameter,
        min_residues=args.min_residues,
        min_overlap_len=args.min_overlap_len,
        min_overlap_fraction=args.min_overlap_fraction,
        min_bases_per_residue=args.min_bases_per_residue,
        max_anchor_gap=args.max_anchor_gap,
        index_size_mb=args.index_size)


def cmd_map(args) -> int:
    from .models.mapper import (Overlapper, map_all_vs_all,
                                map_query_vs_target, overlaps_to_paf)
    from .parallel.mesh import axis_meshes
    parser = create_fasta_parser(args.input)
    _, mesh_rep = axis_meshes(_cli_mesh(args))
    if args.target:
        tparser = create_fasta_parser(args.target)
        res = map_query_vs_target(
            parser, tparser, _mapper_cfg(args),
            target_index_size_mb=args.target_index_size or None,
            index_store_dir=args.index_store or None, device=args.device,
            mesh=mesh_rep)
    else:
        tparser = parser
        res = map_all_vs_all(parser, _mapper_cfg(args),
                             index_store_dir=args.index_store or None,
                             device=args.device, mesh=mesh_rep)
    overlaps = res.overlaps
    if args.fuse_overlaps:
        overlaps = Overlapper.rows_to_overlaps(
            Overlapper.fuse_overlap_rows(res.rows,
                                         max_gap=args.fusion_max_gap))
    if args.rescue_overlap_ends:
        if args.target:
            _note("warning: --rescue-overlap-ends is all-vs-all only; "
                  "skipped")
        else:
            overlaps = Overlapper.rescue_overlap_ends(
                overlaps, parser, extension=args.rescue_extension,
                required_similarity=args.rescue_similarity)
    for row in overlaps_to_paf(overlaps, parser, tparser):
        print(row)
    bad = [s for s in res.statuses if s != StatusType.SUCCESS]
    if bad:
        _note(f"warning: {len(bad)} batch(es) overflowed anchors")
    return 0


def cmd_evaluate(args) -> int:
    """PAF-vs-truth recall and precision on simulated reads."""
    from .evaluation import evaluate_paf, read_truth
    from .io.paf import read_paf
    truth = read_truth(args.truth)
    metrics = evaluate_paf(read_paf(args.paf), truth,
                           min_overlap_bases=args.min_overlap_bases)
    print(json.dumps(metrics))
    return 0


def cmd_simulate(args) -> int:
    """Synthetic genome and noisy-read FASTA generator."""
    from .simulators import (MarkovGenomeSimulator, NoisyReadSimulator,
                             PoissonGenomeSimulator)
    sim = (MarkovGenomeSimulator(seed=args.seed) if args.markov
           else PoissonGenomeSimulator(seed=args.seed))
    genome = sim.build_reference(args.genome_length)
    print(f">reference\n{genome}" if args.reads == 0 else "", end="")
    if args.reads:
        rsim = NoisyReadSimulator(seed=args.seed, error_rate=args.error_rate)
        reads = rsim.generate_reads(genome, args.reads, args.read_length)
        for r in reads:
            print(f">{r.name}\n{r.seq}")
        if args.reference_out:
            with open(args.reference_out, "w") as f:
                f.write(f">reference\n{genome}\n")
        if args.truth_out:
            from .evaluation import write_truth
            write_truth(reads, args.truth_out)
    return 0


def cmd_correct(args) -> int:
    """Read correction: all-vs-all map -> windowed POA polish -> corrected
    FASTA to stdout (or --output)."""
    from .core.config import CorrectConfig
    from .models.correct import correct_reads, write_fasta
    parser = create_fasta_parser(args.input)
    cfg = CorrectConfig(mapper=_mapper_cfg(args),
                        window_length=args.window_length,
                        max_support=args.max_support,
                        aligner_band_radius=args.band_radius,
                        poa_backend=args.poa_backend)
    res = correct_reads(parser, cfg, work_dir=args.work_dir or None,
                        device=args.device, mesh=_cli_mesh(args))
    if args.output:
        if is_writer():
            write_fasta(res, args.output)
    else:
        for name, seq in zip(res.names, res.seqs):
            print(f">{name}\n{seq}")
    _note(f"polished {res.n_polished}/{res.n_windows} windows "
          f"({res.n_window_failed} kept backbone after POA failure)")
    return 0


def cmd_pipeline(args) -> int:
    from .models.pipeline import run_pipeline
    parser = create_fasta_parser(args.input)
    cfg = PipelineConfig(mapper=_mapper_cfg(args),
                         aligner_band_radius=args.band_radius)
    res = run_pipeline(parser, cfg, device=args.device, mesh=_cli_mesh(args))
    for row in res.paf_rows:
        print(row)
    _note(f"aligned {res.n_aligned} overlaps ({res.n_align_failed} failed)")
    return 0


def _run_profiled(fn, args, out_dir: str) -> int:
    """``fn(args)`` under torch.profiler (the host, and the card when torch
    finds one); the trace goes to ``out_dir``/trace.json (Chrome format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        rc = fn(args)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return rc


def _add_devices_flag(p, help_text: str) -> None:
    p.add_argument("-d", "--devices", type=int, default=1, help=help_text)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="claragenomicsanalysis_tpu_torch")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument("--timings", action="store_true",
                    help="print each stage's host seconds and entries as "
                         "JSON to stderr at exit (on the card, not its "
                         "device time)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the run here "
                         "(trace.json, Chrome format)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("align", help="batched pairwise global alignment")
    a.add_argument("queries")
    a.add_argument("targets")
    a.add_argument("--band-radius", type=int, default=64)
    a.add_argument("--algorithm", default="ukkonen",
                   choices=["ukkonen", "myers", "hirschberg-myers"])
    a.add_argument("--print-alignments", action="store_true")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the DP runs (cuda: the hand-written kernels)")
    _add_devices_flag(a, "hirschberg-myers: ring-shard one pair's DP over "
                         "this many devices ('sp' axis, auto threshold); "
                         "ukkonen: shard the batch ('data' axis)")
    a.set_defaults(fn=cmd_align)
    p = sub.add_parser("poa", help="POA consensus over a window file")
    p.add_argument("windows")
    p.add_argument("--msa", action="store_true",
                   help="also print each window's multiple sequence "
                        "alignment, one gapped row per sequence")
    p.add_argument("--max-windows", type=int, default=0)
    p.add_argument("--banded", action="store_true",
                   help="static-banded graph NW (cudapoa banded_alignment)")
    p.add_argument("--band-width", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the POA runs (cuda: the hand-written kernels)")
    _add_devices_flag(p, "shard windows over this many devices (data axis)")
    p.set_defaults(fn=cmd_poa)
    m = sub.add_parser("map", help="overlap mapping, PAF to stdout: "
                                   "all-vs-all (one input) or "
                                   "query-vs-target (two inputs)")
    m.add_argument("input", help="query reads FASTA (all-vs-all when no "
                                 "target is given)")
    m.add_argument("target", nargs="?", default="",
                   help="optional target FASTA (query-vs-target mode)")
    _add_mapper_flags(m)
    m.add_argument("-c", "--index-store", default="",
                   help="directory for persisted minimizer indices "
                        "(cross-run cache / resume point)")
    m.add_argument("-t", "--target-index-size", type=int, default=0,
                   help="target index batch budget, MB of bases "
                        "(default: same as -i)")
    m.add_argument("--fuse-overlaps", action="store_true",
                   help="merge adjacent candidate overlaps on the same "
                        "(query, target, strand)")
    m.add_argument("--fusion-max-gap", type=int, default=500)
    m.add_argument("--rescue-overlap-ends", action="store_true",
                   help="extend overlap ends into similar read flanks")
    m.add_argument("--rescue-extension", type=int, default=50)
    m.add_argument("--rescue-similarity", type=float, default=0.85)
    m.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where sketch, index, matching and chaining run")
    _add_devices_flag(m, "shard matching over this many devices (rep axis)")
    m.set_defaults(fn=cmd_map)

    sm = sub.add_parser("simulate", help="synthetic genome / noisy reads")
    sm.add_argument("--genome-length", type=int, default=100_000)
    sm.add_argument("--reads", type=int, default=0,
                    help="0 = emit the genome itself")
    sm.add_argument("--read-length", type=int, default=5000)
    sm.add_argument("--error-rate", type=float, default=0.05)
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--markov", action="store_true")
    sm.add_argument("--reference-out", default="")
    sm.add_argument("--truth-out", default="",
                    help="write read placement truth TSV (for `evaluate`)")
    sm.set_defaults(fn=cmd_simulate)

    ev = sub.add_parser("evaluate",
                        help="PAF recall/precision vs simulated-read truth")
    ev.add_argument("truth", help="truth TSV from simulate --truth-out")
    ev.add_argument("paf")
    ev.add_argument("--min-overlap-bases", type=int, default=100)
    ev.set_defaults(fn=cmd_evaluate)

    pl = sub.add_parser("pipeline", help="map + align, PAF with CIGARs")
    pl.add_argument("input")
    _add_mapper_flags(pl)
    pl.add_argument("--band-radius", type=int, default=256)
    pl.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where mapping and alignment run (cuda: the "
                         "hand-written kernels)")
    _add_devices_flag(pl, "shard matching over this many devices")
    pl.set_defaults(fn=cmd_pipeline)

    co = sub.add_parser("correct",
                        help="read correction: map + windowed POA polish")
    co.add_argument("input")
    _add_mapper_flags(co)
    co.add_argument("--window-length", type=int, default=128,
                    help="backbone window (bases)")
    co.add_argument("--max-support", type=int, default=15,
                    help="supporting segments per POA window")
    co.add_argument("--band-radius", type=int, default=256,
                    help="per-overlap re-alignment band radius")
    co.add_argument("--work-dir", default="",
                    help="checkpoint dir: run resumes after a crash")
    co.add_argument("--poa-backend", default="auto",
                    choices=("auto", "xla", "pallas", "pallas2"),
                    help="POA kernels of the polish stage, the JAX "
                         "package's names: pallas runs the one-kernel-per-"
                         "window route (B10), auto, xla and pallas2 the "
                         "lockstep kernels (B5-B8); the same result either "
                         "way")
    co.add_argument("-o", "--output", default="",
                    help="corrected FASTA path (default: stdout)")
    co.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where mapping, alignment and POA run (cuda: the "
                         "hand-written kernels)")
    _add_devices_flag(co, "shard matching (rep axis) and deal the reads "
                          "(data axis) over this many devices")
    co.set_defaults(fn=cmd_correct)
    return ap


def _run(args) -> int:
    """The subcommand, with --timings and --profile-dir."""
    with contextlib.ExitStack() as stack:
        if args.timings:
            from .utils.profiling import stage_times
            st = stack.enter_context(stage_times())
        if args.profile_dir:
            rc = _run_profiled(args.fn, args, args.profile_dir)
        else:
            rc = args.fn(args)
    if args.timings:
        print(json.dumps(st.timings()), file=sys.stderr)
    return rc


def _run_ranks(args, argv: list) -> int:
    """``-d N``: the subcommand in N rank processes; -> the first non-zero
    rank's exit code, else 0."""
    from .parallel.multihost import RanksFailed, run_ranks
    n = args.devices
    if args.device == "cuda":
        import torch
        k = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > k:
            raise SystemExit(f"--devices {n} but only {k} available")
        from .ops import _build
        _build.build()          # once, before the ranks load it
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        devices = ["cpu"] * n
    try:
        rcs = run_ranks(_rank_main, n, devices, args=(argv,),
                        log_level=args.log_level)
    except RanksFailed as e:
        return e.first_error
    return next((rc for rc in rcs if rc), 0)


def _rank_main(argv: list) -> int:
    """One rank of ``-d N``: the subcommand on the rank's mesh; stdout,
    --timings and --profile-dir on rank 0 only (141 when stdout's reader
    leaves, as :func:`_console_entry`)."""
    args = build_parser().parse_args(argv)
    with contextlib.ExitStack() as stack:
        if not is_writer():
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
            args.timings, args.profile_dir = False, ""
        try:
            rc = _run(args)
            sys.stdout.flush()
        except BrokenPipeError:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
            return 141
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    initialize_logger(args.log_level)
    if getattr(args, "devices", 1) > 1:
        return _run_ranks(args, argv)
    return _run(args)


def _console_entry() -> None:
    """The ``python -m`` entry point; exits quietly with 141 (128 +
    SIGPIPE) when stdout's reader goes away (``... | head``)."""
    try:
        sys.exit(main())
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(141)


if __name__ == "__main__":
    _console_entry()
