"""Command-line interface of the port: the ``align``, ``poa`` and ``map``
subcommands.

Run as ``python -m claragenomicsanalysis_tpu_torch.cli align q.fa t.fa``,
``... cli poa windows.txt [--msa]`` or ``... cli map reads.fa [targets.fa]``.
Output and flags are those of the JAX package's ``cli align``, ``cli poa``
and ``cli map``, plus ``--device {cuda,cpu}``; the JAX package's
``-d/--devices`` mesh flag has no counterpart yet.
"""

import argparse
import sys

from .core.config import BatchSize, MapperConfig
from .core.status import OutputType, StatusType
from .io.fasta import create_fasta_parser


def cmd_align(args) -> int:
    from .models.aligner import create_aligner
    qp = create_fasta_parser(args.queries)
    tp = create_fasta_parser(args.targets)
    n = min(qp.get_num_sequences(), tp.get_num_sequences())
    max_q = max(len(qp.get_sequence_by_id(i).seq) for i in range(n))
    max_t = max(len(tp.get_sequence_by_id(i).seq) for i in range(n))
    aligner = create_aligner(max_q, max_t, n, band_radius=args.band_radius,
                             algorithm=args.algorithm, device=args.device)
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
                         device=args.device)
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
    parser = create_fasta_parser(args.input)
    if args.target:
        tparser = create_fasta_parser(args.target)
        res = map_query_vs_target(
            parser, tparser, _mapper_cfg(args),
            target_index_size_mb=args.target_index_size or None,
            index_store_dir=args.index_store or None, device=args.device)
    else:
        tparser = parser
        res = map_all_vs_all(parser, _mapper_cfg(args),
                             index_store_dir=args.index_store or None,
                             device=args.device)
    overlaps = res.overlaps
    if args.fuse_overlaps:
        overlaps = Overlapper.rows_to_overlaps(
            Overlapper.fuse_overlap_rows(res.rows,
                                         max_gap=args.fusion_max_gap))
    if args.rescue_overlap_ends:
        if args.target:
            print("warning: --rescue-overlap-ends is all-vs-all only; "
                  "skipped", file=sys.stderr)
        else:
            overlaps = Overlapper.rescue_overlap_ends(
                overlaps, parser, extension=args.rescue_extension,
                required_similarity=args.rescue_similarity)
    for row in overlaps_to_paf(overlaps, parser, tparser):
        print(row)
    bad = [s for s in res.statuses if s != StatusType.SUCCESS]
    if bad:
        print(f"warning: {len(bad)} batch(es) overflowed anchors",
              file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="claragenomicsanalysis_tpu_torch")
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
    m.set_defaults(fn=cmd_map)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
