"""Command-line interface of the port: the ``align`` subcommand.

Run as ``python -m claragenomicsanalysis_tpu_torch.cli align q.fa t.fa``.
Output and flags are those of ``claragenomicsanalysis_tpu.cli align``, plus
``--device {cuda,cpu}``; the JAX package's ``-d/--devices`` mesh flag has no
counterpart yet.
"""

import argparse
import sys

from .core.status import StatusType
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
