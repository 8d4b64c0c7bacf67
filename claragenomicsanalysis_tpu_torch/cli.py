"""Command-line interface of the port: the ``align`` and ``poa``
subcommands.

Run as ``python -m claragenomicsanalysis_tpu_torch.cli align q.fa t.fa`` or
``... cli poa windows.txt [--msa]``.  Output and flags are those of the JAX
package's ``cli align`` and ``cli poa``, plus ``--device {cuda,cpu}``; the
JAX package's ``-d/--devices`` mesh flag has no counterpart yet.
"""

import argparse
import sys

from .core.config import BatchSize
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
