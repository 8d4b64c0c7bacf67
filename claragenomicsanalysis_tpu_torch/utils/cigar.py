"""Edit path -> CIGAR and the pretty 3-line view (copy of ``path_to_cigar``
and ``format_alignment`` from ``claragenomicsanalysis_tpu/cpu/nw_oracle.py``).
"""

import numpy as np

from ..core.status import AlignmentState, CIGAR_OP_COMPACT, CIGAR_OP_EXTENDED
from .genomeutils import decode

#: state-code -> op-char lookup rows for the vectorized RLE below
_CIGAR_LUT_COMPACT = np.array([CIGAR_OP_COMPACT[s] for s in range(4)])
_CIGAR_LUT_EXTENDED = np.array([CIGAR_OP_EXTENDED[s] for s in range(4)])


def path_to_cigar(path, extended: bool = False) -> str:
    """Run-length encoding of the edit path: op chars through a lookup
    table, run boundaries found with one comparison."""
    arr = np.asarray(path, dtype=np.int64)
    if arr.size == 0:
        return ""
    if arr.min() < 0 or arr.max() > 3:
        # a sentinel or padding value in a path must fail here, not wrap
        # into a plausible CIGAR
        raise ValueError(f"invalid alignment state code in path "
                         f"(range [{arr.min()}, {arr.max()}])")
    ops = (_CIGAR_LUT_EXTENDED if extended else _CIGAR_LUT_COMPACT)[arr]
    brk = np.flatnonzero(ops[1:] != ops[:-1])
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [arr.size]])
    return "".join(f"{e - s}{ops[s]}" for s, e in zip(starts, ends))


def format_alignment(path: list[int], q, t, width: int = 80) -> str:
    """Pretty 3-line view: query, match marks, target, ``width`` columns a
    block.  ``q`` and ``t`` are strings or int8 code arrays."""
    qs = q if isinstance(q, str) else decode(np.asarray(q))
    ts = t if isinstance(t, str) else decode(np.asarray(t))
    top, mid, bot = [], [], []
    i = j = 0
    for s in path:
        if s in (AlignmentState.MATCH, AlignmentState.MISMATCH):
            top.append(qs[i]); bot.append(ts[j])
            mid.append("|" if s == AlignmentState.MATCH else "x")
            i += 1; j += 1
        elif s == AlignmentState.INSERTION:
            top.append(qs[i]); mid.append(" "); bot.append("-")
            i += 1
        else:
            top.append("-"); mid.append(" "); bot.append(ts[j])
            j += 1
    lines = []
    for k in range(0, len(top), width):
        lines += ["".join(top[k:k + width]), "".join(mid[k:k + width]),
                  "".join(bot[k:k + width]), ""]
    return "\n".join(lines)
