"""PAF reading and writing (copy of ``claragenomicsanalysis_tpu/io/paf.py``).

The 12 standard PAF columns; residue matches = number of anchors in the
chain; mapping quality fixed at 255 (unknown).
"""

from collections.abc import Iterable

from ..core.types import Overlap


def format_paf_row(o: Overlap, query_name: str, query_len: int,
                   target_name: str, target_len: int) -> str:
    cols = [
        query_name,
        str(query_len),
        str(o.query_start_position_in_read),
        str(o.query_end_position_in_read),
        o.relative_strand,
        target_name,
        str(target_len),
        str(o.target_start_position_in_read),
        str(o.target_end_position_in_read),
        str(o.num_residues),
        str(max(o.query_end_position_in_read - o.query_start_position_in_read,
                o.target_end_position_in_read - o.target_start_position_in_read)),
        "255",
    ]
    if o.cigar:
        cols.append(f"cg:Z:{o.cigar}")
    return "\t".join(cols)


def write_paf(rows: Iterable[str], path: str) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(r + "\n")


def read_paf(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            if len(c) < 12:
                continue
            rec = {
                "query_name": c[0], "query_len": int(c[1]),
                "query_start": int(c[2]), "query_end": int(c[3]),
                "strand": c[4],
                "target_name": c[5], "target_len": int(c[6]),
                "target_start": int(c[7]), "target_end": int(c[8]),
                "num_residue_matches": int(c[9]),
                "alignment_block_length": int(c[10]),
                "mapping_quality": int(c[11]),
            }
            for tag in c[12:]:
                if tag.startswith("cg:Z:"):
                    rec["cigar"] = tag[5:]
            out.append(rec)
    return out
