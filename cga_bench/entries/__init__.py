"""The port's entry points the benchmark drives, one module an entry; a
configuration names its entry, and the module gives ``run(parser,
settings, device)``, which drives the port and returns plain data (with
``attempted`` and ``failed``, the entry's own counts of work items), and
``judge``, the reference's comparison for it."""

import numpy as np


def rows_of(overlaps) -> np.ndarray:
    """(n, 8) int64 PAF fields without the CIGAR: query, target, query
    start and end, target start and end, residues, strand (1 for -)."""
    return np.array([[o.query_read_id, o.target_read_id,
                      o.query_start_position_in_read,
                      o.query_end_position_in_read,
                      o.target_start_position_in_read,
                      o.target_end_position_in_read, o.num_residues,
                      0 if o.relative_strand == "+" else 1]
                     for o in overlaps], np.int64).reshape(-1, 8)
