"""aligner_ms_per_mbp.overlap: host ms in `aligner.pack` and
`aligner.myers` a read Mbp (myers alignment of every overlap, Hirschberg
included)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("aligner.pack", "aligner.myers"),
                         "pipeline.align")
