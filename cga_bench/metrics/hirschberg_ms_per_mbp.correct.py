"""hirschberg_ms_per_mbp.correct: host ms in `aligner.hirschberg` a read Mbp
(Hirschberg's levels; 0 where no pair went there)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("aligner.hirschberg",), "correct.align")
