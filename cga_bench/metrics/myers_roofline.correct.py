"""myers_roofline.correct: B4's least time at the card's published peaks
(cga_bench/peaks.py) over its CUDA-event time, summed over its launches,
in %."""

from cga_bench.readers import myers_roofline


def read(rec):
    return myers_roofline(rec)
