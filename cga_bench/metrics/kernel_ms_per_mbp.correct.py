"""kernel_ms_per_mbp.correct: CUDA-event ms of every hand-written kernel
launch (`kernel_times`) a read Mbp."""

from cga_bench.readers import kernel_per_mbp


def read(rec):
    return kernel_per_mbp(rec, "correct.map")
