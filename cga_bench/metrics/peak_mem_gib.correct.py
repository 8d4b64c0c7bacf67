"""peak_mem_gib.correct: `max_memory_allocated` over the window, in GiB."""

from cga_bench.readers import peak_gib


def read(rec):
    return peak_gib(rec)
