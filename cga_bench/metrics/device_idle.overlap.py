"""device_idle.overlap: the share of the traced window in which no kernel,
copy or memset ran on the card (`torch.profiler`), in %."""

from cga_bench.readers import device_idle


def read(rec):
    return device_idle(rec)
