"""unpack_ms_per_mbp.overlap: host ms in `tb.unpack` a read Mbp (the packed
path codes of every banded launch, Hirschberg's base cases included, made
into host lists)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("tb.unpack",), "tb.unpack")
