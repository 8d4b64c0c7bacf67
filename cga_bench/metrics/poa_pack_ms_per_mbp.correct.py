"""poa_pack_ms_per_mbp.correct: host ms in `poa.pack` a read Mbp (the POA
windows packed into arrays and copied to the card)."""

from cga_bench.readers import range_per_mbp


def read(rec):
    return range_per_mbp(rec, ("poa.pack",), "poa.pack")
