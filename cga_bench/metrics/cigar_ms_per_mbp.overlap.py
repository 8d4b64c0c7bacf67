"""cigar_ms_per_mbp.overlap: the self time of `pipeline.align` a read Mbp:
its host ms less the host ms of the aligner ranges directly under it
(`aligner.pack`, `aligner.myers`); the CIGAR strings take most of it."""

from cga_bench.readers import host_ms, per_mbp


def read(rec):
    own = host_ms(rec, "pipeline.align") - host_ms(rec, "aligner.pack") \
        - host_ms(rec, "aligner.myers")
    return per_mbp(rec, own, "pipeline.align")
