"""Input parsing of the port (copies of the pure-Python FASTA/FASTQ parser
and the POA window files of ``claragenomicsanalysis_tpu.io``)."""
