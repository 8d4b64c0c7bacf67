"""Input parsing of the port (copy of the pure-Python FASTA/FASTQ parser of
``claragenomicsanalysis_tpu.io``)."""
