"""Input and output of the port (copies of the pure-Python FASTA/FASTQ
parser, the POA window files and PAF of ``claragenomicsanalysis_tpu.io``)."""
