"""Status codes and the aligner's and POA batch's configurations: the
port's own copies of the parts of ``claragenomicsanalysis_tpu.core`` that it
runs, under the same module names."""
