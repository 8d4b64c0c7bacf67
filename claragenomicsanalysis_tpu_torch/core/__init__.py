"""Status codes, the aligner's, POA batch's and mapper's configurations and
the mapper's record types: the port's own copies of the parts of
``claragenomicsanalysis_tpu.core`` that it runs, under the same module
names."""
