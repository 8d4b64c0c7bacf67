"""The port's model layer: the batched pairwise aligner, POA consensus and
the overlap mapper."""
