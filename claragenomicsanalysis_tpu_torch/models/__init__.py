"""The port's model layer: the batched pairwise aligner and POA
consensus."""
