"""The port's persistence layer: the mapper's index store (copy of
``claragenomicsanalysis_tpu/parallel/index_store.py``).  The multi-GPU
layer of the JAX package's ``parallel/`` has no counterpart yet."""
