"""Helpers of the port: profiling, and its own copies of the JAX package's
framework-free sequence and integer helpers (``genomeutils``, ``mathutils``)
and of the CIGAR formatting of ``cpu/nw_oracle.py`` (``cigar``)."""
