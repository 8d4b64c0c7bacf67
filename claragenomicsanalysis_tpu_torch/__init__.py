"""claragenomicsanalysis_tpu_torch — the PyTorch / CUDA port of
claragenomicsanalysis_tpu for NVIDIA Hopper GPUs.

The port mirrors the JAX package's layout (``core/``, ``io/``, ``ops/``,
``align/``, ``models/``, ``utils/``, ``cli.py``).  It imports nothing of
``claragenomicsanalysis_tpu``: of the JAX package's framework-free modules it
keeps its own copies of the parts it runs, under the same module names
(``core.status``, ``core.config``, ``core.types``, ``io.fasta``,
``io.windows``, ``io.paf``, ``utils.genomeutils``, ``utils.mathutils``,
``simulators``, ``parallel.index_store``; ``utils.cigar`` holds the CIGAR
and pretty-print helpers of ``cpu/nw_oracle.py``).  It runs the aligner
(``create_aligner``), POA consensus (``create_batch``) and the overlap
mapper (``map_all_vs_all``, ``map_query_vs_target``; torch ops, as the JAX
package's are plain XLA).  Every kernel is written
by hand for ``sm_90a`` under ``csrc/`` and built with ``nvcc`` at first use;
beside each one a plain PyTorch version defines the same output and runs on
CPU tensors.  The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: importing the package loads no torch module
    until one of these is asked for."""
    import importlib
    lazy = {
        "create_aligner": "claragenomicsanalysis_tpu_torch.models.aligner",
        "Aligner": "claragenomicsanalysis_tpu_torch.models.aligner",
        "Alignment": "claragenomicsanalysis_tpu_torch.models.aligner",
        "create_batch": "claragenomicsanalysis_tpu_torch.models.poa",
        "Batch": "claragenomicsanalysis_tpu_torch.models.poa",
        "map_all_vs_all": "claragenomicsanalysis_tpu_torch.models.mapper",
        "map_query_vs_target":
            "claragenomicsanalysis_tpu_torch.models.mapper",
    }
    if name in lazy:
        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
