"""The port's multi-rank layer (counterpart of
``claragenomicsanalysis_tpu/parallel/``) on ``torch.distributed``, one
process a rank.  Mesh axes, as in the JAX package:

- ``data``: problem and window batches split over ranks (merging is
  concatenation, bit-identical by construction);
- ``rep``: the minimizer target index split by sorted representation
  blocks, anchors routed to the rank owning their query reads;
- ``sp``: one problem's DP matrix split by target stripes, the frontier
  passed along a ring of ranks (ring_nw.py).

Also the persistence layer: the mapper's index store and the resumable
all-vs-all loop.
"""

from .mesh import make_mesh, local_device_count, axis_meshes
from .shard import (sharded_anchors, sharded_banded_nw, sharded_match_chain,
                    sharded_poa)
from .manifest import map_all_vs_all_resumable
from .ring_nw import ring_wavefront_nw
from .shard_output import (map_all_vs_all_sharded, merge_sharded_rows,
                           write_merged_paf)
from .multihost import (initialize_distributed, make_global_mesh,
                        process_count, process_index)

__all__ = ["make_mesh", "local_device_count", "axis_meshes",
           "sharded_anchors", "sharded_banded_nw",
           "sharded_match_chain", "sharded_poa", "map_all_vs_all_resumable",
           "ring_wavefront_nw", "initialize_distributed", "make_global_mesh",
           "process_count", "process_index", "map_all_vs_all_sharded",
           "merge_sharded_rows", "write_merged_paf"]
