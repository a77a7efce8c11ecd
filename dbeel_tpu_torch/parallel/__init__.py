"""Multi-card parallelism: partition meshes and the distributed merge.

The counterpart of ``dbeel_tpu/parallel``: the reference scales by
shard-per-core over a hash ring; the device scales the bulk compute
(the compaction merge) over a mesh of partitions — a sample sort whose
all_gather and all_to_all are device copies between the partitions'
tensors, driven by one process (``dist_merge``).
"""

from .mesh import Mesh, shard_mesh  # noqa: F401
