"""Multi-world, source-sharded and spatially sharded stepping on one card.

Counterpart of ``substrata_tpu/parallel``: the reference scales over a
device mesh with ``shard_map``, ``psum`` and ``ppermute``; the port puts
the mesh's axis on one card as a leading shard axis, steps the shards in a
loop, and runs the collectives as kernels KAD (the halo exchange) and KAE
(the reductions over the shard axis).

- **Worlds** (``mesh.multi_world_step``): W independent worlds, each a
  cold physics step; the awake counts summed.
- **Sources** (``mesh.sharded_mix_block``): the downmix over source shards,
  the stereo blocks summed and clipped.
- **Space** (``spatial``): ONE world split into x-slabs or x-y tiles, the
  boundary bodies exchanged as fixed-size halos each step.
"""

from substrata_tpu_torch.parallel.mesh import Mesh, make_mesh, multi_world_step  # noqa: F401
from substrata_tpu_torch.parallel.spatial import (  # noqa: F401
    partition_by_slab, shard_partitioned, spatial_world_step,
)
