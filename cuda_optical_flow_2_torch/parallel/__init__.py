"""Scaling over several devices: batch (data-parallel) and spatial
(tensor-parallel) sharding.

Counterpart of ``cuda_optical_flow_2_tpu.parallel``, over a :class:`Mesh` of
``torch.device`` driven by one process:

* batching: frame pairs on a leading axis, one slice per device, no
  communication;
* spatial: ONE frame pair's rows split over the mesh, every stencil stage
  padding its block with halo rows from its neighbours, the band kernels
  testing positions against the global image (frames too large for one
  card, or one pair's latency).  A mesh may list one card several times:
  ``make_mesh(devices=[torch.device("cuda")] * 3)`` runs three real shards
  on it.

Spatial TP covers all five families (Lucas-Kanade, Horn-Schunck,
Farnebäck, TV-L1, DIS).  ``multihost`` scales batch sharding over several
processes on ``torch.distributed``, one process per card.
"""

from cuda_optical_flow_2_torch.parallel.batching import (
    Mesh,
    chunked_flow,
    make_mesh,
    shard_batch,
    sharded_flow,
    sharded_pyramidal_lk,
)
from cuda_optical_flow_2_torch.parallel.multihost import (
    host_local_batch,
    make_global_mesh,
)
from cuda_optical_flow_2_torch.parallel.spatial import (
    grid_pyramidal_lk,
    halo_exchange,
    spatial_pyramidal_lk,
    validate_spatial,
)
from cuda_optical_flow_2_torch.parallel.spatial_models import (
    grid_pyramidal_flow,
    spatial_pyramidal_dis,
    spatial_pyramidal_fb,
    spatial_pyramidal_flow,
    spatial_pyramidal_hs,
    spatial_pyramidal_tvl1,
    validate_spatial_dis,
    validate_spatial_fb,
    validate_spatial_flow,
    validate_spatial_hs,
    validate_spatial_tvl1,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "chunked_flow",
    "sharded_flow",
    "sharded_pyramidal_lk",
    "shard_batch",
    "grid_pyramidal_lk",
    "halo_exchange",
    "spatial_pyramidal_lk",
    "spatial_pyramidal_hs",
    "spatial_pyramidal_fb",
    "spatial_pyramidal_tvl1",
    "spatial_pyramidal_dis",
    "spatial_pyramidal_flow",
    "grid_pyramidal_flow",
    "validate_spatial",
    "validate_spatial_hs",
    "validate_spatial_fb",
    "validate_spatial_tvl1",
    "validate_spatial_dis",
    "validate_spatial_flow",
    "make_global_mesh",
    "host_local_batch",
]
