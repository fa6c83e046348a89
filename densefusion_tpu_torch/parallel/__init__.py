"""Parallelism over ``torch.distributed``: process groups and the device
mesh, batch placement, and the mesh-sharded collectives (counterpart of
``densefusion_tpu/parallel``). NCCL on the card, gloo on the CPU."""

from densefusion_tpu_torch.parallel.mesh import (
    make_mesh, initialize_distributed, local_batch_slice, spawn_ranks,
)
from densefusion_tpu_torch.parallel.sharding import (
    batch_sharding, replicate, make_shard_batch_fn,
)
from densefusion_tpu_torch.parallel.collectives import (
    ring_nearest_neighbor, sharded_nearest_neighbor,
    sharded_hypothesis_mean_dist, psum_mean,
)

__all__ = [
    "make_mesh", "initialize_distributed", "local_batch_slice",
    "spawn_ranks",
    "batch_sharding", "replicate", "make_shard_batch_fn",
    "ring_nearest_neighbor", "sharded_nearest_neighbor",
    "sharded_hypothesis_mean_dist", "psum_mean",
]
