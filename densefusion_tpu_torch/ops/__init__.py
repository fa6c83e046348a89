"""Kernel-backed ops: the 1-NN search, the ADD-S remap and min distance,
and the fused ADD / ADD-S hypothesis distance (CUDA kernels, each with its
plain version). ``knn.knn`` (k-NN) stays in its module: the name ``knn``
here is the module."""

from densefusion_tpu_torch.ops.knn import (
    nearest_neighbor, nearest_neighbor_plain, nearest_neighbor_plain_batched,
    nn_kernel, nn_batched_kernel, adds_remap, adds_remap_plain,
    adds_remap_targets, adds_remap_kernel, adds_min_sqdist_minus_qsq,
)
from densefusion_tpu_torch.ops.add_dist import hypothesis_mean_dist

__all__ = ["nearest_neighbor", "nearest_neighbor_plain",
           "nearest_neighbor_plain_batched", "nn_kernel",
           "nn_batched_kernel", "adds_remap", "adds_remap_plain",
           "adds_remap_targets", "adds_remap_kernel",
           "adds_min_sqdist_minus_qsq", "hypothesis_mean_dist"]
