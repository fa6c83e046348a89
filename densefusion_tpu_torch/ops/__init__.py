"""Kernel-backed ops: the ADD-S remap and the fused ADD / ADD-S hypothesis
distance (CUDA kernels, each with its plain version)."""

from densefusion_tpu_torch.ops.knn import (
    nearest_neighbor, adds_remap, adds_remap_plain, adds_remap_targets,
    adds_remap_kernel,
)
from densefusion_tpu_torch.ops.add_dist import hypothesis_mean_dist

__all__ = ["nearest_neighbor", "adds_remap", "adds_remap_plain",
           "adds_remap_targets", "adds_remap_kernel", "hypothesis_mean_dist"]
