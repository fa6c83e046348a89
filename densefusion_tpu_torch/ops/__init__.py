"""Kernel-backed ops: the ADD-S remap (CUDA kernel + plain version)."""

from densefusion_tpu_torch.ops.knn import (
    nearest_neighbor, adds_remap, adds_remap_plain, adds_remap_targets,
    adds_remap_kernel,
)

__all__ = ["nearest_neighbor", "adds_remap", "adds_remap_plain",
           "adds_remap_targets", "adds_remap_kernel"]
