"""Kernel-backed ops: the 1-NN search, the ADD-S remap and min distance,
the fused ADD / ADD-S hypothesis distance and the decoder's 3x3 VALID
convolution (CUDA kernels, each with its plain version). ``knn.knn`` (k-NN)
stays in its module: the name ``knn`` here is the module."""

from densefusion_tpu_torch.ops.knn import (
    nearest_neighbor, nearest_neighbor_plain, nearest_neighbor_plain_batched,
    nn_kernel, nn_batched_kernel, adds_remap, adds_remap_plain,
    adds_remap_targets, adds_remap_kernel, adds_min_sqdist_minus_qsq,
)
from densefusion_tpu_torch.ops.add_dist import hypothesis_mean_dist
from densefusion_tpu_torch.ops.phase_conv import (
    conv3x3_valid, conv3x3_valid_nchw, conv3x3_valid_plain,
    conv3x3_valid_plain_nchw, conv3x3_valid_library, phase_conv_kernel,
    phase_conv_bf16_kernel,
)

__all__ = ["nearest_neighbor", "nearest_neighbor_plain",
           "nearest_neighbor_plain_batched", "nn_kernel",
           "nn_batched_kernel", "adds_remap", "adds_remap_plain",
           "adds_remap_targets", "adds_remap_kernel",
           "adds_min_sqdist_minus_qsq", "hypothesis_mean_dist",
           "conv3x3_valid", "conv3x3_valid_nchw", "conv3x3_valid_plain",
           "conv3x3_valid_plain_nchw", "conv3x3_valid_library",
           "phase_conv_kernel", "phase_conv_bf16_kernel"]
