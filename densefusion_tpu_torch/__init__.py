"""densefusion_tpu_torch — the PyTorch / CUDA port of densefusion_tpu.

A package of its own beside the JAX package: it imports torch, numpy and
scipy, never jax and nothing of ``densefusion_tpu``. Its entry points run on
CUDA unless the caller passes ``device="cpu"``; every TPU kernel on a ported
path is a hand-written Hopper kernel under ``csrc/`` with its plain PyTorch
version beside its wrapper.

Ported so far: the serving and scoring path (PoseNet, the 2-iteration
refine, ADD / ADD-S), with the ADD-S remap kernel.
"""

from densefusion_tpu_torch.serve import PoseEstimator
from densefusion_tpu_torch.eval import InferencePipeline, pose_distances

__all__ = ["PoseEstimator", "InferencePipeline", "pose_distances"]
