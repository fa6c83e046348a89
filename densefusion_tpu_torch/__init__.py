"""densefusion_tpu_torch — the PyTorch / CUDA port of densefusion_tpu.

A package of its own beside the JAX package: it imports torch, numpy and
scipy, never jax and nothing of ``densefusion_tpu``. Its entry points run on
CUDA unless the caller passes ``device="cpu"``; every TPU kernel on a ported
path is a hand-written Hopper kernel under ``csrc/`` with its plain PyTorch
version beside its wrapper.

It holds serving and scoring (PoseNet, the iterative refiner, ADD /
ADD-S), both training phases and the curriculum trainer, the searches and
their sharded forms, the three decoders, the LineMOD / YCB / customCAD
data plane, checkpoints in the JAX package's format, the training and
evaluation CLIs, SegNet (model, trainer, ``cli.train_seg`` and
``cli.segment``) and the FallingThings tools; every kernel of the JAX
package has its Hopper counterpart. ``ROADMAP.md`` lists what is not
ported yet.
"""

from densefusion_tpu_torch.serve import PoseEstimator
from densefusion_tpu_torch.eval import InferencePipeline, pose_distances

__all__ = ["PoseEstimator", "InferencePipeline", "pose_distances"]
