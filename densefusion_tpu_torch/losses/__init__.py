"""Losses: the dense ADD(-S) pose-hypothesis loss with confidence
self-calibration, the refiner's residual loss, and SegNet's segmentation
cross-entropy."""

from densefusion_tpu_torch.losses.pose_loss import (
    pose_loss, refiner_loss, PoseLossOutput, RefinerLossOutput,
)
from densefusion_tpu_torch.losses.seg_loss import segmentation_loss

__all__ = ["pose_loss", "refiner_loss", "segmentation_loss",
           "PoseLossOutput", "RefinerLossOutput"]
