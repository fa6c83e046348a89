"""Losses: the dense ADD(-S) pose-hypothesis loss with confidence
self-calibration and the refiner's residual loss."""

from densefusion_tpu_torch.losses.pose_loss import (
    pose_loss, refiner_loss, PoseLossOutput, RefinerLossOutput,
)

__all__ = ["pose_loss", "refiner_loss", "PoseLossOutput", "RefinerLossOutput"]
