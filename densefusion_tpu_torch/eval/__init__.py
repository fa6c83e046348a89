"""Inference pipeline and pose metrics."""

from densefusion_tpu_torch.eval.pipeline import InferencePipeline
from densefusion_tpu_torch.eval.metrics import (
    add_distance, adds_distance, adi_distance, pose_distances,
    rotation_error_deg, translation_error, vocap_auc,
    accuracy_under_threshold, success_rate,
)

__all__ = ["InferencePipeline", "add_distance", "adds_distance",
           "adi_distance", "pose_distances", "rotation_error_deg",
           "translation_error", "vocap_auc", "accuracy_under_threshold",
           "success_rate"]
