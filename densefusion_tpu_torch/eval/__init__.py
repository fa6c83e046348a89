"""Inference pipeline, shape-bucketed dispatch, pose metrics and the YCB
keyframe scorer."""

from densefusion_tpu_torch.eval.pipeline import InferencePipeline
from densefusion_tpu_torch.eval.bucketed import ShapeBucketedDispatcher
from densefusion_tpu_torch.eval.metrics import (
    add_distance, adds_distance, adi_distance, pose_distances,
    rotation_error_deg, translation_error, vocap_auc,
    accuracy_under_threshold, success_rate,
)
from densefusion_tpu_torch.eval.ycb_toolbox import (
    KeyframeResults, plot_accuracy, score_keyframes, summarize,
)

__all__ = ["InferencePipeline", "ShapeBucketedDispatcher", "add_distance",
           "adds_distance", "adi_distance", "pose_distances",
           "rotation_error_deg", "translation_error", "vocap_auc",
           "accuracy_under_threshold", "success_rate", "KeyframeResults",
           "score_keyframes", "summarize", "plot_accuracy"]
