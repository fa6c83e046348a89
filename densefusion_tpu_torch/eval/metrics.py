"""Pose-estimation metrics (counterpart of ``densefusion_tpu/eval/metrics.py``).

ADD, ADD-S in both directions, rotation / translation errors on tensors;
VOCap AUC, <2cm accuracy and the LineMOD success rate on numpy. ADD-S goes
through :func:`densefusion_tpu_torch.ops.adds_remap_targets`, which runs the
CUDA remap kernel for CUDA tensors and its plain version for CPU ones.
"""

from __future__ import annotations

import numpy as np
import torch

from densefusion_tpu_torch.geometry import quat_to_matrix
from densefusion_tpu_torch.ops import adds_remap_targets
from densefusion_tpu_torch.utils.profiling import span


def add_distance(pred_points: torch.Tensor,
                 gt_points: torch.Tensor) -> torch.Tensor:
    """ADD: mean distance between corresponding points, (..., M, 3) x 2 ->
    (...,)."""
    return torch.linalg.vector_norm(pred_points - gt_points, dim=-1) \
        .mean(dim=-1)


def adds_distance(pred_points: torch.Tensor,
                  gt_points: torch.Tensor) -> torch.Tensor:
    """ADD-S, LineMOD direction: mean distance from each predicted point to
    its nearest gt point."""
    remapped = adds_remap_targets(pred_points, gt_points)
    return torch.linalg.vector_norm(pred_points - remapped, dim=-1) \
        .mean(dim=-1)


def adi_distance(pred_points: torch.Tensor,
                 gt_points: torch.Tensor) -> torch.Tensor:
    """ADD-S, YCB-toolbox ``adi`` direction: mean distance from each gt point
    to its nearest predicted point (the reverse of :func:`adds_distance`)."""
    remapped = adds_remap_targets(gt_points, pred_points)
    return torch.linalg.vector_norm(gt_points - remapped, dim=-1) \
        .mean(dim=-1)


def rotation_error_deg(R_est: torch.Tensor, R_gt: torch.Tensor) -> torch.Tensor:
    """Angular error in degrees, arccos((tr(R_est R_gt^T) - 1) / 2);
    (..., 3, 3) x 2 -> (...,)."""
    rel = R_est @ R_gt.transpose(-1, -2)
    cos = 0.5 * (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def translation_error(t_est: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """||t_gt - t_est||; (..., 3) x 2 -> (...,)."""
    return torch.linalg.vector_norm(t_gt - t_est, dim=-1)


@span("eval.pose_distances")
def pose_distances(model_points: torch.Tensor, quat: torch.Tensor,
                   trans: torch.Tensor, target: torch.Tensor,
                   sym: torch.Tensor) -> torch.Tensor:
    """Batched ADD(-S) of predicted poses: model (B, M, 3), quat (B, 4) wxyz,
    trans (B, 3), target (B, M, 3) gt-posed points, sym (B,) bool choosing
    ADD-S per sample -> (B,) distances. ADD-S is computed on every row, as
    the JAX package does."""
    R = quat_to_matrix(quat)
    pred = model_points @ R.transpose(-1, -2) + trans[..., None, :]
    add = add_distance(pred, target)
    adds = adds_distance(pred, target)
    return torch.where(sym.to(device=add.device, dtype=torch.bool), adds, add)


def vocap_auc(distances: np.ndarray, max_threshold: float = 0.1) -> float:
    """Area under the accuracy-vs-threshold curve with MATLAB ``VOCap``
    semantics: distances above ``max_threshold`` count as failures; the step
    integral is scaled by ``1/max_threshold`` to [0, 1]."""
    d = np.sort(np.asarray(distances, np.float64))
    n = d.size
    if n == 0:
        return 0.0
    accuracy = np.cumsum(np.ones(n)) / n
    keep = d <= max_threshold
    d, accuracy = d[keep], accuracy[keep]
    mrec = np.concatenate([[0.0], d, [max_threshold]])
    mpre = np.concatenate([[0.0], accuracy,
                           [accuracy[-1] if accuracy.size else 0.0]])
    np.maximum.accumulate(mpre, out=mpre)
    step = np.flatnonzero(np.diff(mrec)) + 1
    return float(np.sum((mrec[step] - mrec[step - 1]) * mpre[step])
                 / max_threshold)


def accuracy_under_threshold(distances: np.ndarray,
                             threshold: float = 0.02) -> float:
    """Fraction of poses with distance < threshold (the <2cm metric)."""
    d = np.asarray(distances)
    return float((d < threshold).mean()) if d.size else 0.0


def success_rate(distances: np.ndarray, thresholds: np.ndarray) -> float:
    """LineMOD protocol: success when ADD(-S) < the per-object threshold
    (0.1 x diameter)."""
    d = np.asarray(distances)
    t = np.asarray(thresholds)
    return float((d < t).mean()) if d.size else 0.0
