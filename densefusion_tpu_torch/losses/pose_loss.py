"""Dense pose-hypothesis losses (ADD / ADD-S) with confidence
self-calibration (counterpart of ``densefusion_tpu/losses/pose_loss.py``).

* Every per-point hypothesis ``(q_i, t_i, c_i)`` transforms the model
  points, with the translation an offset from the observed point
  (``t_i = points_i + pred_t_i``); its mean distance to the target comes
  from :func:`densefusion_tpu_torch.ops.hypothesis_mean_dist` (ADD, or
  ADD-S on symmetric rows), whose backward is the kernels' coefficients.
* Confidence self-calibration: ``loss = mean(dis * c - w * log c)``, the
  barrier taken as ``log_sigmoid`` of the logits when they are given.
* The argmax-confidence hypothesis canonicalizes the cloud and the target
  into its frame for the refiner, ``p' = (p - t*) @ R*``, detached.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from densefusion_tpu_torch.geometry import quat_normalize, quat_to_matrix
from densefusion_tpu_torch.ops.add_dist import hypothesis_mean_dist


class PoseLossOutput(NamedTuple):
    loss: torch.Tensor        # scalar: optimize this
    dis: torch.Tensor         # (B,) distance of the best hypothesis
    new_points: torch.Tensor  # (B, N, 3) cloud in the best frame, detached
    new_target: torch.Tensor  # (B, M, 3) target in the best frame, detached
    best_r: torch.Tensor      # (B, 4) best quaternion, normalized, detached
    best_t: torch.Tensor      # (B, 3) best translation, absolute, detached


class RefinerLossOutput(NamedTuple):
    loss: torch.Tensor        # scalar mean distance: optimize this
    dis: torch.Tensor         # (B,) per-sample distance
    new_points: torch.Tensor  # (B, N, 3) re-canonicalized cloud, detached
    new_target: torch.Tensor  # (B, M, 3) re-canonicalized target, detached


def _weighted_mean(x: torch.Tensor, sample_weight) -> torch.Tensor:
    """Mean of (B,) ``x``, or its ``sample_weight``-weighted mean."""
    if sample_weight is None:
        return x.mean()
    sw = sample_weight.to(x.dtype)
    return (x * sw).sum() / sw.sum().clamp_min(1.0)


def pose_loss(pred_r, pred_t, pred_c, target, model_points, points, sym, w,
              *, use_adds: bool = True, sample_weight=None,
              pred_c_logit=None) -> PoseLossOutput:
    """Dense per-point-hypothesis ADD(-S) loss.

    pred_r (B, N, 4) unnormalized quaternions, pred_t (B, N, 3) offsets from
    the observed points, pred_c (B, N) confidences, target (B, M, 3),
    model_points (B, M, 3), points (B, N, 3), sym (B,) bool, w the
    confidence weight. ``use_adds=False`` turns the ADD-S branch off (the
    refine phase's main loss). ``sample_weight`` (B,) weights the samples
    (the batch's ``valid`` mask); ``pred_c_logit`` (B, N), when given, makes
    the barrier ``-w * log_sigmoid(logit)``, whose gradient does not
    underflow for collapsed confidences."""
    q = quat_normalize(pred_r)
    R = quat_to_matrix(q)                                    # (B, N, 3, 3)
    t = points + pred_t                                      # (B, N, 3)
    dis = hypothesis_mean_dist(R, t, model_points, target, sym,
                               use_adds=use_adds)
    if pred_c_logit is not None:
        log_c = F.logsigmoid(pred_c_logit)
    else:
        log_c = torch.log(pred_c.clamp_min(1e-38))
    per_point = dis * pred_c - w * log_c
    if sample_weight is None:
        loss = per_point.mean()
    else:
        loss = _weighted_mean(per_point.mean(dim=1), sample_weight)

    best = pred_c.argmax(dim=1)                              # (B,)
    rows = torch.arange(best.shape[0], device=best.device)
    best_r, best_t, best_R = q[rows, best], t[rows, best], R[rows, best]
    new_points = (points - best_t[:, None, :]) @ best_R
    new_target = (target - best_t[:, None, :]) @ best_R
    return PoseLossOutput(loss=loss, dis=dis[rows, best],
                          new_points=new_points.detach(),
                          new_target=new_target.detach(),
                          best_r=best_r.detach(), best_t=best_t.detach())


def refiner_loss(pred_r, pred_t, target, model_points, points, sym, *,
                 use_adds: bool = True,
                 sample_weight=None) -> RefinerLossOutput:
    """Residual-pose refinement loss: one hypothesis per sample, its ADD(-S)
    distance with no confidence term, and the next canonicalization of
    (points, target) by the residual pose. pred_r (B, 4), pred_t (B, 3) in
    the current canonical frame; target and points arrive canonicalized by
    the previous stage."""
    R = quat_to_matrix(quat_normalize(pred_r))               # (B, 3, 3)
    dis = hypothesis_mean_dist(R[:, None], pred_t[:, None], model_points,
                               target, sym, use_adds=use_adds)[:, 0]
    new_points = (points - pred_t[:, None, :]) @ R
    new_target = (target - pred_t[:, None, :]) @ R
    return RefinerLossOutput(loss=_weighted_mean(dis, sample_weight),
                             dis=dis, new_points=new_points.detach(),
                             new_target=new_target.detach())
