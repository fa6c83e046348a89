"""Train and eval steps of both curriculum phases (counterpart of
``densefusion_tpu/train/steps.py``).

Phase 1 (estimator training): PoseNet in train mode, the dense hypothesis
loss, one Adam step on the PoseNet.

Phase 2 (refiner training): PoseNet frozen in eval mode, then K refiner
iterations, each with its own loss on detached inputs. The losses are
summed before one backward, which equals the reference's per-iteration
``dis.backward()`` accumulation (each iteration's loss depends only on the
refiner applied to detached inputs), then one Adam step on the refiner.

A step takes a batch of tensors on the training device
(:func:`densefusion_tpu_torch.data.to_device`) and the confidence weight
``w``, updates the :class:`TrainState` in place and returns metrics that
stay on the device: nothing in a step waits for the card. With
``grad_accum=k > 1`` a step is a micro-step: it folds its gradient into a
:class:`~densefusion_tpu_torch.train.state.GradAccum` and every k-th one
applies their mean, as ``optax.MultiSteps`` does in the JAX trainer.
"""

from __future__ import annotations

import torch

from densefusion_tpu_torch.losses import pose_loss, refiner_loss
from densefusion_tpu_torch.train.state import (
    GradAccum, TrainState, make_optimizer,
)


def _unpack(batch):
    return (batch.img, batch.points, batch.choose, batch.obj_idx,
            batch.target, batch.model_points, batch.sym,
            batch.valid.to(torch.float32))


def _valid_mean(dis: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return (dis * valid).sum() / valid.sum().clamp_min(1.0)


def _reset_optimizer(state: TrainState, module, grad_accum: int):
    """A fresh Adam over ``module`` at the current learning rate (the JAX
    trainer's ``reset_opt`` on a phase switch), and a fresh accumulator when
    ``grad_accum > 1``; the Adam becomes ``state.optimizer`` and is returned
    for the step to own."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    lr = state.optimizer.param_groups[0]["lr"]
    state.optimizer = make_optimizer(module.parameters(), lr)
    state.accum = (GradAccum(module.parameters(), grad_accum)
                   if grad_accum > 1 else None)
    return state.optimizer


def _apply(state: TrainState, optimizer) -> None:
    if state.accum is None:
        optimizer.step()
    else:
        state.accum.step(optimizer)


def make_pose_train_step(state: TrainState, use_adds: bool = True,
                         grad_accum: int = 1):
    """Phase-1 step ``step(batch, w) -> {"loss", "dis"}`` over a fresh Adam
    of the PoseNet. ``use_adds=False`` skips the ADD-S branch (datasets
    with no symmetric object)."""
    optimizer = _reset_optimizer(state, state.posenet, grad_accum)

    def step(batch, w):
        img, points, choose, obj, target, model_points, sym, valid = \
            _unpack(batch)
        state.posenet.train()
        out = state.posenet(img, points, choose, obj,
                            generator=state.generator)
        lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"], target,
                       model_points, points, sym, w, use_adds=use_adds,
                       sample_weight=valid, pred_c_logit=out["pred_c_logit"])
        optimizer.zero_grad(set_to_none=True)
        lo.loss.backward()
        _apply(state, optimizer)
        state.step += 1
        return {"loss": lo.loss.detach(),
                "dis": _valid_mean(lo.dis.detach(), valid)}

    return step


def make_refine_train_step(state: TrainState, refine_iters: int,
                           grad_accum: int = 1):
    """Phase-2 step ``step(batch, w) -> {"loss", "dis"}``: frozen PoseNet,
    ``refine_iters`` refiner iterations with summed losses, one Adam step
    over a fresh optimizer of the refiner (the phase switch resets it)."""
    optimizer = _reset_optimizer(state, state.refiner, grad_accum)

    def step(batch, w):
        img, points, choose, obj, target, model_points, sym, valid = \
            _unpack(batch)
        state.posenet.eval()
        with torch.no_grad():
            out = state.posenet(img, points, choose, obj)
            lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"],
                           target, model_points, points, sym, w,
                           use_adds=False,  # the refine phase's main loss
                           sample_weight=valid,
                           pred_c_logit=out["pred_c_logit"])
        state.refiner.train()
        total = 0.0
        pts, tgt, last_dis = lo.new_points, lo.new_target, None
        for _ in range(refine_iters):
            res = state.refiner(pts, out["emb"], obj)
            rl = refiner_loss(res["pred_r"], res["pred_t"], tgt,
                              model_points, pts, sym, use_adds=True,
                              sample_weight=valid)
            total = total + rl.loss
            pts, tgt, last_dis = rl.new_points, rl.new_target, rl.dis
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        _apply(state, optimizer)
        state.step += 1
        return {"loss": total.detach(),
                "dis": _valid_mean(last_dis.detach(), valid)}

    return step


def make_eval_step(state: TrainState, refine_iters: int, use_adds: bool):
    """Test-phase distance ``step(batch, w) -> (dis (B,), valid (B,))``:
    PoseNet and its loss, then ``refine_iters`` refiner iterations (0 in
    phase 1), all in eval mode without gradients."""

    @torch.no_grad()
    def step(batch, w):
        img, points, choose, obj, target, model_points, sym, valid = \
            _unpack(batch)
        state.posenet.eval()
        state.refiner.eval()
        out = state.posenet(img, points, choose, obj)
        lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"], target,
                       model_points, points, sym, w,
                       use_adds=use_adds and refine_iters == 0,
                       sample_weight=valid, pred_c_logit=out["pred_c_logit"])
        dis, pts, tgt = lo.dis, lo.new_points, lo.new_target
        for _ in range(refine_iters):
            res = state.refiner(pts, out["emb"], obj)
            rl = refiner_loss(res["pred_r"], res["pred_t"], tgt,
                              model_points, pts, sym, use_adds=use_adds,
                              sample_weight=valid)
            dis, pts, tgt = rl.dis, rl.new_points, rl.new_target
        return dis, valid

    return step
