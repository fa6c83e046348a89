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

Data parallelism (``sharding=``, a
:class:`~densefusion_tpu_torch.parallel.sharding.BatchSharding` of the
``data`` axis): each rank steps on its rows of the global batch and the
step is the one-device step on the whole batch, as JAX's single global
program is. Three things make it so. The loss is normalised by the whole
batch's valid count (one ``all_reduce`` before the forward), not the
rank's; the gradients are summed over the ranks before Adam, once per
applied update (at apply time under ``grad_accum > 1``); the dropout masks
are drawn for the whole batch and each rank keeps its rows
(``PoseNet(batch_rows=)``), so the generator advances as on one device.
The metrics are the global ones on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from densefusion_tpu_torch.losses import pose_loss, refiner_loss
from densefusion_tpu_torch.parallel.sharding import BatchSharding
from densefusion_tpu_torch.train.state import (
    GradAccum, TrainState, make_optimizer,
)


def _unpack(batch):
    return (batch.img, batch.points, batch.choose, batch.obj_idx,
            batch.target, batch.model_points, batch.sym,
            batch.valid.to(torch.float32))


class _GlobalBatch:
    """Where a rank's rows sit in the global batch, and the global valid
    count (``None`` sharding: one device, the rows are the batch)."""

    def __init__(self, sharding: BatchSharding | None, valid: torch.Tensor):
        self.sharding = sharding
        self.local_count = valid.sum()
        if sharding is None:
            self.count, self.rows = self.local_count, None
            return
        self.count = self.local_count.clone()
        dist.all_reduce(self.count, group=sharding.group)
        b = valid.shape[0]
        self.rows = (sharding.index * b, (sharding.index + 1) * b,
                     sharding.size * b)

    def loss(self, local_loss: torch.Tensor) -> torch.Tensor:
        """The rank's part of the global loss: a loss normalised by the
        rank's valid count (``pose_loss`` / ``refiner_loss`` with
        ``sample_weight``) renormalised by the global count, so the ranks'
        parts sum to the loss of the whole batch."""
        if self.sharding is None:
            return local_loss
        return local_loss * (self.local_count.clamp_min(1.0)
                             / self.count.clamp_min(1.0))

    def metrics(self, loss: torch.Tensor, dis: torch.Tensor,
                valid: torch.Tensor) -> dict:
        """``{"loss", "dis"}`` of the whole batch, on every rank: the summed
        parts of the loss and the valid mean of the best distances."""
        loss, dis_sum = loss.detach(), (dis.detach() * valid).sum()
        if self.sharding is not None:
            both = torch.stack([loss, dis_sum])
            dist.all_reduce(both, group=self.sharding.group)
            loss, dis_sum = both[0], both[1]
        return {"loss": loss, "dis": dis_sum / self.count.clamp_min(1.0)}


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


def sum_gradients(tensors: list, sharding: BatchSharding) -> None:
    """Sum ``tensors`` (gradients) over the ranks of ``sharding``, in
    place, in one flat ``all_reduce``."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=sharding.group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _apply(state: TrainState, optimizer,
           sharding: BatchSharding | None) -> None:
    """One micro-step: the rank's gradients summed over the ranks and
    Adam's step, or folded into the accumulator, which sums the ranks'
    means when it applies them."""
    sync = None if sharding is None \
        else (lambda grads: sum_gradients(grads, sharding))
    if state.accum is not None:
        state.accum.step(optimizer, sync)
        return
    if sync is not None:
        sync([p.grad for group in optimizer.param_groups
              for p in group["params"] if p.grad is not None])
    optimizer.step()


def make_pose_train_step(state: TrainState, use_adds: bool = True,
                         grad_accum: int = 1,
                         sharding: BatchSharding | None = None):
    """Phase-1 step ``step(batch, w) -> {"loss", "dis"}`` over a fresh Adam
    of the PoseNet. ``use_adds=False`` skips the ADD-S branch (datasets
    with no symmetric object). With ``sharding`` the batch is this rank's
    rows of the global batch (module docstring)."""
    optimizer = _reset_optimizer(state, state.posenet, grad_accum)

    def step(batch, w):
        img, points, choose, obj, target, model_points, sym, valid = \
            _unpack(batch)
        whole = _GlobalBatch(sharding, valid)
        state.posenet.train()
        out = state.posenet(img, points, choose, obj,
                            generator=state.generator, batch_rows=whole.rows)
        lo = pose_loss(out["pred_r"], out["pred_t"], out["pred_c"], target,
                       model_points, points, sym, w, use_adds=use_adds,
                       sample_weight=valid, pred_c_logit=out["pred_c_logit"])
        loss = whole.loss(lo.loss)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _apply(state, optimizer, sharding)
        state.step += 1
        return whole.metrics(loss, lo.dis, valid)

    return step


def make_refine_train_step(state: TrainState, refine_iters: int,
                           grad_accum: int = 1,
                           sharding: BatchSharding | None = None):
    """Phase-2 step ``step(batch, w) -> {"loss", "dis"}``: frozen PoseNet,
    ``refine_iters`` refiner iterations with summed losses, one Adam step
    over a fresh optimizer of the refiner (the phase switch resets it).
    ``sharding`` as in :func:`make_pose_train_step`."""
    optimizer = _reset_optimizer(state, state.refiner, grad_accum)

    def step(batch, w):
        img, points, choose, obj, target, model_points, sym, valid = \
            _unpack(batch)
        whole = _GlobalBatch(sharding, valid)
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
            total = total + whole.loss(rl.loss)
            pts, tgt, last_dis = rl.new_points, rl.new_target, rl.dis
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        _apply(state, optimizer, sharding)
        state.step += 1
        return whole.metrics(total, last_dis, valid)

    return step


def make_eval_step(state: TrainState, refine_iters: int, use_adds: bool):
    """Test-phase distance ``step(batch, w) -> (dis (B,), valid (B,))``:
    PoseNet and its loss, then ``refine_iters`` refiner iterations (0 in
    phase 1), all in eval mode without gradients. On a data-parallel rank
    these are its rows' (the trainer sums them over the ranks)."""

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
