"""SegNet training (counterpart of ``densefusion_tpu/train/seg.py``): Adam
and the per-pixel cross-entropy, BN statistics as the module's buffers.

The JAX ``SegTrainState`` is a pytree the jitted step donates and returns;
here the module holds the parameters and statistics, Adam its moments, and
the steps update them in place.

Checkpoints are the JAX trainer's files, in flax's msgpack layout
(:mod:`densefusion_tpu_torch.train.msgpack`), so either package reads the
other's:

* ``segnet_best.msgpack``: ``{"params", "batch_stats"}``;
* ``segnet_latest.msgpack``: those, ``opt_state`` (optax ``adam``'s
  ``{"0": {"count", "mu", "nu"}, "1": {}}``), ``epoch`` (int32) and
  ``best`` (float32);

keys sorted at every level, as the JAX trainer writes them, so a file
read and written back is the same bytes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from densefusion_tpu_torch import compat
from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.losses.seg_loss import segmentation_loss
from densefusion_tpu_torch.models.segnet import SegNet, init_segnet_
from densefusion_tpu_torch.train import msgpack
from densefusion_tpu_torch.train.state import make_optimizer
from densefusion_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class SegTrainState:
    step: int
    segnet: SegNet
    optimizer: torch.optim.Optimizer   # Adam over the parameters only


def create_seg_train_state(segnet: SegNet, lr: float = 1e-4, seed: int = 0,
                           device=None) -> SegTrainState:
    """Fresh weights from ``seed`` (drawn on the CPU, so a seed gives the
    same weights on every device), the module on ``device`` (``None`` means
    CUDA, which must be present), and Adam over its parameters."""
    dev = resolve_device(device)
    init_segnet_(segnet, torch.Generator().manual_seed(seed))
    segnet.to(dev)
    return SegTrainState(step=0, segnet=segnet,
                         optimizer=make_optimizer(segnet.parameters(), lr))


def _fg_weights(label: torch.Tensor, fg_weight: float | None):
    """Per-pixel CE weights: ``fg_weight`` on foreground (label > 0), 1 on
    background; ``None`` or 1 keeps the reference's unweighted CE."""
    if fg_weight is None or fg_weight == 1:
        return None
    return torch.where(label > 0, float(fg_weight), 1.0).float()


def make_seg_train_step(state: SegTrainState,
                        fg_weight: float | None = None):
    """``step(rgb, label) -> loss``: one Adam step on a batch (``rgb`` NCHW,
    ``label`` (B, H, W), on the module's device); BN normalizes with the
    batch statistics and updates its running ones."""
    segnet, opt = state.segnet, state.optimizer

    def step(rgb: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        with span("seg.step", units=rgb.shape[0]):
            segnet.train()
            opt.zero_grad(set_to_none=True)
            with span("seg.forward"):
                logits = segnet(rgb)
            with span("seg.loss"):
                loss = segmentation_loss(logits, label,
                                         _fg_weights(label, fg_weight))
            with span("seg.backward"):
                loss.backward()
            with span("seg.optimizer"):
                opt.step()
            state.step += 1
            return loss.detach()

    return step


def make_seg_eval_step(segnet: SegNet, fg_weight: float | None = None):
    """``step(rgb, label) -> (loss, pixel accuracy, fg IoU)`` with the
    running statistics. ``fg_weight`` weights the loss as the train step
    does, so the best checkpoint (by test loss) follows the trained
    objective. The IoU is ``|pred == gt, gt > 0| / |pred > 0 or gt > 0|``:
    pixel accuracy on full frames is mostly background."""

    @torch.no_grad()
    def step(rgb: torch.Tensor, label: torch.Tensor):
        segnet.eval()
        logits = segnet(rgb)
        loss = segmentation_loss(logits, label, _fg_weights(label, fg_weight))
        pred = logits.argmax(1)
        acc = (pred == label).float().mean()
        inter = ((pred == label) & (label > 0)).float().sum()
        union = ((pred > 0) | (label > 0)).float().sum()
        return loss, acc, inter / torch.clamp(union, min=1.0)

    return step


# -- checkpoints ------------------------------------------------------------

def _variables(segnet: SegNet) -> dict:
    return compat.segnet_variables_from_state_dict(segnet.state_dict(),
                                                   segnet.enc_counts)


def _sorted(tree: dict) -> dict:
    """Top-level keys sorted, as ``jax.device_get`` returns the JAX
    trainer's dicts (flax writes them in that order)."""
    return dict(sorted(tree.items()))


def _load_variables(segnet: SegNet, tree: dict) -> None:
    sd = compat.segnet_state_dict_from_flax(tree, segnet.enc_counts)
    segnet.load_state_dict(sd, strict=True)


def save_segnet(path: str, segnet: SegNet) -> None:
    """Write ``segnet_best.msgpack``: ``{"params", "batch_stats"}``."""
    with open(path, "wb") as f:
        f.write(msgpack.pack(_sorted(_variables(segnet))))


def load_segnet(path: str, segnet: SegNet) -> SegNet:
    """Load a ``segnet_best.msgpack`` (or the parameters and statistics of a
    ``segnet_latest.msgpack``) into ``segnet``, on its device."""
    with open(path, "rb") as f:
        _load_variables(segnet, msgpack.unpack(f.read()))
    return segnet


def save_seg_latest(path: str, state: SegTrainState, epoch: int,
                    best: float) -> None:
    """Write the resumable ``segnet_latest.msgpack`` through a temporary
    file renamed over it."""
    tree = _variables(state.segnet)
    tree["opt_state"] = compat.adam_to_optax(state.optimizer, state.segnet,
                                             "segnet")
    # 0-d arrays, as jax.device_get hands the JAX trainer's scalars to flax
    tree["epoch"] = np.asarray(epoch, np.int32)
    tree["best"] = np.asarray(best, np.float32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.pack(_sorted(tree)))
    os.replace(tmp, path)


def load_seg_latest(path: str, state: SegTrainState) -> tuple[int, float]:
    """Restore a ``segnet_latest.msgpack`` into ``state`` -> ``(epoch,
    best)``; Adam's moments match parameters by name."""
    with open(path, "rb") as f:
        raw = msgpack.unpack(f.read())
    _load_variables(state.segnet, raw)
    compat.adam_from_optax(state.optimizer, state.segnet, "segnet",
                           raw["opt_state"])
    state.step = int(np.asarray(raw["opt_state"]["0"]["count"]))
    return int(np.asarray(raw["epoch"])), float(np.asarray(raw["best"]))
