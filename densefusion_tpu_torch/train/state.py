"""Train state and curriculum bookkeeping (counterpart of
``densefusion_tpu/train/state.py``).

The JAX ``TrainState`` is an immutable pytree donated to and returned by
each jitted step. Here it is an object the steps mutate in place, which is
the PyTorch idiom: the modules hold the parameters, the optimizer its
moments, and a ``torch.Generator`` on the training device draws the
dropout masks.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.models.init import init_posenet_, init_refiner_


@dataclasses.dataclass
class TrainState:
    step: int                        # optimizer steps taken, both phases
    posenet: nn.Module
    refiner: nn.Module
    optimizer: torch.optim.Optimizer  # Adam of the ACTIVE phase's module
    generator: torch.Generator       # dropout masks, on the training device


@dataclasses.dataclass
class Curriculum:
    """Host-side curriculum flags (``tools/train.py:86-97,219-251``)."""

    epoch: int = 1
    rep_in_epoch: int = 0           # repeat_epoch repetition cursor
    batch_in_epoch: int = 0         # data cursor for mid-epoch resume
    best_test: float = float("inf")
    lr: float = 1e-4
    w: float = 0.015
    decay_started: bool = False
    refine_started: bool = False
    refine_steps: int = 0           # phase-2 steps taken so far

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Curriculum":
        # tolerate unknown keys (state written by newer versions)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam with b1 0.9, b2 0.999, eps 1e-8 added after ``sqrt(v_hat)``:
    optax's ``adam`` as the JAX package builds it."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(posenet: nn.Module, refiner: nn.Module, lr: float,
                       seed: int, device=None) -> TrainState:
    """Fresh weights from ``seed`` with the JAX package's initializers
    (drawn on the CPU, so a seed gives the same weights on every device),
    the modules moved to ``device`` (``None`` means CUDA, which must be
    present), a phase-1 optimizer over the PoseNet, and the dropout
    generator seeded from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    init_posenet_(posenet, gen)
    init_refiner_(refiner, gen)
    posenet.to(dev)
    refiner.to(dev)
    dropout = torch.Generator(device=dev).manual_seed(seed + 1)
    return TrainState(step=0, posenet=posenet, refiner=refiner,
                      optimizer=make_optimizer(posenet.parameters(), lr),
                      generator=dropout)
