"""Train state and curriculum bookkeeping (counterpart of
``densefusion_tpu/train/state.py``).

The JAX ``TrainState`` is an immutable pytree donated to and returned by
each jitted step. Here it is an object the steps mutate in place, which is
the PyTorch idiom: the modules hold the parameters, the optimizer its
moments, and a ``torch.Generator`` on the training device draws the
dropout masks. With ``grad_accum > 1`` a :class:`GradAccum` stands where
the JAX package wraps Adam in ``optax.MultiSteps``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.models.init import init_posenet_, init_refiner_


class GradAccum:
    """``optax.MultiSteps`` around the step's Adam: each micro-step folds
    its gradient into a running mean, ``acc + (g - acc) / (n + 1)`` as
    optax computes it, and the ``k``-th applies the mean with one Adam step
    and clears it. ``mini_step`` / ``gradient_step`` are MultiSteps'
    counters, kept for the checkpoint; ``acc`` follows ``params``' order
    (the module's ``named_parameters()``)."""

    def __init__(self, params, k: int):
        self.k = k
        self.params = list(params)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        self.gradient_step = 0

    def step(self, optimizer: torch.optim.Optimizer, sync=None) -> None:
        """Fold the parameters' ``.grad`` into the mean; on the k-th
        micro-step, step ``optimizer`` on the mean. ``sync(grads)``, when
        given, reduces the mean in place first (a data-parallel rank sums
        the ranks' means: once per applied update)."""
        n = self.mini_step
        for p, a in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(a)
            a.add_((g - a) / (n + 1))
        if n + 1 < self.k:
            self.mini_step = n + 1
            return
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone()
        if sync is not None:
            sync([p.grad for p in self.params])
        optimizer.step()
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        self.gradient_step += 1


@dataclasses.dataclass
class TrainState:
    step: int                        # micro-steps taken, both phases
    posenet: nn.Module
    refiner: nn.Module
    optimizer: torch.optim.Optimizer  # Adam of the ACTIVE phase's module
    generator: torch.Generator       # dropout masks, on the training device
    accum: GradAccum | None = None   # set by a step with grad_accum > 1
    # the JAX PRNG key a checkpoint carries (threefry key data [hi, lo]);
    # the port draws nothing from it and writes it back as it was read
    rng_key: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, np.uint32))


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
    present), a phase-1 optimizer over the PoseNet, the dropout generator
    seeded from ``seed + 1``, and ``rng_key`` the key data of
    ``jax.random.key(seed)``, ``[0, seed]``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    init_posenet_(posenet, gen)
    init_refiner_(refiner, gen)
    posenet.to(dev)
    refiner.to(dev)
    dropout = torch.Generator(device=dev).manual_seed(seed + 1)
    return TrainState(step=0, posenet=posenet, refiner=refiner,
                      optimizer=make_optimizer(posenet.parameters(), lr),
                      generator=dropout,
                      rng_key=np.array([0, seed], np.uint32))
