"""SegNet semantic segmentation (counterpart of
``densefusion_tpu/models/segnet.py``): a VGG16-shape encoder of conv + BN +
ReLU layers in five pooling stages, and a mirrored decoder that unpools
with the encoder's argmax positions.

The module takes and returns NCHW maps, as the reference's torch SegNet
does: ``(B, 3, H, W)`` -> ``(B, num_classes, H, W)`` logits, H and W
divisible by 32. Its parameters carry the reference's names
(``vanilla_segmentation/segnet.py:12-71``): encoder ``conv{s}{i}`` /
``bn{s}{i}``, decoder ``conv{s}{j}d`` / ``bn{s}{j}d`` applied in
descending ``j``, and the classifier ``conv11d``; so a reference
``state_dict`` loads as it is, and :mod:`densefusion_tpu_torch.compat`
carries the JAX package's variables across.

On the card its forward convolutions run through ATen's own float32
convolution (im2col and a cuBLAS GEMM), not cuDNN: with TF32 off, cuDNN's
heuristic takes an FFT algorithm for ``conv31d`` (256 -> 128 channels at
120x160) that costs 423 ms of a ~470 ms B=4 forward at 480x640, and its
autotuner keeps it; ATen's takes that layer in 1.8 ms and the forward's
26 convolutions in ~63 ms. Autograd picks the backward's route when it
runs it, with cuDNN on (``examples/gpu_segnet_profile.py``, NVIDIA H100).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from densefusion_tpu_torch.models.init import he_normal_fan_out_
from densefusion_tpu_torch.models.layers import max_pool_argmax, max_unpool

ENC_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
              (512, 512, 512))
DEC_STAGES = ((512, 512, 512), (512, 512, 256), (256, 256, 128), (128, 64),
              (64,))


class BatchNorm2d(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over an NCHW map.

    Training normalizes with the batch statistics as flax computes them,
    ``mean(x)`` and the biased ``mean(x^2) - mean(x)^2`` (clamped at 0),
    and folds the same two into the running ones. ``nn.BatchNorm2d``
    updates ``running_var`` with the *unbiased* variance, n / (n - 1)
    larger, which doubles it where a stage holds n = 2 values per channel;
    and where ``x``'s mean is large against its spread flax's one-pass
    variance rounds away digits that torch's keeps. The buffers are the
    reference's ``running_mean`` / ``running_var``, with no
    ``num_batches_tracked``.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = torch.clamp(x.square().mean(dims) - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _names(enc_counts: Sequence[int], dec_counts: Sequence[int]):
    """(encoder names per stage, decoder names per stage): the reference's
    ``conv{s}{i}`` and ``conv{t}{j}d``, the decoder's stage s unpooling the
    encoder's stage t = 6 - s and its convs numbered down from that stage's
    count."""
    enc = [[f"{s}{i}" for i in range(1, n + 1)]
           for s, n in enumerate(enc_counts, start=1)]
    dec = []
    for s, n in enumerate(dec_counts, start=1):
        t = len(enc_counts) + 1 - s
        top = enc_counts[t - 1]
        dec.append([f"{t}{top - i + 1}d" for i in range(1, n + 1)])
    return enc, dec


class SegNet(nn.Module):
    """``(B, 3, H, W)`` -> ``(B, num_classes, H, W)`` logits; H and W
    divisible by 32. ``enc_stages`` / ``dec_stages`` are the JAX fields:
    each stage's conv widths (narrow ones for tests)."""

    def __init__(self, num_classes: int = 22,
                 enc_stages: Sequence[Sequence[int]] = ENC_STAGES,
                 dec_stages: Sequence[Sequence[int]] = DEC_STAGES):
        super().__init__()
        self.num_classes = num_classes
        self.enc_counts = tuple(len(w) for w in enc_stages)
        self.dec_counts = tuple(len(w) for w in dec_stages)
        enc_names, dec_names = _names(self.enc_counts, self.dec_counts)
        self.enc_layers = [list(n) for n in enc_names]
        self.dec_layers = [list(n) for n in dec_names]
        cin = 3
        for names, widths in zip(enc_names + dec_names,
                                 list(enc_stages) + list(dec_stages)):
            for name, w in zip(names, widths):
                setattr(self, f"conv{name}", nn.Conv2d(cin, w, 3, padding=1))
                setattr(self, f"bn{name}", BatchNorm2d(w))
                cin = w
        self.conv11d = nn.Conv2d(cin, num_classes, 3, padding=1)

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"conv{name}")(x)
        return F.relu(getattr(self, f"bn{name}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        route = (torch.backends.cudnn.flags(enabled=False, allow_tf32=False)
                 if x.is_cuda else contextlib.nullcontext())
        with route:
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        indices = []
        for names in self.enc_layers:
            for name in names:
                x = self._block(name, x)
            x, idx = max_pool_argmax(x)
            indices.append(idx)
        for s, names in enumerate(self.dec_layers):
            x = max_unpool(x, indices[-(s + 1)])
            for name in names:
                x = self._block(name, x)
        return self.conv11d(x)


def init_segnet_(model: SegNet, generator: torch.Generator) -> None:
    """Fresh weights with the JAX package's initializers: He-normal over
    fan-out for every conv, zero biases, BN scale 1 and shift 0, running
    mean 0 and variance 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            he_normal_fan_out_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
