"""Fresh weights with the JAX package's initializers (the counterpart of the
flax ``kernel_init`` / ``bias_init`` choices of ``densefusion_tpu/models``).

* trunk, PSP and decoder convs: He-normal over fan-out,
  ``N(0, 2 / (out * kh * kw))`` (``layers.py:18``, the reference's conv
  init);
* dense layers (the Conv1d / Linear point layers): LeCun normal,
  truncated at two standard deviations, variance ``1 / fan_in``;
* PSPNet ``final``: zero kernel, so the embedding starts at the uniform
  log-softmax (``pspnet.py:284-292``);
* every head's last layer: variance ``0.01 / fan_in``, truncated normal,
  with the identity quaternion as the rotation head's bias, so hypotheses
  start near the identity pose at object scale (``posenet.py:98-106``,
  ``refiner.py:67-80``);
* biases zero, PReLU slopes 0.25.

torch's default init gives this BN-free network far larger first losses;
the JAX package's comments call that start unstable. Every draw comes from
an explicit generator, so a seed fixes the weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2]; flax divides by it so the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) of a torch weight (out, in, *kernel)."""
    field = math.prod(w.shape[2:])
    return w.shape[1] * field, w.shape[0] * field


@torch.no_grad()
def he_normal_fan_out_(w: torch.Tensor, generator: torch.Generator) -> None:
    std = math.sqrt(2.0 / _fans(w)[1])
    w.copy_(torch.randn(w.shape, generator=generator) * std)


@torch.no_grad()
def variance_scaling_fan_in_(w: torch.Tensor, scale: float,
                             generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = math.sqrt(scale / _fans(w)[0]) / _TRUNC_STD
    draw = torch.empty(w.shape)
    nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    w.copy_(draw)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    variance_scaling_fan_in_(w, 1.0, generator)


@torch.no_grad()
def _identity_quat_bias_(bias: torch.Tensor, num_obj: int) -> None:
    bias.zero_()
    bias.view(num_obj, 4)[:, 0] = 1.0


def _init_convs_(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            he_normal_fan_out_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.PReLU):
            nn.init.constant_(m.weight, 0.25)


def _init_dense_(layers, generator: torch.Generator) -> None:
    for m in layers:
        lecun_normal_(m.weight, generator)
        nn.init.zeros_(m.bias)


def _init_heads_(model: nn.Module, depth: int, letters: str,
                 generator: torch.Generator) -> None:
    """Heads ``conv{1..depth}_{letter}``: LeCun normal, the last layer at
    variance 0.01 / fan_in, the rotation head's last bias the identity
    quaternion."""
    for letter in letters:
        _init_dense_([getattr(model, f"conv{i}_{letter}")
                      for i in range(1, depth)], generator)
        last = getattr(model, f"conv{depth}_{letter}")
        variance_scaling_fan_in_(last.weight, 0.01, generator)
        if letter == "r":
            _identity_quat_bias_(last.bias, model.num_obj)
        else:
            nn.init.zeros_(last.bias)


def _fusion_layers(feat: nn.Module):
    return [feat.conv1, feat.e_conv1, feat.conv2, feat.e_conv2, feat.conv5,
            feat.conv6]


def init_posenet_(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights for a :class:`~densefusion_tpu_torch.models.PoseNet`."""
    psp = model.cnn.model.module
    _init_convs_(psp, generator)
    with torch.no_grad():
        psp.final[0].weight.zero_()
    _init_dense_(_fusion_layers(model.feat), generator)
    _init_heads_(model, 4, "rtc", generator)


def init_refiner_(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights for a
    :class:`~densefusion_tpu_torch.models.PoseRefineNet`."""
    _init_dense_(_fusion_layers(model.feat), generator)
    _init_heads_(model, 3, "rt", generator)
