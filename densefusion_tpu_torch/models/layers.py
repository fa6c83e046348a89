"""Shared layer primitives (counterpart of ``densefusion_tpu/models/layers.py``).

The port computes in PyTorch's NCHW layout inside the networks; the public
model functions keep the JAX package's NHWC layout at their boundaries.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# 1-D tap->source weights of the half-pixel 2x bilinear upsample, per output
# parity: rows = conv taps (y-1, y, y+1) of output pixel y, cols = half-res
# sources (k-1, k, k+1) where k = y // 2. Even y = 2k: up[2k] =
# 0.25 x[k-1] + 0.75 x[k]; odd y = 2k+1: 0.75 x[k] + 0.25 x[k+1].
UPSAMPLE_TAPS_EVEN = ((0.75, 0.25, 0.0), (0.25, 0.75, 0.0), (0.0, 0.75, 0.25))
UPSAMPLE_TAPS_ODD = ((0.25, 0.75, 0.0), (0.0, 0.75, 0.25), (0.0, 0.25, 0.75))


def prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """Parametric ReLU with one slope, ``where(x >= 0, x, a*x)``."""
    return torch.where(x >= 0, x, slope.reshape(()) * x)


def adaptive_avg_pool2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW adaptive average pooling with torch's window convention
    (start = floor(i*H/S), end = ceil((i+1)*H/S)) — the JAX package's
    reshape-mean branch (divisible sizes) and exact-window branch (the rest)
    are both this one call."""
    return F.adaptive_avg_pool2d(x, size)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(method="bilinear")`` along
    one axis: a half-pixel triangle filter, widened by the scale factor when
    downsampling (antialiasing), normalized per output sample."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float64)[None, :])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with ``jax.image.resize``'s semantics: the
    half-pixel convention (``F.interpolate(align_corners=False)`` when
    upsampling) and an antialiasing filter when downsampling. Applied as two
    1-D weight-matrix contractions."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == tuple(out_hw):
        return x
    mh = x.new_tensor(_resize_weights(h, out_hw[0]))
    mw = x.new_tensor(_resize_weights(w, out_hw[1]))
    return torch.einsum("oh,...hw,pw->...op", mh, x, mw)


def phase_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """Compose a 3x3 conv weight (Cout, Cin, 3, 3) with the 2x half-pixel
    upsample into the four phase kernels (4*Cout, Cin, 3, 3): output channel
    ``(py*2 + px)*Cout + d`` holds ``K[py,px] = M_py^T W M_px`` for full-res
    pixel parity (py, px)."""
    m = weight.new_tensor([UPSAMPLE_TAPS_EVEN, UPSAMPLE_TAPS_ODD])
    cout, cin = weight.shape[:2]
    pk = torch.einsum("pti,quj,dctu->pqdcij", m, m, weight)
    return pk.reshape(4 * cout, cin, 3, 3)


def phase_conv_phases(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Phase-major intermediate of :func:`phase_upsample_conv3x3`: one
    half-res conv of the replicate-padded input with the four composed phase
    kernels. x (B, Cin, h, w) -> (B, 4*Cout, h, w); full-res pixel
    (2i+py, 2j+px), channel d lives at [:, (py*2+px)*Cout + d, i, j]."""
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return F.conv2d(xp, phase_conv_weight(weight), bias.repeat(4))


def phase_upsample_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """``conv3x3(replicate_pad(upsample2x_half_pixel(x)))`` computed as one
    half-res phase convolution plus a depth-to-space interleave; the
    upsampled map is never formed. x (B, Cin, h, w) -> (B, Cout, 2h, 2w)."""
    b, _, h, w = x.shape
    cout = weight.shape[0]
    y = phase_conv_phases(x, weight, bias).reshape(b, 2, 2, cout, h, w)
    return y.permute(0, 3, 4, 1, 5, 2).reshape(b, cout, 2 * h, 2 * w)


class Dropout2d(nn.Module):
    """Channel-wise dropout of an NCHW map: each (sample, channel) map is
    kept with probability ``1 - p`` and then scaled by ``1 / (1 - p)``, or
    zeroed whole (``densefusion_tpu/models/layers.py:254``). The mask is
    drawn by ``torch.bernoulli`` from the ``generator`` given to
    ``forward`` (torch's default generator when it is None). The identity in
    eval mode."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        probs = torch.full(x.shape[:2] + (1,) * (x.dim() - 2), keep,
                           dtype=x.dtype, device=x.device)
        mask = torch.bernoulli(probs, generator=generator)
        return torch.where(mask.bool(), x / keep, 0.0)
