"""Shared layer primitives (counterpart of ``densefusion_tpu/models/layers.py``).

The port computes in PyTorch's NCHW layout inside the networks; the public
model functions keep the JAX package's NHWC layout at their boundaries.

Compute type: every layer computes in its input's type and casts its
float32 parameters to that type where it uses them (:func:`cast`), where
the JAX package's modules cast them under ``dtype=jnp.bfloat16``; the
gradient flows back through the cast to the float32 parameter. A float32
input leaves every cast a no-op.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from densefusion_tpu_torch.ops.phase_conv import (
    conv3x3_valid_nchw, replicate_pad,
)

# 1-D tap->source weights of the half-pixel 2x bilinear upsample, per output
# parity: rows = conv taps (y-1, y, y+1) of output pixel y, cols = half-res
# sources (k-1, k, k+1) where k = y // 2. Even y = 2k: up[2k] =
# 0.25 x[k-1] + 0.75 x[k]; odd y = 2k+1: 0.75 x[k] + 0.25 x[k+1].
UPSAMPLE_TAPS_EVEN = ((0.75, 0.25, 0.0), (0.25, 0.75, 0.0), (0.0, 0.75, 0.25))
UPSAMPLE_TAPS_ODD = ((0.25, 0.75, 0.0), (0.0, 0.75, 0.25), (0.0, 0.25, 0.75))


def cast(t: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """A parameter ``t`` in ``x``'s compute type (None stays None)."""
    return None if t is None else t.to(x.dtype)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` with its weight and bias cast to ``x``'s type. Outside
    float32 the bias is added after the convolution's rounding to that
    type, as flax's ``Conv`` adds it."""
    y = F.conv2d(x, cast(conv.weight, x),
                 cast(conv.bias, x) if x.dtype == torch.float32 else None,
                 conv.stride, conv.padding, conv.dilation)
    if x.dtype == torch.float32 or conv.bias is None:
        return y
    return y + cast(conv.bias, x)[:, None, None]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """``F.linear`` in ``x``'s type; outside float32 the bias is added after
    the product's rounding, as flax's ``Dense`` adds it."""
    if x.dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(x, cast(weight, x)) + cast(bias, x)


def prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """Parametric ReLU with one slope, ``where(x >= 0, x, a*x)``; the slope
    in ``x``'s type (``densefusion_tpu/models/layers.py:30``)."""
    return torch.where(x >= 0, x, cast(slope.reshape(()), x) * x)


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


def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of the ``align_corners=True`` bilinear resize
    along one axis: source coordinate ``i * (n_in-1)/(n_out-1)``, rounded in
    float32 as the JAX package rounds it (a size of 1 maps everything to
    source 0, as torch does)."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(n_out, dtype=np.float32) * np.float32(
        (n_in - 1) / (n_out - 1))
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - i0.astype(np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - frac)
    np.add.at(m, (rows, i0 + 1), frac)
    return m


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """NCHW bilinear resize, applied as two 1-D weight-matrix contractions.
    ``align_corners=False`` has ``jax.image.resize``'s semantics: the
    half-pixel convention (``F.interpolate(align_corners=False)`` when
    upsampling) and an antialiasing filter when downsampling; the PSP priors
    use it. ``align_corners=True`` is the reference decoder's
    ``nn.Upsample(..., align_corners=True)``, which imported reference
    weights need to reproduce the reference's activations."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == tuple(out_hw):
        return x
    weights = _align_corners_matrix if align_corners else _resize_weights
    mh = x.new_tensor(weights(h, out_hw[0]))
    mw = x.new_tensor(weights(w, out_hw[1]))
    return torch.einsum("oh,...hw,pw->...op", mh, x, mw)


def phase_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """Compose a 3x3 conv weight (Cout, Cin, 3, 3) with the 2x half-pixel
    upsample into the four phase kernels, HWIO (3, 3, Cin, 4*Cout): output
    channel ``(py*2 + px)*Cout + d`` holds ``K[py,px] = M_py^T W M_px`` for
    full-res pixel parity (py, px). Composed in the weight's type, so a
    bf16 weight is composed in bf16 after its cast, as the JAX package
    composes it (``densefusion_tpu/models/layers.py:99-104``), in its
    order: the rows' taps (t) first, each contraction rounded to the type,
    then the columns' (u)."""
    m = weight.new_tensor([UPSAMPLE_TAPS_EVEN, UPSAMPLE_TAPS_ODD])
    cout, cin = weight.shape[:2]
    rows = torch.einsum("pti,dctu->dcupi", m, weight)
    pk = torch.einsum("dcupi,quj->ijcpqd", rows, m)
    return pk.reshape(3, 3, cin, 4 * cout)


def phase_conv_phases(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor,
                      conv_backend: str = "auto") -> torch.Tensor:
    """Phase-major intermediate of :func:`phase_upsample_conv3x3` (replicate
    border): one half-res VALID conv of the replicate-padded input with the
    four composed phase kernels. x (B, Cin, h, w) -> (B, 4*Cout, h, w);
    full-res pixel (2i+py, 2j+px), channel d lives at
    [:, (py*2+px)*Cout + d, i, j]. ``conv_backend`` picks the convolution's
    route (:func:`densefusion_tpu_torch.ops.phase_conv.conv3x3_valid`):
    "kernel" is ``csrc/phase_conv.cu``, "library" ``F.conv2d``, "auto"
    :func:`densefusion_tpu_torch.ops.phase_conv.auto_backend` of the input's
    device. The weight and bias are cast to ``x``'s type first. The padded
    map is in the layout the route takes
    (:func:`densefusion_tpu_torch.ops.phase_conv.replicate_pad`:
    channels-last for the bf16 kernel)."""
    xp = replicate_pad(x, conv_backend)
    y = conv3x3_valid_nchw(xp, phase_conv_weight(cast(weight, x)),
                           conv_backend)
    return y + cast(bias, y).repeat(4)[:, None, None]


def _edge_upsample_1d(v: torch.Tensor) -> torch.Tensor:
    """Extended 2x half-pixel upsample along the last axis: length n ->
    2n + 2, covering upsampled coordinates -1 .. 2n (one phantom sample each
    side, edge-clamped): the boundary helper of the zero border."""
    vp = torch.cat([v[..., :1], v, v[..., -1:]], dim=-1)     # n + 2
    even = 0.25 * vp[..., :-1] + 0.75 * vp[..., 1:]          # 0, 2, .., 2n
    odd = 0.75 * vp[..., :-1] + 0.25 * vp[..., 1:]           # -1, 1, .., 2n-1
    return torch.stack([odd, even], dim=-1).flatten(-2)      # -1 .. 2n


def phase_upsample_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, border: str = "zero",
                           conv_backend: str = "auto") -> torch.Tensor:
    """``conv3x3(pad(upsample2x_half_pixel(x)))`` computed as one half-res
    phase convolution plus a depth-to-space interleave; the upsampled map is
    never formed. x (B, Cin, h, w) -> (B, Cout, 2h, 2w).

    ``border="replicate"`` is the phase formulation's native border (the
    uniform formula over an edge-padded input is a replicate-padded conv).
    ``border="zero"`` reproduces zero conv padding exactly by subtracting
    the phantom border taps' contributions from the outermost ring, the
    corner taps counted once (``densefusion_tpu/models/layers.py:143-180``)."""
    if border not in ("zero", "replicate"):
        raise ValueError(f"unknown border {border!r}")
    b, _, h, w = x.shape
    cout = weight.shape[0]
    weight = cast(weight, x)
    y = phase_conv_phases(x, weight, bias, conv_backend)
    y = y.reshape(b, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2)
    y = y.reshape(b, cout, 2 * h, 2 * w)
    if border == "replicate":
        return y
    # each ring correction is a VALID 1-D conv of the clamped upsampled
    # border line with one row (or column) of taps
    corr_top = F.conv1d(_edge_upsample_1d(x[:, :, 0]), weight[:, :, 0])
    corr_bot = F.conv1d(_edge_upsample_1d(x[:, :, -1]), weight[:, :, 2])
    corr_left = F.conv1d(_edge_upsample_1d(x[..., 0]), weight[..., 0])
    corr_right = F.conv1d(_edge_upsample_1d(x[..., -1]), weight[..., 2])
    # a corner tap lies in one row and one column correction: take it out of
    # the column vectors so it is subtracted once
    for corr, col, kw in ((corr_left, 0, 0), (corr_right, -1, 2)):
        corr[..., 0] -= x[:, :, 0, col] @ weight[:, :, 0, kw].t()
        corr[..., -1] -= x[:, :, -1, col] @ weight[:, :, 2, kw].t()
    y = torch.cat([y[..., :1] - corr_left[..., None], y[..., 1:-1],
                   y[..., -1:] - corr_right[..., None]], dim=-1)
    return torch.cat([y[:, :, :1] - corr_top[:, :, None], y[:, :, 1:-1],
                      y[:, :, -1:] - corr_bot[:, :, None]], dim=2)


class Dropout2d(nn.Module):
    """Channel-wise dropout of an NCHW map: each (sample, channel) map is
    kept with probability ``1 - p`` and then scaled by ``1 / (1 - p)``, or
    zeroed whole (``densefusion_tpu/models/layers.py:254``). The mask is
    drawn by ``torch.bernoulli`` from the ``generator`` given to
    ``forward`` (torch's default generator when it is None), with float32
    keep probabilities whatever ``x``'s type (flax's Bernoulli draw takes a
    Python float; a bf16 0.7 would be 0.69921875), and applied in ``x``'s
    type. The identity in eval mode.

    ``batch_rows=(start, stop, total)`` says that ``x`` holds rows
    ``start:stop`` of a batch of ``total`` (one rank's rows of a
    data-parallel batch): the mask is drawn for the whole batch and its
    rows kept, so the masks and the generator's next state are the ones a
    forward over the whole batch on one device gives."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                batch_rows: tuple[int, int, int] | None = None
                ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        start, stop, total = batch_rows or (0, x.shape[0], x.shape[0])
        if not 0 <= start <= stop <= total or stop - start != x.shape[0]:
            raise ValueError(f"batch_rows {batch_rows} do not fit a batch "
                             f"of {x.shape[0]} rows")
        keep = 1.0 - self.p
        probs = torch.full((total,) + x.shape[1:2] + (1,) * (x.dim() - 2),
                           keep, dtype=torch.float32, device=x.device)
        mask = torch.bernoulli(probs, generator=generator)[start:stop]
        return torch.where(mask.bool(), x / keep, 0.0)


def max_pool_argmax(x: torch.Tensor, window: int = 2
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``window`` x ``window`` max pool of an NCHW map, stride ``window``,
    returning ``(pooled, indices)`` for :func:`max_unpool` (counterpart of
    ``densefusion_tpu/models/layers.py:221``). ``indices`` are torch's flat
    positions within each (H, W) plane; ties go to the first position of the
    window in row-major order, as the JAX ``argmax`` breaks them. Rows and
    columns past the last whole window are dropped.

    The gradient goes to the argmax alone; ``jnp.max`` splits it evenly
    among tied positions. After a ReLU a tie is a window of zeros, whose
    ReLU gradient is 0 in both frameworks."""
    return F.max_pool2d(x, window, window, return_indices=True)


def max_unpool(x: torch.Tensor, indices: torch.Tensor,
               window: int = 2) -> torch.Tensor:
    """Inverse of :func:`max_pool_argmax`: each pooled value at its argmax
    position, zeros elsewhere, in a map ``window`` times larger
    (``densefusion_tpu/models/layers.py:240``)."""
    h, w = x.shape[-2:]
    return F.max_unpool2d(x, indices, window, window,
                          output_size=(h * window, w * window))
