"""PSPNet per-pixel embedding network (counterpart of
``densefusion_tpu/models/pspnet.py``).

Dilated ResNet trunk -> pyramid pooling over sizes (1, 2, 3, 6) -> 1x1
bottleneck to 1024 -> three 2x upsample + conv3x3 + PReLU stages
(1024 -> 256 -> 64 -> 64) -> 1x1 conv to a 32-channel embedding ->
log-softmax over channels.

Three decoders, as in the JAX package: the fused one (the default: every
upsample stage a half-res phase convolution with replicate borders), the
dense zero-border one (``fused_decoder=False``) and the reference-exact
align-corners one (``align_corners=True``). With ``sample_at`` the last
stage is decoded sparsely at the requested pixels only. Train mode adds
the JAX package's channel dropout (0.3 after the PSP module, 0.15 after up1
and after up2), drawn from the generator passed to ``forward``; eval mode
has none. Module names follow the reference's state_dict keys, and every
decoder reads the same ones.

``dtype=torch.bfloat16`` computes the trunk, the PSP module, the decoder
and ``final`` in bf16 (the layers cast their float32 parameters where they
use them, as the JAX package's ``dtype`` does); the log-softmax stays in
float32 (``densefusion_tpu/models/pspnet.py:354-357``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from densefusion_tpu_torch.models.layers import (
    UPSAMPLE_TAPS_EVEN, UPSAMPLE_TAPS_ODD, Dropout2d, cast, conv2d, linear,
    prelu, adaptive_avg_pool2d, resize_bilinear, phase_conv_phases,
    phase_upsample_conv3x3,
)
from densefusion_tpu_torch.models.resnet import DilatedResNet


class PSPModule(nn.Module):
    """Pyramid pooling: adaptive-pool to each size, 1x1 conv, upsample back,
    concat with the input, 1x1 bottleneck -> relu. ``features`` is the
    trunk's width (512 for BasicBlock trunks, 2048 for Bottleneck ones),
    which the JAX ``PSPModule`` reads from its input."""

    def __init__(self, features: int = 512, out_features: int = 1024,
                 sizes=(1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        # index 0 of each stage is the reference's parameter-free pooling
        self.stages = nn.ModuleList(
            nn.Sequential(nn.Identity(),
                          nn.Conv2d(features, features, 1, bias=False))
            for _ in self.sizes)
        self.bottleneck = nn.Conv2d(features * (len(self.sizes) + 1),
                                    out_features, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        priors = [resize_bilinear(conv2d(stage[1],
                                         adaptive_avg_pool2d(x, size)),
                                  (h, w))
                  for size, stage in zip(self.sizes, self.stages)]
        return F.relu(conv2d(self.bottleneck, torch.cat(priors + [x], dim=1)))


class PSPUpsample(nn.Module):
    """2x bilinear upsample -> conv3x3 -> PReLU (``lib/pspnet.py:27-37``).

    ``fused=True`` computes it as one half-res phase convolution
    (:func:`phase_upsample_conv3x3`, with ``border``); otherwise it is the
    dense resize, pad (edge for "replicate", zeros for "zero"), VALID conv
    and bias. ``align_corners=True`` is the reference decoder's resize; it
    is not a periodic 2-phase filter, so it takes the dense path with zero
    padding. ``conv[0]`` stands for the reference's Upsample, so the
    state_dict keys match, and every mode reads the same parameters."""

    def __init__(self, cin: int, cout: int, fused: bool = True,
                 border: str = "replicate", align_corners: bool = False):
        super().__init__()
        self.fused = fused and not align_corners
        self.border = border
        self.align_corners = align_corners
        self.conv = nn.Sequential(nn.Identity(),
                                  nn.Conv2d(cin, cout, 3, padding=1),
                                  nn.PReLU())

    def forward(self, x):
        conv = self.conv[1]
        if self.fused:
            x = phase_upsample_conv3x3(x, conv.weight, conv.bias,
                                       border=self.border)
        else:
            h, w = x.shape[-2:]
            x = resize_bilinear(x, (2 * h, 2 * w),
                                align_corners=self.align_corners)
            zero = self.align_corners or self.border == "zero"
            x = F.pad(x, (1, 1, 1, 1),
                      mode="constant" if zero else "replicate")
            x = F.conv2d(x, cast(conv.weight, x)) \
                + cast(conv.bias, x)[:, None, None]
        return prelu(x, self.conv[2].weight)


def _gather_patches(x: torch.Tensor, pr: torch.Tensor,
                    pc: torch.Tensor) -> torch.Tensor:
    """x (B, C, h, w); pr, pc (B, N, 3) half-res rows and columns -> the
    (B, N, 3, 3, C) patches ``x[b, :, pr[b, n, i], pc[b, n, j]]``."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None, None]
    return x[bidx, :, pr[..., :, None], pc[..., None, :]]


def sparse_upsample_taps(x: torch.Tensor, rows: torch.Tensor,
                         cols: torch.Tensor,
                         border: str = "zero") -> torch.Tensor:
    """The 3x3 conv-tap neighbourhoods of ``upsample2x(x)`` (half-pixel) at
    selected FULL-RES pixels, without forming the upsampled map. x (B, C, h,
    w); rows, cols (B, N) full-res (2h x 2w) coordinates -> (B, N, 3, 3, C).
    The tap rows {y-1, y, y+1} of pixel y only touch half-res rows
    {k-1, k, k+1}, k = y // 2, so one clamped 3x3 half-res patch serves all
    nine taps, weighted by the parity tables. ``border="zero"`` zeroes the
    taps outside the full-res image (zero conv padding); "replicate" keeps
    the clamped values (``densefusion_tpu/models/pspnet.py:111``)."""
    h, w = x.shape[-2:]
    d = torch.arange(-1, 2, device=x.device)
    pr = (rows // 2)[..., None].add(d).clamp(0, h - 1)           # (B, N, 3)
    pc = (cols // 2)[..., None].add(d).clamp(0, w - 1)
    patch = _gather_patches(x, pr, pc)
    w_even = x.new_tensor(UPSAMPLE_TAPS_EVEN)
    w_odd = x.new_tensor(UPSAMPLE_TAPS_ODD)
    wr = torch.where((rows % 2 == 1)[..., None, None], w_odd, w_even)
    wc = torch.where((cols % 2 == 1)[..., None, None], w_odd, w_even)
    if border == "zero":
        t_r, t_c = rows[..., None] + d, cols[..., None] + d
        wr = wr * ((t_r >= 0) & (t_r < 2 * h))[..., None].to(x.dtype)
        wc = wc * ((t_c >= 0) & (t_c < 2 * w))[..., None].to(x.dtype)
    return torch.einsum("bnti,bnuj,bnijc->bntuc", wr, wc, patch)


def _align_axis_taps(coord: torch.Tensor, size: int):
    """Per-point 1-D tap weights of ``conv3x3(zero_pad(upsample2x_align))``
    along one axis: coord (B, N) full-res centres in [0, 2*size) -> (anchor
    (B, N), the first of three half-res rows, weights (B, N, 3 taps,
    3 rows)). Tap t's align-corners source is ``t*(size-1)/(2*size-1)``;
    the three taps span less than one source row, so rows {a, a+1, a+2}
    with ``a = floor(src_y + 0.5) - 1`` cover them
    (``densefusion_tpu/models/pspnet.py:166``). Taps outside the image
    weigh 0."""
    t = coord[..., None] + torch.arange(-1, 2, device=coord.device)
    src = t.float() * ((size - 1) / (2 * size - 1))
    i0 = src.floor().long().clamp(0, size - 2)
    frac = src - i0.float()
    a = ((src[..., 1] + 0.5).floor().long() - 1).clamp(0, size - 3)
    rows_abs = a[..., None] + torch.arange(3, device=coord.device)
    eq0 = rows_abs[..., None, :] == i0[..., :, None]         # (B, N, tap, row)
    eq1 = rows_abs[..., None, :] == (i0 + 1)[..., :, None]
    wt = eq0 * (1.0 - frac)[..., :, None] + eq1 * frac[..., :, None]
    ok = (t >= 0) & (t < 2 * size)
    return a, wt * ok[..., :, None]


def sparse_upsample_taps_align(x: torch.Tensor, rows: torch.Tensor,
                               cols: torch.Tensor) -> torch.Tensor:
    """:func:`sparse_upsample_taps` for the ``align_corners=True`` upsample
    with zero conv padding; its tap weights vary per pixel, so they are
    computed per point. x (B, C, h, w); rows, cols (B, N) -> (B, N, 3, 3,
    C)."""
    h, w = x.shape[-2:]
    ar, wr = _align_axis_taps(rows, h)
    ac, wc = _align_axis_taps(cols, w)
    d = torch.arange(3, device=x.device)
    patch = _gather_patches(x, ar[..., None] + d, ac[..., None] + d)
    return torch.einsum("bnti,bnuj,bnijc->bntuc", wr.to(x.dtype),
                        wc.to(x.dtype), patch)


def sample_phases(y4: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """The sparse decode of the fused decoder: the phase conv ran densely
    at half resolution (y4 (B, 4*C, h, w), phase-major channels); each point
    at full-res (rows, cols) (B, N) reads its own phase's C channels at its
    half-res pixel -> (B, N, C)."""
    b, c4, hh, ww = y4.shape
    y4 = y4.reshape(b, 4, c4 // 4, hh * ww)
    base = (rows // 2) * ww + cols // 2
    phase = (rows % 2) * 2 + cols % 2
    bidx = torch.arange(b, device=y4.device)[:, None]
    return y4[bidx, phase, :, base]


class PSPNet(nn.Module):
    """(B, H, W, 3) image -> (B, H, W, emb_dim) log-softmax embedding, or
    with ``sample_at`` (B, N) flat pixel indices -> (B, N, emb_dim) at those
    pixels only. H and W must be multiples of 8.

    ``fused_decoder=True`` (the default) runs every upsample stage as a
    phase convolution with replicate borders; ``False`` runs the dense
    resize-then-conv stages with zero padding. ``align_corners=True`` is the
    reference-exact decoder (``nn.Upsample(align_corners=True)``, zero
    padding, dense) that imported reference weights need; it overrides
    ``fused_decoder``. The PSP priors stay half-pixel in every mode. All
    modes read the same parameters. ``dtype`` is the compute type (None:
    float32); the output is float32 either way."""

    def __init__(self, variant: str = "resnet18", emb_dim: int = 32,
                 psp_out: int = 1024, sizes=(1, 2, 3, 6),
                 fused_decoder: bool = True, align_corners: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fused = fused_decoder and not align_corners
        self.border = "replicate" if self.fused else "zero"
        self.align_corners = align_corners
        self.feats = DilatedResNet(variant, dtype)
        self.psp = PSPModule(self.feats.out_features, psp_out, sizes)
        self.drop_1 = Dropout2d(0.3)
        self.drop_2 = Dropout2d(0.15)    # after up1 and again after up2
        up = dict(fused=self.fused, border=self.border,
                  align_corners=align_corners)
        self.up_1 = PSPUpsample(psp_out, 256, **up)
        self.up_2 = PSPUpsample(256, 64, **up)
        self.up_3 = PSPUpsample(64, 64, **up)
        self.final = nn.Sequential(nn.Conv2d(64, emb_dim, 1))

    def forward(self, img: torch.Tensor,
                sample_at: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                batch_rows: tuple[int, int, int] | None = None
                ) -> torch.Tensor:
        """``generator`` draws the train-mode dropout masks, for the whole
        batch that ``batch_rows`` places ``img`` in when it is given
        (:class:`~densefusion_tpu_torch.models.layers.Dropout2d`)."""
        w_full = img.shape[2]
        f, _ = self.feats(img.permute(0, 3, 1, 2))
        p = self.drop_1(self.psp(f), generator, batch_rows)
        p = self.drop_2(self.up_1(p), generator, batch_rows)
        p = self.drop_2(self.up_2(p), generator, batch_rows)
        if sample_at is None:
            p = conv2d(self.final[0], self.up_3(p)).permute(0, 2, 3, 1)
            return F.log_softmax(p.float(), dim=-1)           # (B, H, W, emb)
        conv, final = self.up_3.conv[1], self.final[0]
        rows, cols = sample_at // w_full, sample_at % w_full
        if self.fused:
            g = sample_phases(phase_conv_phases(p, conv.weight, conv.bias),
                              rows, cols)
        else:
            # zero border: per-point tap weights masked at the image edge
            if self.align_corners:
                taps = sparse_upsample_taps_align(p, rows, cols)
            else:
                taps = sparse_upsample_taps(p, rows, cols, self.border)
            g = torch.einsum("bnijc,dcij->bnd", taps,
                             cast(conv.weight, taps)) + cast(conv.bias, taps)
        g = prelu(g, self.up_3.conv[2].weight)                  # (B, N, C)
        p = linear(g, final.weight[:, :, 0, 0], final.bias)
        return F.log_softmax(p.float(), dim=-1)

