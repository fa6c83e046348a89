"""PSPNet per-pixel embedding network (counterpart of
``densefusion_tpu/models/pspnet.py`` in its default mode).

Dilated ResNet trunk -> pyramid pooling over sizes (1, 2, 3, 6) -> 1x1
bottleneck to 1024 -> three 2x upsample + conv3x3 + PReLU stages
(1024 -> 256 -> 64 -> 64) -> 1x1 conv to a 32-channel embedding ->
log-softmax over channels.

Only the default decoder is ported: ``fused_decoder=True``, where every
upsample stage is a half-res phase convolution with replicate borders, and
the last stage is decoded sparsely at the requested pixels. The zero-border
dense decoder and the reference-exact align-corners decoder raise
``NotImplementedError``. Dropout is omitted: the port only runs inference.
Module names follow the reference's state_dict keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from densefusion_tpu_torch.models.layers import (
    prelu, adaptive_avg_pool2d, resize_bilinear, phase_conv_phases,
    phase_upsample_conv3x3,
)
from densefusion_tpu_torch.models.resnet import DilatedResNet


class PSPModule(nn.Module):
    """Pyramid pooling: adaptive-pool to each size, 1x1 conv, upsample back,
    concat with the input, 1x1 bottleneck -> relu."""

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
        priors = [resize_bilinear(stage[1](adaptive_avg_pool2d(x, size)),
                                  (h, w))
                  for size, stage in zip(self.sizes, self.stages)]
        return F.relu(self.bottleneck(torch.cat(priors + [x], dim=1)))


class PSPUpsample(nn.Module):
    """2x half-pixel upsample -> conv3x3 (replicate border) -> PReLU, as one
    half-res phase convolution. ``conv[0]`` stands for the reference's
    Upsample (fused into the phase kernels), so the state_dict keys match."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Identity(),
                                  nn.Conv2d(cin, cout, 3, padding=1),
                                  nn.PReLU())

    def forward(self, x):
        conv = self.conv[1]
        return prelu(phase_upsample_conv3x3(x, conv.weight, conv.bias),
                     self.conv[2].weight)


class PSPNet(nn.Module):
    """(B, H, W, 3) image -> (B, H, W, emb_dim) log-softmax embedding, or
    with ``sample_at`` (B, N) flat pixel indices -> (B, N, emb_dim) at those
    pixels only. H and W must be multiples of 8."""

    def __init__(self, variant: str = "resnet18", emb_dim: int = 32,
                 psp_out: int = 1024, sizes=(1, 2, 3, 6),
                 fused_decoder: bool = True, align_corners: bool = False):
        super().__init__()
        if not fused_decoder or align_corners:
            raise NotImplementedError(
                "only the fused replicate-border decoder is ported; the "
                "zero-border and align-corners decoders are not")
        self.feats = DilatedResNet(variant)
        self.psp = PSPModule(512, psp_out, sizes)
        self.up_1 = PSPUpsample(psp_out, 256)
        self.up_2 = PSPUpsample(256, 64)
        self.up_3 = PSPUpsample(64, 64)
        self.final = nn.Sequential(nn.Conv2d(64, emb_dim, 1))

    def forward(self, img: torch.Tensor,
                sample_at: torch.Tensor | None = None) -> torch.Tensor:
        w_full = img.shape[2]
        f, _ = self.feats(img.permute(0, 3, 1, 2))
        p = self.up_2(self.up_1(self.psp(f)))
        if sample_at is None:
            p = self.final(self.up_3(p)).permute(0, 2, 3, 1)  # (B, H, W, emb)
        else:
            # Sparse decode: the phase conv runs densely at half resolution,
            # then each point reads its own phase's C channels at its
            # half-res pixel; PReLU and the final 1x1 run on N rows only.
            conv, final = self.up_3.conv[1], self.final[0]
            b, _, hh, ww = p.shape
            y4 = phase_conv_phases(p, conv.weight, conv.bias)
            y4 = y4.reshape(b, 4, conv.weight.shape[0], hh * ww)
            rows = sample_at // w_full
            cols = sample_at % w_full
            base = (rows // 2) * ww + cols // 2              # (B, N)
            phase = (rows % 2) * 2 + cols % 2                # (B, N)
            bidx = torch.arange(b, device=p.device)[:, None]
            g = prelu(y4[bidx, phase, :, base],
                      self.up_3.conv[2].weight)              # (B, N, C)
            p = F.linear(g, final.weight[:, :, 0, 0], final.bias)
        return F.log_softmax(p.float(), dim=-1)
