"""Dilated, BN-free ResNet trunks at output stride 8 (counterpart of
``densefusion_tpu/models/resnet.py``).

conv7x7/s2 -> maxpool/s2 -> four stages; stages 3 and 4 trade stride for
dilation (2, 4). As in the reference, the blocks hold no BatchNorm, and the
first block of each stage is not dilated (only its stride is set).
resnet18 and resnet34 stack :class:`BasicBlock`, resnet50, 101 and 152
:class:`Bottleneck` (the reference's ``psp_models`` table). Module names
follow the reference's ``feats.*`` state_dict keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from densefusion_tpu_torch.models.layers import cast, conv2d


class BasicBlock(nn.Module):
    """conv3x3 -> relu -> conv3x3 (+ 1x1 projection shortcut) -> relu."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.conv2 = nn.Conv2d(features, features, 3, 1, padding=dilation,
                               dilation=dilation, bias=False)
        self.downsample = _projection(cin, features, stride)

    def forward(self, x):
        y = conv2d(self.conv2, F.relu(conv2d(self.conv1, x)))
        return F.relu(y + _shortcut(self.downsample, x))


class Bottleneck(nn.Module):
    """1x1 -> relu -> 3x3 (stride, dilation) -> relu -> 1x1 to 4x the
    width (+ 1x1 projection shortcut) -> relu
    (``densefusion_tpu/models/resnet.py:52-76``)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        cout = features * self.expansion
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.conv2 = nn.Conv2d(features, features, 3, stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.conv3 = nn.Conv2d(features, cout, 1, bias=False)
        self.downsample = _projection(cin, cout, stride)

    def forward(self, x):
        y = F.relu(conv2d(self.conv1, x))
        y = conv2d(self.conv3, F.relu(conv2d(self.conv2, y)))
        return F.relu(y + _shortcut(self.downsample, x))


def _projection(cin: int, cout: int, stride: int):
    """The 1x1 projection shortcut of a block that changes stride or width
    (``downsample.0`` in the reference's keys), else None."""
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False))


def _shortcut(downsample, x):
    return x if downsample is None else conv2d(downsample[0], x)


# (block, depths) per variant: the reference's psp_models table
# (densefusion_tpu/models/resnet.py:78-84)
RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}
# (features, stride, dilation) per stage
_STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


def stem_space_to_depth(x: torch.Tensor, weight: torch.Tensor
                        ) -> torch.Tensor:
    """The 7x7/s2 stem (padding 3) as a 4x4/s1 convolution over a 2x2
    space-to-depth blocking of the input: the same map, its weight (64, 3,
    7, 7) padded to 8x8 at the top and left and folded by parity into (64,
    12, 4, 4) (``densefusion_tpu/models/resnet.py:96-116``). x (B, 3, H, W)
    with H and W even."""
    b, c, h, w = x.shape
    xb = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xb = xb.reshape(b, 4 * c, h // 2, w // 2)     # channel (py, px, c)
    cout = weight.shape[0]
    k8 = F.pad(weight, (1, 0, 1, 0))               # (O, C, 8, 8)
    k4 = k8.reshape(cout, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    k4 = k4.reshape(cout, 4 * c, 4, 4)
    return F.conv2d(F.pad(xb, (2, 1, 2, 1)), k4)


class DilatedResNet(nn.Module):
    """NCHW trunk returning (stage4, stage3) features at output stride 8.

    ``dtype`` (None: float32) is the compute type: the input is cast to it
    at the stem and every convolution runs in it
    (``densefusion_tpu/models/resnet.py:125-129``). ``s2d_stem`` computes
    the stem as :func:`stem_space_to_depth` from the same ``conv1.weight``.
    ``out_features`` is stage 4's width: 512 for BasicBlock trunks, 2048
    for Bottleneck ones."""

    def __init__(self, variant: str = "resnet18",
                 dtype: torch.dtype | None = None, s2d_stem: bool = False):
        super().__init__()
        if variant not in RESNET_SPECS:
            raise ValueError(f"unknown trunk {variant!r}; one of "
                             f"{sorted(RESNET_SPECS)}")
        block, depths = RESNET_SPECS[variant]
        self.dtype = dtype
        self.s2d_stem = s2d_stem
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        cin = 64
        for s, ((features, stride, dilation), depth) in enumerate(
                zip(_STAGES, depths), start=1):
            blocks = []
            for b in range(depth):
                blocks.append(block(cin, features,
                                    stride=stride if b == 0 else 1,
                                    dilation=1 if b == 0 else dilation))
                cin = features * block.expansion
            setattr(self, f"layer{s}", nn.Sequential(*blocks))
        self.out_features = cin

    def forward(self, x: torch.Tensor):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.s2d_stem:
            x = stem_space_to_depth(x, cast(self.conv1.weight, x))
        else:
            x = conv2d(self.conv1, x)
        x = F.max_pool2d(F.relu(x), 3, stride=2, padding=1)
        x = self.layer2(self.layer1(x))
        feats3 = self.layer3(x)
        return self.layer4(feats3), feats3
