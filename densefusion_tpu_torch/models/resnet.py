"""Dilated, BN-free ResNet-18 trunk at output stride 8 (counterpart of
``densefusion_tpu/models/resnet.py``).

conv7x7/s2 -> maxpool/s2 -> four stages; stages 3 and 4 trade stride for
dilation (2, 4). As in the reference, the blocks hold no BatchNorm, and the
first block of each stage is not dilated (only its stride is set).
Module names follow the reference's ``feats.*`` state_dict keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (block depths) per variant; only BasicBlock trunks are ported so far.
RESNET_DEPTHS = {"resnet18": (2, 2, 2, 2)}
# (features, stride, dilation) per stage
_STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


class BasicBlock(nn.Module):
    """conv3x3 -> relu -> conv3x3 (+ 1x1 projection shortcut) -> relu."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, padding=dilation,
                               dilation=dilation, bias=False)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False))

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class DilatedResNet(nn.Module):
    """NCHW trunk returning (stage4, stage3) features at output stride 8."""

    def __init__(self, variant: str = "resnet18"):
        super().__init__()
        if variant not in RESNET_DEPTHS:
            raise NotImplementedError(f"trunk {variant!r} is not ported yet")
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        cin = 64
        for s, ((cout, stride, dilation), depth) in enumerate(
                zip(_STAGES, RESNET_DEPTHS[variant]), start=1):
            blocks = []
            for b in range(depth):
                blocks.append(BasicBlock(cin, cout,
                                         stride=stride if b == 0 else 1,
                                         dilation=1 if b == 0 else dilation))
                cin = cout
            setattr(self, f"layer{s}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer2(self.layer1(x))
        feats3 = self.layer3(x)
        return self.layer4(feats3), feats3
