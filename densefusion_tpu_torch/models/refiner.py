"""PoseRefineNet: residual pose regression over the canonicalized cloud
(counterpart of ``densefusion_tpu/models/refiner.py``).

The refiner sees the observed cloud re-expressed in the current estimate's
frame plus the frozen color embeddings, and predicts a residual
(quaternion, translation); the composition lives in ``eval/pipeline.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from densefusion_tpu_torch.models.posenet import point_conv, select_object


class RefineFeat(nn.Module):
    """Global 1024-d fusion feature: both levels concatenated (128 + 256 =
    384) before the 512/1024 mix, then averaged over the points."""

    def __init__(self, emb_dim: int = 32):
        super().__init__()
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.e_conv1 = nn.Conv1d(emb_dim, 64, 1)
        self.e_conv2 = nn.Conv1d(64, 128, 1)
        self.conv5 = nn.Conv1d(384, 512, 1)
        self.conv6 = nn.Conv1d(512, 1024, 1)

    def forward(self, points, emb):
        g1 = F.relu(point_conv(self.conv1, points))
        c1 = F.relu(point_conv(self.e_conv1, emb))
        g2 = F.relu(point_conv(self.conv2, g1))
        c2 = F.relu(point_conv(self.e_conv2, c1))
        x = torch.cat([g1, c1, g2, c2], dim=-1)              # (B, N, 384)
        x = F.relu(point_conv(self.conv5, x))
        x = F.relu(point_conv(self.conv6, x))
        return x.mean(dim=-2)                                # (B, 1024)


class PoseRefineNet(nn.Module):
    """(points (B, N, 3) canonicalized, emb (B, N, emb_dim), obj (B,)) ->
    {"pred_r": (B, 4) unnormalized wxyz, "pred_t": (B, 3)}. Heads: two
    Linear stacks 1024 -> 512 -> 128 -> num_obj*{4, 3}."""

    def __init__(self, num_obj: int, emb_dim: int = 32):
        super().__init__()
        self.num_obj = num_obj
        self.feat = RefineFeat(emb_dim)
        for letter, out_dim in (("r", 4), ("t", 3)):
            self.add_module(f"conv1_{letter}", nn.Linear(1024, 512))
            self.add_module(f"conv2_{letter}", nn.Linear(512, 128))
            self.add_module(f"conv3_{letter}",
                            nn.Linear(128, num_obj * out_dim))

    def forward(self, points, emb, obj):
        feat = self.feat(points, emb)
        out = {}
        for letter in "rt":
            x = F.relu(getattr(self, f"conv1_{letter}")(feat))
            x = F.relu(getattr(self, f"conv2_{letter}")(x))
            last = getattr(self, f"conv3_{letter}")
            w, b = select_object(last.weight, last.bias, obj.long(),
                                 self.num_obj)
            out[f"pred_{letter}"] = (torch.bmm(w, x[:, :, None])[..., 0]
                                     + b).float()
        return out
