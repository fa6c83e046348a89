"""Plain PyTorch DenseFusion: PoseNet (PSPNet-ResNet18 embedding, dense
fusion, per-point heads), PoseRefineNet and the estimate + refine pipeline.

The benchmark's yardstick for the port's poses. It follows the published
architecture (Wang et al., CVPR 2019; j96w/DenseFusion ``lib/network.py``,
``lib/pspnet.py``) in the layout the paper's code uses: point features as
(B, C, N) under ``F.conv1d``, the embedding decoded densely over the whole
crop and gathered at the chosen pixels. Departures, all of them the
semantics the measured port states as its own:

- the trunk is the port's BN-free dilated ResNet18 at output stride 8;
- every decoder stage is a half-pixel 2x bilinear upsample, a replicate
  pad and a 3x3 convolution (the reference pads with zeros after an
  align-corners upsample); the PSP priors are half-pixel upsamples too;
- quaternions are wxyz and the confidence is ``sigmoid`` of the logit.

Parameter names are the reference's state_dict keys, so one state_dict
loads into this module and into the port's. Nothing here imports the port:
this file is the plain copy the port is judged against. :func:`posenet` and
:func:`refiner` build the networks at a configuration's widths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (width, stride, dilation) of the dilated ResNet18's four stages
TRUNKS = {"resnet18": ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))}
DROPOUT = (0.3, 0.15, 0.15)   # after the PSP module, after up1, after up2


class Block(nn.Module):
    def __init__(self, cin, cout, stride, dilation):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, dilation, dilation,
                               bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, dilation, dilation,
                               bias=False)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride,
                                                   bias=False))
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        s = x if self.downsample is None else self.downsample(x)
        return F.relu(y + s)


class Trunk(nn.Module):
    """Dilated ResNet without BatchNorm, output stride 8."""

    def __init__(self, stages):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        cin = 64
        for i, (width, stride, dilation) in enumerate(stages, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                Block(cin, width, stride, 1), Block(width, width, 1,
                                                    dilation)))
            cin = width

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class PSP(nn.Module):
    def __init__(self, features, out, sizes):
        super().__init__()
        self.sizes = tuple(sizes)
        self.stages = nn.ModuleList(
            nn.Sequential(nn.Identity(), nn.Conv2d(features, features, 1,
                                                   bias=False))
            for _ in self.sizes)
        self.bottleneck = nn.Conv2d(features * (len(self.sizes) + 1), out, 1)

    def forward(self, x):
        hw = x.shape[-2:]
        priors = [F.interpolate(stage[1](F.adaptive_avg_pool2d(x, s)), hw,
                                mode="bilinear", align_corners=False)
                  for s, stage in zip(self.sizes, self.stages)]
        return F.relu(self.bottleneck(torch.cat(priors + [x], 1)))


class Up(nn.Module):
    """2x half-pixel bilinear upsample, replicate pad, 3x3 conv, PReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(nn.Identity(), nn.Conv2d(cin, cout, 3),
                                  nn.PReLU())

    def forward(self, x):
        h, w = x.shape[-2:]
        x = F.interpolate(x, (2 * h, 2 * w), mode="bilinear",
                          align_corners=False)
        x = self.conv[1](F.pad(x, (1, 1, 1, 1), mode="replicate"))
        return torch.where(x >= 0, x, self.conv[2].weight * x)


def dropout(x, p, generator):
    """Channel dropout drawn as the port's train step draws it: one
    ``torch.bernoulli`` of float32 keep probabilities shaped (B, C, 1, 1)
    from ``generator``; kept maps scaled by 1 / (1 - p)."""
    keep = 1.0 - p
    probs = torch.full(x.shape[:2] + (1, 1), keep, dtype=torch.float32,
                       device=x.device)
    mask = torch.bernoulli(probs, generator=generator)
    return torch.where(mask.bool(), x / keep, 0.0)


class PSPNet(nn.Module):
    def __init__(self, stages, sizes, psp_out, decoder_widths, emb_dim):
        super().__init__()
        w = decoder_widths
        if w[0] != psp_out or len(w) != 4:
            raise ValueError(f"decoder widths {w} do not start at the PSP "
                             f"module's {psp_out} or are not 3 stages")
        self.feats = Trunk(stages)
        self.psp = PSP(stages[-1][0], psp_out, sizes)
        self.up_1, self.up_2, self.up_3 = Up(w[0], w[1]), Up(w[1], w[2]), \
            Up(w[2], w[3])
        self.final = nn.Sequential(nn.Conv2d(w[3], emb_dim, 1))

    def forward(self, img, generator=None):
        """img (B, H, W, 3) -> (B, emb, H, W) log-softmax embedding map.
        ``generator`` draws the dropout masks in train mode."""
        drop = self.training
        p = self.psp(self.feats(img.permute(0, 3, 1, 2)))
        if drop:
            p = dropout(p, DROPOUT[0], generator)
        p = self.up_1(p)
        if drop:
            p = dropout(p, DROPOUT[1], generator)
        p = self.up_2(p)
        if drop:
            p = dropout(p, DROPOUT[2], generator)
        return F.log_softmax(self.final(self.up_3(p)), dim=1)


class Nest(nn.Module):
    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            self.add_module(k, v)


class Fusion(nn.Module):
    """Point-wise fusion at ``widths`` (w1, w2, w5, w6): the geometry and
    embedding branches at w1 then w2 each, conv5 to w5, conv6 to w6.
    conv5 takes both levels in the refiner (2 * (w1 + w2) channels) and the
    second level alone in PoseNet (2 * w2)."""

    def __init__(self, emb_dim, widths, refiner):
        super().__init__()
        w1, w2, w5, w6 = widths
        self.conv1 = nn.Conv1d(3, w1, 1)
        self.conv2 = nn.Conv1d(w1, w2, 1)
        self.e_conv1 = nn.Conv1d(emb_dim, w1, 1)
        self.e_conv2 = nn.Conv1d(w1, w2, 1)
        self.conv5 = nn.Conv1d(2 * (w1 + w2) if refiner else 2 * w2, w5, 1)
        self.conv6 = nn.Conv1d(w5, w6, 1)

    def levels(self, x, emb):
        """x (B, 3, N), emb (B, emb, N) -> the two point feature levels."""
        g1, c1 = F.relu(self.conv1(x)), F.relu(self.e_conv1(emb))
        g2, c2 = F.relu(self.conv2(g1)), F.relu(self.e_conv2(c1))
        return torch.cat([g1, c1], 1), torch.cat([g2, c2], 1)


def pick(y, obj, num_obj):
    """(B, num_obj * D, ...) -> (B, D, ...) rows of each sample's object."""
    y = y.reshape(y.shape[0], num_obj, -1, *y.shape[2:])
    return y[torch.arange(y.shape[0], device=y.device), obj]


class PoseNet(nn.Module):
    def __init__(self, num_obj, emb_dim, cnn, fusion_widths, head_widths):
        super().__init__()
        self.num_obj = num_obj
        self.cnn = Nest(model=Nest(module=cnn))
        self.feat = Fusion(emb_dim, fusion_widths, refiner=False)
        w1, w2, _, w6 = fusion_widths
        for letter, d in (("r", 4), ("t", 3), ("c", 1)):
            cin = 2 * (w1 + w2) + w6
            for i, w in enumerate(tuple(head_widths) + (num_obj * d,),
                                  start=1):
                setattr(self, f"conv{i}_{letter}", nn.Conv1d(cin, w, 1))
                cin = w

    def forward(self, img, points, choose, obj, generator=None):
        """-> pred_r (B, N, 4), pred_t (B, N, 3), logit (B, N), emb (B, N,
        emb) for img (B, H, W, 3), points (B, N, 3), choose (B, N) flat
        pixel indices, obj (B,)."""
        emb_map = self.cnn.model.module(img, generator)
        b, d = emb_map.shape[:2]
        emb = torch.gather(emb_map.reshape(b, d, -1), 2,
                           choose[:, None, :].expand(-1, d, -1))
        x = points.transpose(1, 2)
        f1, f2 = self.feat.levels(x, emb)
        g = F.relu(self.feat.conv6(F.relu(self.feat.conv5(f2))))
        g = g.mean(dim=2, keepdim=True).expand_as(g)
        feat = torch.cat([f1, f2, g], 1)     # (B, 2 (w1 + w2) + w6, N)
        outs = []
        for letter in "rtc":
            y = feat
            for i in (1, 2, 3):
                y = F.relu(getattr(self, f"conv{i}_{letter}")(y))
            y = pick(getattr(self, f"conv4_{letter}")(y), obj, self.num_obj)
            outs.append(y.transpose(1, 2))
        return outs[0], outs[1], outs[2][..., 0], emb.transpose(1, 2)


class PoseRefineNet(nn.Module):
    def __init__(self, num_obj, emb_dim, fusion_widths, refiner_widths):
        super().__init__()
        self.num_obj = num_obj
        self.feat = Fusion(emb_dim, fusion_widths, refiner=True)
        w6, (h1, h2) = fusion_widths[-1], refiner_widths
        for letter, d in (("r", 4), ("t", 3)):
            self.add_module(f"conv1_{letter}", nn.Linear(w6, h1))
            self.add_module(f"conv2_{letter}", nn.Linear(h1, h2))
            self.add_module(f"conv3_{letter}", nn.Linear(h2, num_obj * d))

    def forward(self, points, emb, obj):
        """points (B, N, 3) in the current pose's frame, emb (B, N, emb) ->
        pred_r (B, 4), pred_t (B, 3)."""
        f1, f2 = self.feat.levels(points.transpose(1, 2),
                                  emb.transpose(1, 2))
        x = F.relu(self.feat.conv5(torch.cat([f1, f2], 1)))
        x = F.relu(self.feat.conv6(x)).mean(dim=2)           # (B, w6)
        outs = []
        for letter in "rt":
            y = F.relu(getattr(self, f"conv1_{letter}")(x))
            y = F.relu(getattr(self, f"conv2_{letter}")(y))
            outs.append(pick(getattr(self, f"conv3_{letter}")(y), obj,
                             self.num_obj))
        return outs[0], outs[1]


def posenet(cfg) -> PoseNet:
    """PoseNet at the configuration's widths: ``trunk``, ``psp_sizes``,
    ``psp_in`` (the trunk's last width), ``psp_out``, ``decoder_widths``,
    ``emb_dim``, ``fusion_widths``, ``head_widths``."""
    stages = TRUNKS[cfg["trunk"]]
    if cfg["psp_in"] != stages[-1][0]:
        raise ValueError(f"psp_in {cfg['psp_in']} is not the "
                         f"{cfg['trunk']} trunk's width {stages[-1][0]}")
    cnn = PSPNet(stages, tuple(cfg["psp_sizes"]), cfg["psp_out"],
                 tuple(cfg["decoder_widths"]), cfg["emb_dim"])
    return PoseNet(cfg["num_obj"], cfg["emb_dim"], cnn,
                   tuple(cfg["fusion_widths"]), tuple(cfg["head_widths"]))


def refiner(cfg) -> PoseRefineNet:
    """PoseRefineNet at the configuration's ``fusion_widths`` and
    ``refiner_widths``."""
    return PoseRefineNet(cfg["num_obj"], cfg["emb_dim"],
                         tuple(cfg["fusion_widths"]),
                         tuple(cfg["refiner_widths"]))


# -- quaternions (wxyz) -------------------------------------------------------

def normalize(q):
    return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def rotation(q):
    """Unit quaternion(s) (..., 4) -> rotation matrices (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def hamilton(a, b):
    """The quaternion of R(a) @ R(b)."""
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    return torch.cat([aw * bw - (av * bv).sum(-1, keepdim=True),
                      aw * bv + bw * av + torch.linalg.cross(av, bv)], -1)


@torch.no_grad()
def hypotheses(posenet, img, points, choose, obj):
    """Eval-mode PoseNet -> (q_all (B, N, 4) unit, t_all (B, N, 3), conf
    (B, N), emb (B, N, emb))."""
    pred_r, pred_t, logit, emb = posenet(img, points, choose, obj)
    return normalize(pred_r), points + pred_t, torch.sigmoid(logit), emb


@torch.no_grad()
def refine(refiner, iters, q, t, points, emb, obj):
    """``iters`` refiner iterations from (q (B, 4), t (B, 3)): the cloud
    re-expressed in the current pose's frame, the residual pose composed on
    the right (the paper's ``my_mat_final = my_mat @ my_r_2``)."""
    for _ in range(iters):
        R = rotation(q)
        local = torch.bmm(points - t[:, None, :], R)
        pr, pt = refiner(local, emb, obj)
        t = torch.bmm(R, pt[:, :, None])[..., 0] + t
        q = hamilton(q, normalize(pr))
    return q, t
