"""Plain PyTorch SegNet: the network, its training step and its work.

The benchmark's yardstick for the port's segmenter. It follows SegNet
(Badrinarayanan, Kendall and Cipolla, TPAMI 2017, arXiv:1511.00561) as
DenseFusion builds it (j96w/DenseFusion ``vanilla_segmentation/segnet.py``):
a VGG16-shaped encoder of 3x3 convolution + BatchNorm + ReLU layers in five
stages, each closed by a 2x2 max pool that keeps its argmax positions; a
mirrored decoder whose stages unpool at those positions and run the same
layers; a 3x3 classifier ``conv11d``. It is trained (``train.py``) with
Adam and the unweighted per-pixel cross-entropy. Departures, both of them
the semantics the measured port states as its own:

- BatchNorm's running variance folds in the batch's biased variance
  (flax's statistics); ``nn.BatchNorm2d`` folds in the unbiased one, n / (n
  - 1) larger. The momentum is the reference's (0.1 of the batch's, flax's
  0.9 of the running value);
- BatchNorm keeps no ``num_batches_tracked``.

Parameter names are the reference's state_dict keys (``conv{s}{i}``,
``bn{s}{i}``, ``conv{t}{j}d``, ``bn{t}{j}d``, ``conv11d``), so one
state_dict loads into this module and into the port's. Nothing here
imports the port: this file is the plain copy the port is judged against.
:func:`segnet` builds the network at a configuration's widths and raises
on widths that do not make a SegNet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench import seg_inputs
from perfbench.reference import judge
from perfbench.reference import loss as ref_loss


class BatchNorm(nn.Module):
    """Batch statistics in training (the biased variance), folded into the
    running ones as ``running = m * running + (1 - m) * batch``."""

    def __init__(self, width, momentum, eps):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def forward(self, x):
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, 1.0 - self.momentum)
                self.running_var.lerp_(var, 1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight / torch.sqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


def _check(enc, dec):
    """Raise unless the stage widths make a SegNet whose layers carry the
    reference's names: as many decoder as encoder stages, each decoder
    stage no deeper than the encoder stage it unpools, the map it unpools
    as wide as that stage's pooled one, and one-digit stage and layer
    numbers."""
    if not enc or len(enc) != len(dec) or len(enc) > 9:
        raise ValueError(f"SegNet needs 1-9 encoder stages and as many "
                         f"decoder stages, got {len(enc)} and {len(dec)}")
    if any(not s or len(s) > 9 for s in list(enc) + list(dec)):
        raise ValueError("every stage needs 1-9 convolutions")
    width = enc[-1][-1]
    for s, stage in enumerate(dec):
        t = len(enc) - s - 1
        if len(stage) > len(enc[t]):
            raise ValueError(f"decoder stage {s + 1} has {len(stage)} "
                             f"convolutions; the encoder stage it unpools "
                             f"has {len(enc[t])}")
        if width != enc[t][-1]:
            raise ValueError(f"decoder stage {s + 1} unpools a {width}-wide "
                             f"map at the positions of a {enc[t][-1]}-wide "
                             f"one")
        width = stage[-1]


class SegNet(nn.Module):
    """``(B, 3, H, W)`` -> ``(B, num_classes, H, W)`` logits; H and W
    divisible by 2 ** stages."""

    def __init__(self, num_classes, enc_stages, dec_stages, momentum=0.9,
                 eps=1e-5):
        super().__init__()
        _check(enc_stages, dec_stages)
        self.enc, self.dec = [], []
        cin = 3
        for s, widths in enumerate(enc_stages, start=1):
            names = [f"{s}{i}" for i in range(1, len(widths) + 1)]
            cin = self._layers(names, cin, widths, momentum, eps)
            self.enc.append(names)
        for s, widths in enumerate(dec_stages):
            t = len(enc_stages) - s
            top = len(enc_stages[t - 1])
            names = [f"{t}{top - i}d" for i in range(len(widths))]
            cin = self._layers(names, cin, widths, momentum, eps)
            self.dec.append(names)
        self.conv11d = nn.Conv2d(cin, num_classes, 3, padding=1)

    def _layers(self, names, cin, widths, momentum, eps):
        for name, w in zip(names, widths):
            setattr(self, f"conv{name}", nn.Conv2d(cin, w, 3, padding=1))
            setattr(self, f"bn{name}", BatchNorm(w, momentum, eps))
            cin = w
        return cin

    def _block(self, name, x):
        return F.relu(getattr(self, f"bn{name}")(
            getattr(self, f"conv{name}")(x)))

    def forward(self, x):
        indices = []
        for names in self.enc:
            for name in names:
                x = self._block(name, x)
            x, idx = F.max_pool2d(x, 2, 2, return_indices=True)
            indices.append(idx)
        for names, idx in zip(self.dec, reversed(indices)):
            x = F.max_unpool2d(x, idx, 2, 2)
            for name in names:
                x = self._block(name, x)
        return self.conv11d(x)


def segnet(cfg) -> SegNet:
    return SegNet(cfg["num_classes"], cfg["enc_stages"], cfg["dec_stages"],
                  cfg["bn_momentum"], cfg["bn_eps"])


def conv_layers(cfg):
    """(h, w, cin, cout) of every 3x3 convolution of one frame's forward,
    in order."""
    _check(cfg["enc_stages"], cfg["dec_stages"])
    h, w, cin = cfg["height"], cfg["width"], 3
    sizes, out = [], []
    for widths in cfg["enc_stages"]:
        sizes.append((h, w))
        for cout in widths:
            out.append((h, w, cin, cout))
            cin = cout
        h, w = h // 2, w // 2
    for widths, (h, w) in zip(cfg["dec_stages"], reversed(sizes)):
        for cout in widths:
            out.append((h, w, cin, cout))
            cin = cout
    out.append((h, w, cin, cfg["num_classes"]))
    return out


def train_flops(cfg) -> float:
    """FLOPs of one frame's training step: each convolution's products
    counted once (2 per multiply-add), the backward twice the forward (the
    input's and the weight's gradients) less the input gradient of the
    first convolution, which nothing needs. BatchNorm, pooling, the loss
    and Adam are not counted."""
    convs = [2 * 9 * h * w * cin * cout
             for h, w, cin, cout in conv_layers(cfg)]
    return 3.0 * sum(convs) - convs[0]


def train_steps(cfg, seed, pool, device, steps, half_batch=False):
    """The reference's first ``steps`` steps on pool batches 0, 1, ... ->
    (losses, first gradient norms {name: norm}, change norms {name: norm},
    BatchNorm running statistics {name: tensor on the CPU}). ``half_batch``
    is a planted fault: the loss of the first half of each batch's frames
    only (the forward, and its batch statistics, over all of them)."""
    net = segnet(cfg)
    net.load_state_dict(seg_inputs.segnet_weights(cfg, seed, device))
    net.to(device).train()
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in params]
    adam = ref_loss.Adam(params, cfg["lr"])
    losses, grad_norms = [], None
    for s in range(steps):
        batch = pool[s % len(pool)]
        logits = net(batch["rgb"])
        rows = slice(0, len(logits) // 2 if half_batch else len(logits))
        lo = F.cross_entropy(logits[rows], batch["label"][rows])
        grads = torch.autograd.grad(lo, params)
        if grad_norms is None:
            grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
        adam.step(grads)
        losses.append(float(lo.detach()))
    change = {n: float((p.detach() - p0).norm())
              for n, p, p0 in zip(names, params, start)}
    stats = {n: b.detach().to("cpu", copy=True)
             for n, b in net.named_buffers()}
    return losses, grad_norms, change, stats


def stats_gaps(prog: dict, ref_stats: dict) -> dict:
    """Each running statistic's gap, the norm of its difference from the
    reference's against the larger of the reference's norm and the median
    statistic's: {name: gap}."""
    norms = {n: float(v.norm()) for n, v in ref_stats.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return {n: float((prog[n] - v).norm()) / max(norms[n], med)
            for n, v in ref_stats.items()}


def seg_gaps(prog, ref_result) -> dict:
    """The program's (losses, gradient norms, change norms, statistics)
    against the reference's -> :func:`judge.train_gaps`' three gaps and
    ``stats_gap``, the worst running statistic's. Every gap is over norms:
    near-ties in the pools flip a few argmax positions among the ~15 M
    windows of a step, which no element-wise limit could hold."""
    gaps = judge.train_gaps(prog[:3], ref_result[:3])
    gaps["stats_gap"] = max(stats_gaps(prog[3], ref_result[3]).values())
    return gaps
