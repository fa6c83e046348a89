"""Plain PyTorch phase-1 loss, Adam and the ADD / ADD-S distances.

The loss is the paper's dense one (``lib/loss.py``): every per-point
hypothesis moves the model points, its mean distance to the target is ADD,
or ADD-S on symmetric rows (each moved point to its nearest target point),
and ``loss = mean(dis * c - w * log c)``, the barrier taken as
``log_sigmoid`` of the logit as the port states. The distance is
``sqrt(max(d^2, 1e-12))``, whose gradient is zero below the floor. Adam is
written out (b1 0.9, b2 0.999, eps 1e-8 after the square root). Nothing
here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.model import normalize, rotation

EPS = 1e-12
# elements of one (rows, model points, targets) block of the nearest search
_BLOCK = 1 << 25


@torch.no_grad()
def nearest_targets(pred, target):
    """pred (B, P, 3), target (B, M, 3) -> (B, P, 3): each point's nearest
    target point by squared distance, searched in blocks."""
    b, p, _ = pred.shape
    step = max(1, _BLOCK // max(1, target.shape[1] * 3))
    out = torch.empty_like(pred)
    for i in range(b):
        for s in range(0, p, step):
            d2 = ((pred[i, s:s + step, None, :] - target[i, None]) ** 2) \
                .sum(-1)
            out[i, s:s + step] = target[i, d2.argmin(-1)]
    return out


def _mean_dist(pred, tgt):
    return ((pred - tgt) ** 2).sum(-1).clamp_min(EPS).sqrt().mean(-1)


def hypothesis_dist(R, t, model, target, sym):
    """R (B, N, 3, 3), t (B, N, 3), model / target (B, M, 3), sym (B,) bool
    -> (B, N) mean distance of every hypothesis, differentiable in R, t."""
    pred = torch.einsum("bnij,bmj->bnmi", R, model) + t[:, :, None, :]
    tgt = target[:, None].expand_as(pred)
    if bool(sym.any()):
        rows = sym.nonzero()[:, 0]
        b, n, m, _ = pred.shape
        near = nearest_targets(pred[rows].detach().reshape(len(rows), n * m,
                                                            3),
                               target[rows]).reshape(len(rows), n, m, 3)
        tgt = tgt.clone()
        tgt[rows] = near
    return _mean_dist(pred, tgt)


def pose_loss(pred_r, pred_t, logit, points, target, model, sym, w):
    """Phase-1 loss over all rows (every row valid) -> scalar."""
    q = normalize(pred_r)
    dis = hypothesis_dist(rotation(q), points + pred_t, model, target, sym)
    c = torch.sigmoid(logit)
    return (dis * c - w * F.logsigmoid(logit)).mean(1).mean()


class Adam:
    """Adam written out, over a list of tensors updated in place."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = \
            list(params), lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def tf32_round(x):
    """float32 values rounded to TF32's 10-bit mantissa (to nearest): the
    operands a TF32 tensor-core product sees."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@torch.no_grad()
def pose_distances(model, q, t, target, sym, tf32=False):
    """ADD, or ADD-S on ``sym`` rows, of poses (q (B, 4) wxyz, t (B, 3))
    -> (B,). ``tf32`` computes the products of the model points and the
    rotation from TF32 operands (a K=3 product never reaches the tensor
    cores, so the library's TF32 switch leaves it in float32)."""
    R = rotation(q)
    if tf32:
        model, R = tf32_round(model), tf32_round(R)
    pred = model @ R.transpose(1, 2) + t[:, None, :]
    add = _mean_dist(pred, target)
    adds = _mean_dist(pred, nearest_targets(pred, target))
    return torch.where(sym, adds, add)
