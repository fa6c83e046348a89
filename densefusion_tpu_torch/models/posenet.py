"""PoseNet: dense per-pixel fusion + per-point pose hypothesis heads
(counterpart of ``densefusion_tpu/models/posenet.py``).

Point features live in (B, N, C); every 1x1 Conv1d of the reference is
applied as a linear map over the channel axis with the Conv1d's own
(out, in, 1) weight, so the reference's state_dict loads as it is. The three
heads' first layers run as one matmul over the 1408-d feature, and the last
layer computes only each sample's own object's slice.

``dtype=torch.bfloat16`` is the JAX package's bf16 compute path: the CNN
computes in bf16, the fusion net casts the cloud and the embedding to bf16
and takes the global mean in bf16, the heads compute in bf16, and the
outputs are cast to float32 (``densefusion_tpu/models/posenet.py:36-43,
54,141,276-278``). Parameters, and so gradients, stay float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from densefusion_tpu_torch.models.layers import cast, linear
from densefusion_tpu_torch.models.pspnet import PSPNet
from densefusion_tpu_torch.utils.profiling import span

HEAD_WIDTHS = (640, 256, 128)


def point_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A k=1 Conv1d applied to (B, N, Cin) point features -> (B, N, Cout),
    in ``x``'s type."""
    return linear(x, conv.weight[..., 0], conv.bias)


def fusion_inputs(points, emb, dtype):
    """The fusion nets' inputs in the compute type ``dtype`` (None keeps
    them as they are)."""
    if dtype is None:
        return points, emb
    return points.to(dtype), emb.to(dtype)


class _Wrap(nn.Module):
    """Named nesting only: the reference wraps PSPNet in ModifiedResnet and
    DataParallel, so its keys read ``cnn.model.module.*``."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class DenseFusionFeat(nn.Module):
    """Per-point fusion pyramid: cloud (B, N, 3) + color emb (B, N, emb) ->
    [geo64 | col64] ++ [geo128 | col128] ++ global 1024 = (B, N, 1408), in
    the compute type ``dtype`` (None: float32)."""

    def __init__(self, emb_dim: int = 32, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.e_conv1 = nn.Conv1d(emb_dim, 64, 1)
        self.e_conv2 = nn.Conv1d(64, 128, 1)
        self.conv5 = nn.Conv1d(256, 512, 1)
        self.conv6 = nn.Conv1d(512, 1024, 1)

    def forward(self, points, emb):
        points, emb = fusion_inputs(points, emb, self.dtype)
        g1 = F.relu(point_conv(self.conv1, points))
        c1 = F.relu(point_conv(self.e_conv1, emb))
        g2 = F.relu(point_conv(self.conv2, g1))
        c2 = F.relu(point_conv(self.e_conv2, c1))
        feat2 = torch.cat([g2, c2], dim=-1)                  # (B, N, 256)
        x = F.relu(point_conv(self.conv5, feat2))
        x = F.relu(point_conv(self.conv6, x))
        glob = x.mean(dim=-2, keepdim=True).expand_as(x)     # (B, N, 1024)
        return torch.cat([g1, c1, feat2, glob], dim=-1)


def select_object(weight: torch.Tensor, bias: torch.Tensor, obj: torch.Tensor,
                  num_obj: int):
    """Per-sample class slice of a last head layer: weight (num_obj*D, K, ...)
    and bias (num_obj*D,) -> (B, D, K), (B, D)."""
    w = weight.reshape(num_obj, -1, weight.shape[1])
    return w[obj], bias.reshape(num_obj, -1)[obj]


def checkpointed(fn, generator, *args):
    """``fn(*args, generator)`` under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward pass. The recomputation
    draws the forward's dropout masks again: ``preserve_rng_state`` restores
    only torch's default generators, so ``generator`` is set back to its
    state at the forward for the recomputation and then returned to where
    it was (flax's ``nn.remat`` replays the same keys)."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(fn, *args, None,
                                                 use_reentrant=False)
    start = generator.get_state()
    ran = []

    def replay(*a):
        if not ran:   # the forward
            ran.append(True)
            return fn(*a)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    return torch.utils.checkpoint.checkpoint(replay, *args, generator,
                                             use_reentrant=False)


class PoseNet(nn.Module):
    """(img (B, H, W, 3), points (B, N, 3), choose (B, N) flat pixel
    indices into H*W, obj (B,)) -> dict of per-point hypotheses:

    pred_r (B, N, 4) unnormalized wxyz quaternions; pred_t (B, N, 3)
    translation offsets from each point; pred_c (B, N) confidence;
    pred_c_logit (B, N); emb (B, N, emb_dim) color embedding, detached.
    In train mode the CNN's dropout draws from ``generator``; with
    ``batch_rows=(start, stop, total)`` the inputs are rows ``start:stop``
    of a batch of ``total`` (one rank's rows in data-parallel training) and
    the masks are those rows of the whole batch's.

    Options of the JAX ``PoseNet``: ``cnn_variant`` is any trunk of
    ``RESNET_SPECS``; ``dtype`` the compute type (None: float32; the
    outputs are float32 either way); ``sparse_emb=False`` decodes the whole
    embedding map and gathers it at ``choose`` (the default decodes the
    last stage at the ``choose`` pixels only; the same values);
    ``remat_cnn`` recomputes the CNN in the backward pass instead of
    keeping its activations (:func:`checkpointed`; the same values and
    gradients).
    """

    def __init__(self, num_obj: int, cnn_variant: str = "resnet18",
                 emb_dim: int = 32, fused_decoder: bool = True,
                 align_corners: bool = False,
                 dtype: torch.dtype | None = None, sparse_emb: bool = True,
                 remat_cnn: bool = False):
        super().__init__()
        self.num_obj = num_obj
        self.cnn_variant = cnn_variant
        self.sparse_emb = sparse_emb
        self.remat_cnn = remat_cnn
        self.cnn = _Wrap(model=_Wrap(module=PSPNet(
            cnn_variant, emb_dim, fused_decoder=fused_decoder,
            align_corners=align_corners, dtype=dtype)))
        self.feat = DenseFusionFeat(emb_dim, dtype)
        for letter, out_dim in (("r", 4), ("t", 3), ("c", 1)):
            cin = 1408
            for i, width in enumerate(HEAD_WIDTHS + (num_obj * out_dim,),
                                      start=1):
                setattr(self, f"conv{i}_{letter}", nn.Conv1d(cin, width, 1))
                cin = width

    def _heads(self, feat, obj):
        """The three head stacks, layer 1 merged into one matmul."""
        first = [getattr(self, f"conv1_{c}") for c in "rtc"]
        y = F.relu(linear(feat, torch.cat([c.weight[..., 0] for c in first]),
                          torch.cat([c.bias for c in first])))
        width = HEAD_WIDTHS[0]
        outs = []
        for k, letter in enumerate("rtc"):
            x = y[..., k * width:(k + 1) * width]
            for i in (2, 3):
                x = F.relu(point_conv(getattr(self, f"conv{i}_{letter}"), x))
            last = getattr(self, f"conv4_{letter}")
            w, b = select_object(last.weight[..., 0], last.bias, obj,
                                 self.num_obj)
            outs.append(torch.bmm(x, cast(w, x).transpose(1, 2))
                        + cast(b, x)[:, None, :])
        return outs

    def _cnn(self, img, sample_at, generator, batch_rows=None):
        return self.cnn.model.module(img, sample_at=sample_at,
                                     generator=generator,
                                     batch_rows=batch_rows)

    def forward(self, img, points, choose, obj, generator=None,
                batch_rows=None):
        choose = choose.long()
        sample_at = choose if self.sparse_emb else None
        with span("posenet.cnn"):
            if self.remat_cnn and torch.is_grad_enabled():
                emb = checkpointed(functools.partial(self._cnn,
                                                     batch_rows=batch_rows),
                                   generator, img, sample_at)
            else:
                emb = self._cnn(img, sample_at, generator, batch_rows)
            if not self.sparse_emb:   # (B, H, W, d) map -> (B, N, d)
                b, h, w, d = emb.shape
                emb = torch.gather(emb.reshape(b, h * w, d), 1,
                                   choose[..., None].expand(-1, -1, d))
        with span("posenet.fusion"):
            feat = self.feat(points, emb)
            pred_r, pred_t, c = self._heads(feat, obj.long())
        logit = c[..., 0].float()
        return {"pred_r": pred_r.float(), "pred_t": pred_t.float(),
                "pred_c": torch.sigmoid(logit), "pred_c_logit": logit,
                "emb": emb.detach()}
