"""Semantic-segmentation cross-entropy (counterpart of
``densefusion_tpu/losses/seg_loss.py``): per-pixel softmax cross-entropy
over the class axis, averaged over the pixels, with an optional per-pixel
weight."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """logits ``(B, C, H, W)``, labels ``(B, H, W)`` int -> scalar: the mean
    cross-entropy, or with ``weights`` ``sum(ce * w) / max(sum(w), 1)``."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    if weights is None:
        return ce.mean()
    w = weights.to(ce.dtype)
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)
