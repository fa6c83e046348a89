"""Segmentation datasets: full frames with per-pixel labels (counterpart of
``densefusion_tpu/data/seg.py``).

Covers ``vanilla_segmentation/data_controller.py:17-97``: YCB frames with
22-class labels, the background of synthetic frames composited from a real
frame where the label is 0, joint horizontal / vertical flips, and
ColorJitter on training frames; and LineMOD frames whose binary masks
become object-id labels. Each sample's draws come from
``default_rng((seed, epoch, index))`` in the JAX package's order (jitter,
background, the two flips), so every field equals the JAX reader's.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from densefusion_tpu_torch.data.augment import color_jitter
from densefusion_tpu_torch.data.schema import normalize_image


class SegSample(NamedTuple):
    rgb: np.ndarray    # (H, W, 3) f32 normalized
    label: np.ndarray  # (H, W) int32


def collate_seg(samples: Sequence[SegSample]) -> SegSample:
    return SegSample(np.stack([s.rgb for s in samples]),
                     np.stack([s.label for s in samples]))


def seg_to_device(batch: SegSample, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """A collated batch -> ``(rgb (B, 3, H, W) float32, label (B, H, W)
    int64)`` on ``device``: NCHW, as :class:`~densefusion_tpu_torch.models.
    SegNet` takes it."""
    rgb = torch.as_tensor(batch.rgb, dtype=torch.float32, device=device)
    label = torch.as_tensor(batch.label, device=device).long()
    return rgb.permute(0, 3, 1, 2).contiguous(), label


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(path))


def _flips(rgb, label, rng):
    """Joint flips (``data_controller.py:70-82``)."""
    if rng.random() < 0.5:
        rgb, label = rgb[:, ::-1], label[:, ::-1]
    if rng.random() < 0.5:
        rgb, label = rgb[::-1], label[::-1]
    return rgb, label


class LinemodSegDataset:
    """LineMOD-format frames: rgb and the binary object mask -> object-id
    label maps (labels are the raw LineMOD ids, so ``num_classes`` is
    ``max(objlist) + 1``). One multi-object SegNet trained on them writes
    (``cli.segment --binary_class <obj>``) the ``segnet_results/`` masks
    that ``LineModDataset(mode="eval")`` reads. Training frames get the
    jitter and the joint flips."""

    def __init__(self, root: str, mode: str = "train",
                 objlist: Sequence[int] | None = None, seed: int = 0,
                 use_noise: bool | None = None):
        from densefusion_tpu_torch.data.linemod import LINEMOD_OBJLIST
        self.root = root
        self.mode = mode
        self.use_noise = (mode == "train") if use_noise is None else use_noise
        self.seed = seed
        self._epoch = 0
        self.objlist = (list(objlist) if objlist is not None
                        else list(LINEMOD_OBJLIST))
        self.items: list[tuple[int, int]] = []
        for obj in self.objlist:
            list_file = os.path.join(
                root, "data", f"{obj:02d}",
                "train.txt" if mode == "train" else "test.txt")
            with open(list_file) as f:
                self.items += [(obj, int(ln)) for ln in f if ln.strip()]

    @property
    def num_classes(self) -> int:
        return max(self.objlist) + 1

    def __len__(self):
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, index: int) -> SegSample:
        rng = np.random.default_rng((self.seed, self._epoch, index))
        obj, frame = self.items[index]
        base = os.path.join(self.root, "data", f"{obj:02d}")
        rgb = _load_image(
            os.path.join(base, "rgb", f"{frame:04d}.png"))[..., :3]
        mask = _load_image(os.path.join(base, "mask", f"{frame:04d}.png"))
        mask = mask == 255
        if mask.ndim == 3:
            mask = mask[..., 0]
        label = mask.astype(np.int32) * obj
        if self.use_noise:
            rgb = color_jitter(rgb, rng)
            rgb, label = _flips(rgb, label, rng)
        return SegSample(rgb=normalize_image(np.ascontiguousarray(rgb)),
                         label=np.ascontiguousarray(label))


class SegDataset:
    """YCB-Video frames (``-color.png`` / ``-label.png``) from the
    ``dataset_config`` lists; frames outside ``data/`` are synthetic, and
    in training their label-0 pixels take a random real frame's color."""

    def __init__(self, root: str, mode: str = "train",
                 config_dir: str | None = None, seed: int = 0,
                 use_noise: bool | None = None):
        self.root = root
        self.mode = mode
        self.use_noise = (mode == "train") if use_noise is None else use_noise
        self.seed = seed
        self._epoch = 0
        cfg = config_dir or os.path.join(root, "dataset_config")
        list_file = os.path.join(
            cfg, "train_data_list.txt" if mode == "train"
            else "test_data_list.txt")
        with open(list_file) as f:
            self.frames = [ln.strip() for ln in f if ln.strip()]
        self.real = [fr for fr in self.frames if fr.startswith("data/")]

    def __len__(self):
        return len(self.frames)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, index: int) -> SegSample:
        rng = np.random.default_rng((self.seed, self._epoch, index))
        frame = self.frames[index]
        base = os.path.join(self.root, frame)
        rgb = _load_image(base + "-color.png")[..., :3]
        label = _load_image(base + "-label.png").astype(np.int32)
        is_syn = not frame.startswith("data/")
        if self.use_noise:
            rgb = color_jitter(rgb, rng)
            if is_syn and self.real:
                back_frame = self.real[rng.integers(len(self.real))]
                back = _load_image(os.path.join(
                    self.root, back_frame) + "-color.png")[..., :3]
                rgb = np.where((label == 0)[..., None], back, rgb)
            rgb, label = _flips(rgb, label, rng)
        return SegSample(rgb=normalize_image(np.ascontiguousarray(rgb)),
                         label=np.ascontiguousarray(label))
