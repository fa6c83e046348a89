"""LineMOD (Linemod_preprocessed layout) dataset reader (counterpart of
``densefusion_tpu/data/linemod.py``).

13 objects, gt poses from per-object ``gt.yml``, models from ASCII PLY (mm),
train/test lists with 1/10 test subsampling, an eval mode on predicted
SegNet masks from ``segnet_results/`` with mask-derived bboxes, symmetric
objects eggbox and glue.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from densefusion_tpu_torch.geometry.bbox import bbox_from_mask
from densefusion_tpu_torch.geometry.camera import LINEMOD_CAM
from densefusion_tpu_torch.data.schema import PoseSample
from densefusion_tpu_torch.data.ply import read_ply_vertices
from densefusion_tpu_torch.data.common import (
    assemble_sample, subsample_model_points, pinhole_point_fn,
)
from densefusion_tpu_torch.data.augment import color_jitter, translation_noise
from densefusion_tpu_torch.data.cache import ImageCache

LINEMOD_OBJLIST = [1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15]
# symmetric objects by OBJECT ID: 10 = eggbox, 11 = glue (the reference's
# sym indices [7, 8] are their positions in the full objlist; keying on ids
# keeps custom objlist subsets right)
LINEMOD_SYM_IDS = (10, 11)
LINEMOD_SYM = [LINEMOD_OBJLIST.index(i) for i in LINEMOD_SYM_IDS]


def _load_yaml(path: str):
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


class LineModDataset:
    """Mode 'train' (gt masks and bboxes, augmented), 'test' (gt masks,
    every 10th frame), or 'eval' (SegNet-predicted masks, mask bboxes)."""

    def __init__(self, root: str, mode: str = "train", num_points: int = 500,
                 add_noise: bool | None = None, noise_trans: float = 0.03,
                 refine: bool = False, crop_size: int = 192,
                 num_mesh_points: int = 500, seed: int = 0,
                 objlist: Sequence[int] | None = None,
                 cache_frames: int = 4096,
                 native_crop: bool = False):
        self.root = root
        self.mode = mode
        self.num_points = num_points
        self.add_noise = (mode == "train") if add_noise is None else add_noise
        self.noise_trans = noise_trans
        self.refine = refine
        self.crop_size = crop_size
        self.num_mesh = num_mesh_points
        # variable snapped-shape crops (no resize): eval only, since samples
        # of differing shapes cannot collate into one batch
        self.native_crop = native_crop
        self.objlist = (list(objlist) if objlist is not None
                        else list(LINEMOD_OBJLIST))
        self.seed = seed
        self._epoch = 0
        # decoded-frame LRU: LineMOD repeats each epoch 20x, so decode once
        self.cache = ImageCache(cache_frames)

        self.items: list[tuple[int, int]] = []  # (obj, frame_id)
        self.meta: dict[int, dict] = {}
        self.models: dict[int, np.ndarray] = {}
        for obj in self.objlist:
            list_file = os.path.join(
                root, "data", f"{obj:02d}",
                "train.txt" if mode == "train" else "test.txt")
            with open(list_file) as f:
                frames = [ln.strip() for ln in f if ln.strip()]
            if mode == "test":
                # the reference keeps every 10th line, 1-based, of each
                # test list; 'eval' iterates the full list
                frames = frames[9::10]
            self.items += [(obj, int(fr)) for fr in frames]
            self.meta[obj] = _load_yaml(
                os.path.join(root, "data", f"{obj:02d}", "gt.yml"))
            self.models[obj] = read_ply_vertices(
                os.path.join(root, "models", f"obj_{obj:02d}.ply")) / 1000.0

    def __len__(self):
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        """Per-(seed, epoch, sample) generator: the same sample whatever
        worker assembles it."""
        return np.random.default_rng((self.seed, self._epoch, index))

    @property
    def sym_list(self) -> list[int]:
        """Positions of the symmetric objects within THIS objlist."""
        return [self.objlist.index(i) for i in LINEMOD_SYM_IDS
                if i in self.objlist]

    @property
    def num_points_mesh(self) -> int:
        return self.num_mesh

    def _gt_entry(self, obj: int, frame: int) -> dict:
        entries = self.meta[obj][frame]
        if obj == 2:  # frame contains several objects; pick obj_id 2
            for e in entries:
                if e["obj_id"] == 2:
                    return e
        return entries[0]

    def __getitem__(self, index: int) -> PoseSample:
        rng = self._rng(index)
        obj, frame = self.items[index]
        base = os.path.join(self.root, "data", f"{obj:02d}")
        rgb = self.cache.load(
            os.path.join(base, "rgb", f"{frame:04d}.png"))[..., :3]
        depth = self.cache.load(
            os.path.join(base, "depth", f"{frame:04d}.png"))
        if self.mode == "eval":
            label_path = os.path.join(self.root, "segnet_results",
                                      f"{obj:02d}_label",
                                      f"{frame:04d}_label.png")
        else:
            label_path = os.path.join(base, "mask", f"{frame:04d}.png")
        mask_label = self.cache.load(label_path) == 255
        if mask_label.ndim == 3:
            mask_label = mask_label[..., 0]
        mask = mask_label & (depth != 0)

        meta = self._gt_entry(obj, frame)
        R_gt = np.asarray(meta["cam_R_m2c"], np.float64).reshape(3, 3)
        t_gt = np.asarray(meta["cam_t_m2c"], np.float64) / 1000.0

        if self.mode == "eval":
            bbox = bbox_from_mask(mask_label)
            if bbox is None:
                return PoseSample.invalid(self.num_points, self.num_mesh,
                                          self.crop_size)
        else:
            x, y, w, h = meta["obj_bb"]   # gt bbox is (x, y, w, h)
            bbox = (y, y + h, x, x + w)

        add_t = (translation_noise(rng, self.noise_trans)
                 if self.add_noise else None)
        rgb_transform = ((lambda crop: color_jitter(crop, rng))
                         if self.add_noise else None)

        model = subsample_model_points(self.models[obj], self.num_mesh, rng)
        target = model @ R_gt.T + t_gt

        cam = LINEMOD_CAM
        point_fn = pinhole_point_fn(depth, cam, cam.depth_scale,
                                    unit_scale=1e-3)  # mm -> m

        return assemble_sample(
            rgb=rgb, mask=mask, bbox=bbox, point_fn=point_fn,
            model_points=model, target=target,
            obj_idx=self.objlist.index(obj),
            sym=obj in LINEMOD_SYM_IDS,
            num_points=self.num_points, crop_size=self.crop_size,
            rng=rng, add_t=add_t, rgb_transform=rgb_transform,
            native_crop=self.native_crop,
        )

    def frame_info(self, index: int):
        """(rgb_path, intrinsics) behind sample ``index``."""
        obj, frame = self.items[index]
        return (os.path.join(self.root, "data", f"{obj:02d}", "rgb",
                             f"{frame:04d}.png"), LINEMOD_CAM)

    def diameters(self, models_info_path: str | None = None) -> np.ndarray:
        """Model diameters in meters (``models_info.yml``), for the
        0.1-diameter success metric."""
        path = models_info_path or os.path.join(self.root, "models",
                                                "models_info.yml")
        info = _load_yaml(path)
        return np.array([info[o]["diameter"] / 1000.0 for o in self.objlist])
