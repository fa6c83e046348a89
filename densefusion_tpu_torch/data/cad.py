"""customCAD (Unity-rendered synthetic) dataset reader (counterpart of
``densefusion_tpu/data/cad.py``).

Covers the capabilities of ``datasets/customCAD/dataset.py:18-264``: Unity
FrameBuffer/Depth/mask PNGs, gt poses from ``transforms.txt`` (left-handed
quaternions converted to right-handed), non-linear z-buffer depth unprojected
through the inverse projection-matrix ray map
(``project_unity_depth.py:5-62``), 65535-valued rectangle masks, the y-180
axis fixup, and the final /10000 unit conversion to meters.

Every sample draws from its own ``default_rng((seed, epoch, index))`` in
the JAX reader's order: the translation noise, the model points, the cloud
pixels, then the jitter.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from densefusion_tpu_torch.data.schema import PoseSample
from densefusion_tpu_torch.data.ply import read_ply_vertices
from densefusion_tpu_torch.data.common import (
    assemble_sample, subsample_model_points,
)
from densefusion_tpu_torch.data.augment import color_jitter, translation_noise
from densefusion_tpu_torch.geometry.quaternion import unit_quat_matrix_np

# y-180 axis fixup applied to the gt rotation (dataset.py:184-197)
_Y_180 = np.diag([-1.0, 1.0, -1.0])
# infinite-distance (horizon) pixels are painted gray (dataset.py:97,132)
_HORIZON_GRAY = np.array([130, 130, 130], np.uint8)


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im)


def convert_left_handed_quat(q_xyzw: np.ndarray) -> np.ndarray:
    """Unity left-handed (x, y, z, w) -> right-handed (dataset.py:226-227):
    negate x and y. Returns xyzw for scipy-style consumption."""
    return np.array([-q_xyzw[0], -q_xyzw[1], q_xyzw[2], q_xyzw[3]])


def _quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return unit_quat_matrix_np(w, x, y, z)


class UnityDepthRayMap:
    """Inverse-projection ray map for Unity's non-linear z-buffer
    (``project_unity_depth.py:5-52``): NDC pixel rays through the inverse
    projection matrix, scaled per-pixel by the linearized depth."""

    def __init__(self, proj_mat: np.ndarray, image_dims: tuple[int, int]):
        self.proj_mat = np.asarray(proj_mat, np.float64)
        self.image_dims = image_dims
        h, w = image_dims
        inv = np.linalg.inv(self.proj_mat)
        xs = -1.0 + 2.0 * np.arange(w) / w
        ys = -(-1.0 + 2.0 * np.arange(h) / h)  # y axis inverted
        px = np.broadcast_to(xs[None, :], (h, w))
        py = np.broadcast_to(ys[:, None], (h, w))
        ndc = np.stack([px, py, -np.ones((h, w)), np.ones((h, w))], -1)
        rays = ndc @ inv.T
        rays /= rays[..., 3:4]
        rays /= rays[..., 2:3]
        self.ray_map = rays[..., :3]

    @classmethod
    def from_file(cls, proj_file: str, image_dims: tuple[int, int]):
        rows = []
        with open(proj_file) as f:
            for i, line in enumerate(f):
                if i == 4:
                    break
                rows.append([float(v) for v in line.split("\t") if v.strip()])
        return cls(np.array(rows), image_dims)

    def linearize(self, depth_png: np.ndarray) -> np.ndarray:
        d = depth_png.astype(np.float64) / 65534.0
        d = 1.0 - d
        return -self.proj_mat[2, 3] / (self.proj_mat[2, 2] + d)

    def unproject(self, depth_png: np.ndarray, rows: np.ndarray,
                  cols: np.ndarray) -> np.ndarray:
        z = self.linearize(depth_png[rows, cols])
        return self.ray_map[rows, cols] * z[:, None]


class CADDataset:
    """Unity customCAD scenes. Model PLYs are read x10 into the reference's
    0.1 mm units; the sample is assembled in those units and converted to
    meters at the end (``dataset.py:204-210``). The test split keeps every
    tenth frame from the tenth on (``frames[9::10]``)."""

    def __init__(self, root: str, mode: str = "train", num_points: int = 500,
                 add_noise: bool | None = None, noise_trans: float = 0.03,
                 refine: bool = False, crop_size: int = 192,
                 num_mesh_points: int = 500, seed: int = 0,
                 objlist: Sequence[int] = (1,),
                 image_dims: tuple[int, int] = (520, 1109)):
        self.root = root
        self.mode = mode
        self.num_points = num_points
        self.add_noise = (mode == "train") if add_noise is None else add_noise
        self.noise_trans = noise_trans
        self.refine = refine
        self.crop_size = crop_size
        self.num_mesh = num_mesh_points
        self.objlist = list(objlist)
        self.seed = seed
        self._epoch = 0

        self.items: list[tuple[int, int]] = []
        self.meta: dict[int, dict[int, tuple[np.ndarray, np.ndarray]]] = {}
        self.models: dict[int, np.ndarray] = {}
        self.raymaps: dict[int, UnityDepthRayMap] = {}
        for obj in self.objlist:
            base = os.path.join(root, "data", f"{obj:02d}")
            list_file = os.path.join(
                base, "train.txt" if mode == "train" else "test.txt")
            with open(list_file) as f:
                frames = [int(ln.strip()) for ln in f if ln.strip()]
            if mode == "test":
                # only 'test' subsamples, with the same running-counter
                # semantics as LineMOD (customCAD/dataset.py:43) — eval
                # iterates the full list
                frames = frames[9::10]
            self.items += [(obj, fr) for fr in frames]

            self.meta[obj] = {}
            with open(os.path.join(base, "meta", "transforms.txt")) as f:
                lines = [ln.rstrip("\n") for ln in f]
            i = 0
            while i + 2 < len(lines) + 1:
                try:
                    idx = int(lines[i].strip())
                except (ValueError, IndexError):
                    break
                clean = lambda s: [float(x) for x in
                                   s.replace("(", "").replace(")", "")
                                   .replace(",", "").split()]
                pos = np.array(clean(lines[i + 1]))
                quat = np.array(clean(lines[i + 2]))
                self.meta[obj][idx] = (pos, quat)
                i += 3

            # reference: o3d mesh sampled to 3000 points then *10
            # (dataset.py:168,251-262); our PLYs carry vertices directly
            self.models[obj] = read_ply_vertices(
                os.path.join(root, "models", f"obj_{obj:02d}.ply")) * 10.0
            self.raymaps[obj] = UnityDepthRayMap.from_file(
                os.path.join(base, "meta", "proj_mat.txt"), image_dims)

    def __len__(self):
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._epoch, index))

    @property
    def sym_list(self) -> list[int]:
        return []  # dataset.py:216-217

    @property
    def num_points_mesh(self) -> int:
        return self.num_mesh

    def __getitem__(self, index: int) -> PoseSample:
        rng = self._rng(index)
        obj, frame = self.items[index]
        base = os.path.join(self.root, "data", f"{obj:02d}")
        rgb = _load_image(
            os.path.join(base, "rgb", f"FrameBuffer_{frame:04d}.png"))[..., :3]
        depth = _load_image(os.path.join(base, "depth", f"Depth_{frame:04d}.png"))
        label = _load_image(os.path.join(base, "mask", f"{frame:04d}.png"))

        # transforms are 1-off from image indices (dataset.py:117)
        pos, quat = self.meta[obj][frame + 1]

        max_d = depth.max()
        mask = (label == 65535) & (depth != max_d)

        rgb = np.asarray(rgb).copy()
        rgb[depth == max_d] = _HORIZON_GRAY  # paint out the horizon

        bbox_pix = np.where(label == 65535)
        if bbox_pix[0].size == 0:
            return PoseSample.invalid(self.num_points, self.num_mesh,
                                      self.crop_size)
        bbox = (int(bbox_pix[0].min()), int(bbox_pix[0].max()),
                int(bbox_pix[1].min()), int(bbox_pix[1].max()))

        R_gt = _quat_xyzw_to_matrix(convert_left_handed_quat(quat)) @ _Y_180
        t_gt = pos * 1000.0
        t_gt[2] = -t_gt[2]

        add_t = (translation_noise(rng, self.noise_trans)
                 if self.add_noise else None)
        rgb_transform = ((lambda crop: color_jitter(crop, rng))
                         if self.add_noise else None)

        model = subsample_model_points(self.models[obj], self.num_mesh, rng)
        target = (model @ R_gt.T + t_gt) / 10000.0
        raymap = self.raymaps[obj]

        def point_fn(rows, cols):
            return raymap.unproject(depth, rows, cols) / 10000.0

        return assemble_sample(
            rgb=rgb, mask=mask, bbox=bbox, point_fn=point_fn,
            model_points=model / 10000.0, target=target,
            obj_idx=self.objlist.index(obj), sym=False,
            num_points=self.num_points, crop_size=self.crop_size,
            rng=rng, add_t=add_t, rgb_transform=rgb_transform,
        )
