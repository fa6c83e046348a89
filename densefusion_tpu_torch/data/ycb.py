"""YCB-Video dataset reader (counterpart of ``densefusion_tpu/data/ycb.py``).

Real and synthetic frame lists, two intrinsics sets selected by video
index, a random object pick per frame (more than 50 valid depth pixels),
synthetic-frame augmentation (a real background composited behind the
render, two objects of another synthetic frame pasted in front as
occluders, gaussian pixel noise), ColorJitter, translation noise,
1000-point clouds, 500 (train) / 2600 (refine) mesh points, symmetric
classes {12, 15, 18, 19, 20}.

Every sample draws from its own ``default_rng((seed, epoch, index))`` in a
fixed order: the occluder frame and ids, the object permutation, the
background frame, the noise seed, the jitter, the translation noise, the
model points, the cloud pixels, then (on the numpy path) the pixel noise.
That order is part of the sample: the JAX reader's draws come in the same
one. The host library (:mod:`densefusion_tpu_torch.native`) composites the
occluders and scans the label in one frame pass, makes the object mask for
the crop window only, and adds the pixel noise from its fixed pool; the
numpy code is its plain version.
"""

from __future__ import annotations

import os

import numpy as np

from densefusion_tpu_torch import native
from densefusion_tpu_torch.geometry.bbox import bbox_from_mask
from densefusion_tpu_torch.geometry.camera import YCB_CAM_1, YCB_CAM_2
from densefusion_tpu_torch.data.schema import PoseSample
from densefusion_tpu_torch.data.common import (
    assemble_sample, subsample_model_points, pinhole_point_fn,
)
from densefusion_tpu_torch.data.augment import (
    jitter_params, apply_color_jitter, translation_noise,
    gaussian_pixel_noise,
)
from densefusion_tpu_torch.data.cache import ImageCache

YCB_SYM = [12, 15, 18, 19, 20]
YCB_NUM_OBJECTS = 21


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im)


def _load_mat(path: str):
    import scipy.io as scio
    return scio.loadmat(path)


def _load_models(root: str, classes: list[str]) -> dict[int, np.ndarray]:
    """Class id (1-based) -> the class's ``points.xyz`` model, meters."""
    return {cid: np.loadtxt(os.path.join(root, "models", cls, "points.xyz"),
                            dtype=np.float32)
            for cid, cls in enumerate(classes, start=1)}


def _read_list(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class YCBDataset:
    def __init__(self, root: str, mode: str = "train", num_points: int = 1000,
                 add_noise: bool | None = None, noise_trans: float = 0.03,
                 refine: bool = False, crop_size: int = 192,
                 config_dir: str | None = None, seed: int = 0,
                 minimum_num_pt: int = 50, cache_frames: int = 2048):
        self.root = root
        self.mode = mode
        self.num_points = num_points
        self.add_noise = (mode == "train") if add_noise is None else add_noise
        self.noise_trans = noise_trans
        self.refine = refine
        self.crop_size = crop_size
        self.minimum_num_pt = minimum_num_pt
        self.seed = seed
        self._epoch = 0
        self.cache = ImageCache(cache_frames)
        self._label_ids: dict[str, list] = {}
        self._meta_cache: dict[str, tuple] = {}
        self._meta_cap = max(4 * cache_frames, 256)
        # 500 mesh points, 2600 once refinement starts
        self.num_mesh = 2600 if refine else 500

        cfg = config_dir or os.path.join(root, "dataset_config")
        self.frames = _read_list(os.path.join(
            cfg, "train_data_list.txt" if mode == "train"
            else "test_data_list.txt"))
        # real frames start with 'data/', synthetic ones are 'data_syn/...'
        self.real = [fr for fr in self.frames if fr.startswith("data/")]
        self.syn = [fr for fr in self.frames if not fr.startswith("data/")]
        self.classes = _read_list(os.path.join(cfg, "classes.txt"))
        self.models = _load_models(root, self.classes)

    def __len__(self):
        return len(self.frames)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        """Per-(seed, epoch, sample) generator: the same sample whatever
        worker assembles it."""
        return np.random.default_rng((self.seed, self._epoch, index))

    @property
    def sym_list(self) -> list[int]:
        return list(YCB_SYM)

    @property
    def num_points_mesh(self) -> int:
        return self.num_mesh

    def _intrinsics(self, frame: str):
        """Real videos from index 60 on were taken with the second camera."""
        if frame.startswith("data/") and int(frame[5:9]) >= 60:
            return YCB_CAM_2
        return YCB_CAM_1

    def _frame_paths(self, frame: str):
        base = os.path.join(self.root, frame)
        return (base + "-color.png", base + "-depth.png",
                base + "-label.png", base + "-meta.mat")

    def frame_info(self, index: int):
        """(rgb_path, intrinsics) behind sample ``index``."""
        frame = self.frames[index]
        return self._frame_paths(frame)[0], self._intrinsics(frame)

    def _load_meta(self, path: str) -> tuple:
        """Cached (cls_indexes, poses, factor_depth): static per frame."""
        got = self._meta_cache.get(path)
        if got is not None:
            return got
        meta = _load_mat(path)
        got = (meta["cls_indexes"].flatten().astype(np.int32),
               meta["poses"], float(meta["factor_depth"].flatten()[0]))
        if len(self._meta_cache) >= self._meta_cap:   # FIFO-ish bound
            self._meta_cache.pop(next(iter(self._meta_cache)), None)
        self._meta_cache[path] = got
        return got

    def _composite_front(self, label: np.ndarray, depth: np.ndarray,
                         fused: bool, rng: np.random.Generator):
        """Paste two objects of another synthetic frame in front as
        occluders: their pixels leave the current label, so an occluded
        object's visible mask shrinks. Up to five tries for an occluded
        label that keeps more than 1000 object pixels. Returns (label,
        mask_front, front, counts, bboxes): ``mask_front`` is True where the
        frame is NOT occluded, ``front`` the occluders' frame, both None
        when no try was accepted. ``fused`` (the library's path) also gives
        the occluded label's per-id depth-valid counts and tight bboxes from
        the same frame pass; otherwise those are None."""
        for _ in range(5):
            seed_frame = self.syn[rng.integers(len(self.syn))]
            c_path, _, l_path, _ = self._frame_paths(seed_frame)
            front = self.cache.load(c_path)[..., :3]
            f_label = self.cache.load(l_path)
            ids = self._label_ids.get(l_path)
            if ids is None:   # per-path object-id cache
                ids = [i for i in np.unique(f_label) if i != 0]
                self._label_ids[l_path] = ids
            if len(ids) < 2:
                continue
            pick = rng.choice(ids, size=2, replace=False)
            if fused:
                t_label, mask_front, count, counts, bboxes = \
                    native.apply_front_hist_bbox(
                        label, f_label, depth, int(pick[0]), int(pick[1]))
                if count > 1000:
                    return t_label, mask_front, front, counts, bboxes
            else:
                mask_front = ~np.isin(f_label, pick)
                t_label = label * mask_front
                if (t_label != 0).sum() > 1000:
                    return t_label, mask_front, front, None, None
        return label, None, None, None, None

    def __getitem__(self, index: int) -> PoseSample:
        rng = self._rng(index)
        frame = self.frames[index]
        c_path, d_path, l_path, m_path = self._frame_paths(frame)
        rgb = self.cache.load(c_path)[..., :3]
        depth = self.cache.load(d_path)
        label = self.cache.load(l_path)
        objs, poses, cam_scale = self._load_meta(m_path)
        is_syn = not frame.startswith("data/")
        # the library's one-pass scans take 16-bit depth and 8-bit labels
        fused = (native.available() and depth.dtype == np.uint16
                 and label.dtype == np.uint8)

        mask_front = front = counts = bboxes = None
        if self.add_noise:
            label, mask_front, front, counts, bboxes = \
                self._composite_front(label, depth, fused, rng)

        # a random object with enough depth-valid pixels
        order = rng.permutation(len(objs))
        if fused:
            if counts is None:   # no accepted occluder: one hist+bbox pass
                counts, bboxes = native.label_hist_bbox(label, depth)
            pick = next((k for k in order
                         if counts[objs[k]] > self.minimum_num_pt), None)
        else:
            mask_depth = depth != 0
            pick = next((k for k in order
                         if ((label == objs[k]) & mask_depth).sum()
                         > self.minimum_num_pt), None)
        if pick is None:
            return PoseSample.invalid(self.num_points, self.num_mesh,
                                      self.crop_size)
        obj_id = int(objs[pick])
        mask = mask_fn = None
        if fused:
            # the bbox came out of the scan; the mask is made later for the
            # snapped crop window only, the one region read
            bb = bboxes[obj_id]
            bbox = None if bb[0] < 0 else tuple(int(v) for v in bb)

            def mask_fn(rmin, rmax, cmin, cmax, _label=label):
                return native.object_mask_window(
                    _label, depth, obj_id, rmin, rmax, cmin, cmax)
        else:
            mask_label = label == obj_id
            mask = mask_label & mask_depth
            # the whole label: an occluder may split the object into islands
            bbox = bbox_from_mask(mask_label, largest_component=False)

        back = None
        if is_syn:  # a real background behind the render
            back_frame = self.real[rng.integers(len(self.real))]
            back = self.cache.load(self._frame_paths(back_frame)[0])[..., :3]

        if bbox is None:
            return PoseSample.invalid(self.num_points, self.num_mesh,
                                      self.crop_size)

        # the pixel noise's seed: the library's noise is a slice of a fixed
        # pool at an offset from it (the numpy path draws from ``rng``)
        noise_seed = int(rng.integers(2 ** 63)) if is_syn else 0
        jitter = jitter_params(rng) if self.add_noise else None

        def crop_fn(rmin, rmax, cmin, cmax):
            # compositing, jitter and noise on the snapped crop only
            win = np.s_[rmin:rmax, cmin:cmax]
            crop = rgb[win]
            if fused and (back is not None or mask_front is not None):
                crop = native.compose_crop(
                    crop, None if back is None else back[win],
                    None if back is None else label[win],
                    None if mask_front is None else front[win],
                    None if mask_front is None else mask_front[win])
            else:
                if back is not None:
                    crop = np.where((label[win] == 0)[..., None], back[win],
                                    crop)
                if mask_front is not None:
                    crop = np.where(mask_front[win][..., None], crop,
                                    front[win])
            if jitter is not None:
                crop = apply_color_jitter(crop, jitter)
            if is_syn:
                crop = gaussian_pixel_noise(crop, rng, 7.0, seed=noise_seed)
            return crop

        pose = poses[:, :, pick]
        R_gt = pose[:, :3].astype(np.float64)
        t_gt = pose[:, 3].astype(np.float64)

        add_t = (translation_noise(rng, self.noise_trans)
                 if self.add_noise else None)

        model = subsample_model_points(self.models[obj_id], self.num_mesh,
                                       rng)
        target = model @ R_gt.T + t_gt
        point_fn = pinhole_point_fn(depth, self._intrinsics(frame), cam_scale)

        return assemble_sample(
            crop_fn=crop_fn, mask=mask, mask_fn=mask_fn,
            frame_hw=label.shape, bbox=bbox, point_fn=point_fn,
            model_points=model, target=target,
            obj_idx=obj_id - 1,  # 0-based class
            sym=(obj_id - 1) in YCB_SYM,
            num_points=self.num_points, crop_size=self.crop_size,
            rng=rng, add_t=add_t,
        )


class YCBPoseCNNEvalDataset:
    """YCB keyframe eval set driven by PoseCNN detections.

    For each keyframe, each PoseCNN roi becomes one sample: bbox from the
    roi (snapped to the ladder), mask from the PoseCNN label image and valid
    depth, 1000-point cloud at cam_scale 10000. The ground-truth pose from
    the frame meta rides along (``target``) for in-loop diagnostics.
    """

    def __init__(self, root: str, posecnn_results_dir: str,
                 num_points: int = 1000, crop_size: int = 192,
                 config_dir: str | None = None, num_keyframes: int = 2949,
                 seed: int = 0, native_crop: bool = False):
        self.root = root
        self.posecnn_dir = posecnn_results_dir
        self.native_crop = native_crop
        self.num_points = num_points
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)
        cfg = config_dir or os.path.join(root, "dataset_config")
        self.frames = _read_list(
            os.path.join(cfg, "test_data_list.txt"))[:num_keyframes]
        self.classes = _read_list(os.path.join(cfg, "classes.txt"))
        self.models = _load_models(root, self.classes)

    def __len__(self):
        return len(self.frames)

    def detections(self, frame_idx: int):
        """All PoseCNN detections of one keyframe: a list of
        ``(PoseSample, frame_index, itemid)``."""
        frame = self.frames[frame_idx]
        base = os.path.join(self.root, frame)
        rgb = _load_image(base + "-color.png")[..., :3]
        depth = _load_image(base + "-depth.png")
        meta = _load_mat(base + "-meta.mat")
        posecnn = _load_mat(os.path.join(self.posecnn_dir,
                                         f"{frame_idx:06d}.mat"))
        label = np.asarray(posecnn["labels"])
        rois = np.asarray(posecnn["rois"])

        cam = YCB_CAM_1  # the keyframes all come from videos below 60
        cam_scale = 10000.0
        gt_ids = meta["cls_indexes"].flatten().astype(np.int32)

        out = []
        for k in range(rois.shape[0]):
            itemid = int(rois[k, 1])
            # roi layout: [_, itemid, cmin, rmin, cmax, rmax]
            rmin, rmax = int(rois[k][3]) + 1, int(rois[k][5]) - 1
            cmin, cmax = int(rois[k][2]) + 1, int(rois[k][4]) - 1
            mask = (label == itemid) & (depth != 0)

            model = subsample_model_points(self.models[itemid], 500, self.rng)
            point_fn = pinhole_point_fn(depth, cam, cam_scale)
            which = np.flatnonzero(gt_ids == itemid)
            if which.size:
                pose = meta["poses"][:, :, which[0]]
                target = model @ pose[:, :3].astype(np.float64).T + \
                    pose[:, 3].astype(np.float64)
            else:
                target = model  # a false positive: no gt, the scorer skips it

            # a false positive with a usable mask still gets an estimate;
            # only an unusable mask gives an invalid sample
            sample = assemble_sample(
                rgb=rgb, mask=mask, bbox=(rmin, rmax, cmin, cmax),
                point_fn=point_fn, model_points=model, target=target,
                obj_idx=itemid - 1, sym=(itemid - 1) in YCB_SYM,
                num_points=self.num_points, crop_size=self.crop_size,
                rng=self.rng, native_crop=self.native_crop)
            out.append((sample, frame_idx, itemid))
        return out
