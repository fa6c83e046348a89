"""FallingThings (FAT) dataset support: the scene reader, the pose decodes,
back-projection, whole-frame reconstruction and the geometric verification
tool (counterpart of ``densefusion_tpu/data/fat.py``; host float64 numpy,
the same arithmetic).

Covers the capabilities of the reference's ``datasets/FallingThings/``
scripts (``verify_fat.py``, ``testfat_rescale.py``, ``3d_reconstruct_combo
.py`` — SURVEY.md §2.1): parsing FAT scene annotations and checking that
``model_points · fixed_model_transform · pose`` lands on the depth-
back-projected object cloud (the fork's main QA mechanism,
``datasets/FallingThings/README.md:1-9``).

Format facts (from the committed fixtures and scripts):
* ``_object_settings.json``: per-class ``fixed_model_transform`` — a 4x4 in
  TRANSPOSED convention (translation in the last ROW) and centimeter x100
  scale; ``segmentation_class_id`` labels the seg PNG.
* ``_camera_settings.json``: left/right pinhole intrinsics.
* ``{frame:06d}.{side}.json``: per-object ``pose_transform_permuted`` (also
  transposed; the rotation needs ``R = M[:3,:3].T @ P`` with the fixed axis
  permutation ``P = [[0,0,1],[1,0,0],[0,-1,0]]`` — ``verify_fat.py:55-58,113``),
  translation in cm, plus ``bounding_box`` in (y, x) order.
* ``.depth.png``: 16-bit depth in 0.1 mm units (/10000 -> meters).
"""

from __future__ import annotations

import json
import os

import numpy as np

# the FAT pose axis permutation (verify_fat.py:55-58)
FAT_PERMUTATION = np.array([[0.0, 0.0, 1.0],
                            [1.0, 0.0, 0.0],
                            [0.0, -1.0, 0.0]])
FAT_DEPTH_SCALE = 10000.0  # 0.1 mm units -> meters
FAT_CM = 100.0             # annotation translations are in cm


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(path))


class FATObjectSettings:
    def __init__(self, scene_dir: str):
        with open(os.path.join(scene_dir, "_object_settings.json")) as f:
            data = json.load(f)
        self.classes = data["exported_object_classes"]
        self.objects = {}
        for obj in data["exported_objects"]:
            m = np.asarray(obj["fixed_model_transform"], np.float64)
            # transposed convention: rotation = M[:3,:3].T, translation row 3
            self.objects[obj["class"]] = {
                "seg_id": obj["segmentation_class_id"],
                "fixed_rotation": m[:3, :3].T / FAT_CM,
                "fixed_translation": m[3, :3] / FAT_CM,
                "cuboid_dimensions": np.asarray(
                    obj.get("cuboid_dimensions", [0, 0, 0])),
            }


class FATCameraSettings:
    def __init__(self, scene_dir: str):
        with open(os.path.join(scene_dir, "_camera_settings.json")) as f:
            data = json.load(f)
        self.cams = {}
        for cam in data["camera_settings"]:
            s = cam["intrinsic_settings"]
            self.cams[cam["name"]] = dict(
                fx=float(s["fx"]), fy=float(s["fy"]),
                cx=float(s["cx"]), cy=float(s["cy"]),
                width=cam["captured_image_size"]["width"],
                height=cam["captured_image_size"]["height"])


def fat_pose(obj_annotation: dict) -> tuple[np.ndarray, np.ndarray]:
    """(R, t): rotation (world->cam of the FIXED model) and translation in
    meters, decoded from ``pose_transform_permuted``
    (``verify_fat.py:113-118,229``)."""
    m = np.asarray(obj_annotation["pose_transform_permuted"], np.float64)
    R = m[:3, :3].T @ FAT_PERMUTATION
    t = m[3, :3] / FAT_CM
    return R, t


def fat_pose_plain(obj_annotation: dict) -> tuple[np.ndarray, np.ndarray]:
    """(R, t) decoded from the PLAIN ``pose_transform`` + ``location``
    annotation — the randomized-scene convention exercised by
    ``test_randomize.py:133-141`` (same ``M[:3,:3].T @ P`` recipe; the
    translation comes from ``location`` when present, else the matrix row,
    both in cm — ``3d_reconstruct_combo.py:104-109,161``)."""
    m = np.asarray(obj_annotation["pose_transform"], np.float64)
    R = m[:3, :3].T @ FAT_PERMUTATION
    if "location" in obj_annotation:
        t = np.asarray(obj_annotation["location"], np.float64) / FAT_CM
    else:
        t = m[3, :3] / FAT_CM
    return R, t


def rotation_from_quaternion_xyzw(q) -> np.ndarray:
    """Camera-frame rotation R from the annotation's ``quaternion_xyzw``.

    The reference's ``getPoseTransPermuted`` (``test_randomize.py:20-58``:
    wxyz-formula on the xyzw vector, column swaps, transpose, sign flip)
    reduces algebraically to ``P @ R.T`` — i.e. exactly the
    ``pose_transform_permuted`` rotation block. We build R directly.
    """
    x, y, z, w = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (w * x + y * z), 1 - 2 * (x * x + y * y)],
    ])


def permuted_matrix_from_quaternion_xyzw(q) -> np.ndarray:
    """``getPoseTransPermuted`` output: the ``pose_transform_permuted``
    rotation block P @ R.T (``test_randomize.py:53-58``)."""
    return FAT_PERMUTATION @ rotation_from_quaternion_xyzw(q).T


def check_quaternion_consistency(obj_annotation: dict,
                                 atol: float = 1e-3) -> dict:
    """The randomization QA of ``test_randomize.py``: does the frame's
    ``quaternion_xyzw`` reproduce its ``pose_transform_permuted`` rotation?"""
    m = np.asarray(obj_annotation["pose_transform_permuted"],
                   np.float64)[:3, :3]
    from_q = permuted_matrix_from_quaternion_xyzw(
        obj_annotation["quaternion_xyzw"])
    err = float(np.abs(m - from_q).max())
    return {"max_abs_err": err, "consistent": err < atol}


def _depth_to_meters(z_raw: np.ndarray, depth_unit: str) -> np.ndarray:
    """'tenth_mm': 0.1 mm units (/10000 — power_drill scenes);
    'normalized_10m': 16-bit normalized to a 10 m range
    (``value/65535*100000/10000`` — the RoomDemo scenes,
    ``3d_reconstruct_combo.py:21-27``)."""
    z = z_raw.astype(np.float64)
    if depth_unit == "tenth_mm":
        return z / FAT_DEPTH_SCALE
    if depth_unit == "normalized_10m":
        return z / 65535.0 * 100000.0 / FAT_DEPTH_SCALE
    raise ValueError(f"unknown depth_unit {depth_unit!r}")


def backproject_fat_depth(depth: np.ndarray, mask: np.ndarray, cam: dict,
                          depth_unit: str = "tenth_mm") -> np.ndarray:
    """Masked FAT depth -> (n, 3) cloud in meters. Note the reference's
    convention: image row drives y via cy/fy, column drives x via cx/fx
    (``verify_fat.py:148-157`` get_xprime with (u, v) swapped args)."""
    vs, us = np.nonzero(mask)
    z = _depth_to_meters(depth[vs, us], depth_unit)
    x = (us - cam["cx"]) / cam["fx"] * z
    y = (vs - cam["cy"]) / cam["fy"] * z
    return np.stack([x, y, z], -1)


def backproject_full_depth(depth: np.ndarray, cam: dict,
                           depth_unit: str = "tenth_mm") -> np.ndarray:
    """Whole-image backprojection to an (H*W, 3) scene cloud — the
    reconstruction sweep of ``3d_reconstruct_combo.py:76-84``."""
    return backproject_fat_depth(depth, np.ones(depth.shape, bool), cam,
                                 depth_unit)


class FATScene:
    """One FAT scene directory (e.g. ``power_drill_with_model``,
    ``RoomDemo_*``): frames ``{idx:06d}.{side}`` with .jpg/.depth.png/.seg.png
    /.json plus the two settings files."""

    def __init__(self, scene_dir: str):
        self.dir = scene_dir
        self.objects = FATObjectSettings(scene_dir)
        self.cameras = FATCameraSettings(scene_dir)
        self.frames = sorted({
            fname.rsplit(".", 2)[0] + "." + fname.rsplit(".", 2)[1]
            for fname in os.listdir(scene_dir)
            if fname.endswith(".json") and not fname.startswith("_")
        })

    def frame(self, key: str) -> dict:
        """key like '000005.right' -> dict(rgb, depth, seg, annotation, cam)."""
        side = key.split(".")[-1]
        rgb_path = os.path.join(self.dir, key + ".jpg")
        if not os.path.exists(rgb_path):
            rgb_path = os.path.join(self.dir, key + ".png")
        return {
            "rgb": _load_image(rgb_path),
            "depth": _load_image(os.path.join(self.dir, key + ".depth.png")),
            "seg": _load_image(os.path.join(self.dir, key + ".seg.png")),
            "annotation": json.load(
                open(os.path.join(self.dir, key + ".json"))),
            "cam": self.cameras.cams[side],
        }


def reconstruct_frame(scene: FATScene, key: str,
                      model_points: np.ndarray | None = None,
                      pose_source: str = "permuted",
                      depth_unit: str = "tenth_mm",
                      out_dir: str | None = None) -> dict:
    """Whole-scene 3D reconstruction of one frame — capability parity with
    ``3d_reconstruct_combo.py``: the full depth image back-projected to a
    scene cloud, each annotated object's segmentation cloud, and (when a
    model is given) the fixed+posed model cloud. With ``out_dir``, writes the
    reference's three PLYs per object: ``target.ply`` (posed model),
    ``projected.ply`` (scene cloud), ``identity.ply`` (canonical model)
    (``3d_reconstruct_combo.py:168-171``)."""
    from densefusion_tpu_torch.data.ply import write_ply

    fr = scene.frame(key)
    decode = fat_pose if pose_source == "permuted" else fat_pose_plain
    scene_cloud = backproject_full_depth(fr["depth"], fr["cam"], depth_unit)
    out = {"scene_cloud": scene_cloud, "objects": []}
    for obj in fr["annotation"]["objects"]:
        cls = obj["class"]
        settings = scene.objects.objects.get(cls)
        if settings is None:
            continue
        mask = fr["seg"] == settings["seg_id"]
        entry = {
            "class": cls,
            "object_cloud": backproject_fat_depth(fr["depth"], mask,
                                                  fr["cam"], depth_unit),
        }
        if model_points is not None:
            R, t = decode(obj)
            fixed = model_points @ settings["fixed_rotation"].T \
                + settings["fixed_translation"]
            entry["posed_model"] = fixed @ R.T + t
        out["objects"].append(entry)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        write_ply(os.path.join(out_dir, "projected.ply"), scene_cloud)
        for k, entry in enumerate(out["objects"]):
            suffix = "" if len(out["objects"]) == 1 else f"_{k}"
            if "posed_model" in entry:
                write_ply(os.path.join(out_dir, f"target{suffix}.ply"),
                          entry["posed_model"])
        if model_points is not None:
            write_ply(os.path.join(out_dir, "identity.ply"), model_points)
    return out


def verify_frame(scene: FATScene, key: str, model_points: np.ndarray,
                 max_points: int = 2000, seed: int = 0,
                 pose_source: str = "permuted",
                 depth_unit: str = "tenth_mm",
                 check_quaternion: bool = False) -> list[dict]:
    """The FallingThings QA check: for every annotated object, transform the
    model by ``fixed_model_transform`` then the frame pose, and measure the
    mean nearest-neighbour distance to the depth-back-projected segmentation
    cloud. Small (<~1 cm) distances validate the annotation/intrinsics
    pipeline (``datasets/FallingThings/README.md:1-9``)."""
    fr = scene.frame(key)
    rng = np.random.default_rng(seed)
    decode = fat_pose if pose_source == "permuted" else fat_pose_plain
    results = []
    for obj in fr["annotation"]["objects"]:
        cls = obj["class"]
        settings = scene.objects.objects.get(cls)
        if settings is None:
            continue
        mask = fr["seg"] == settings["seg_id"]
        if mask.sum() < 10:
            results.append({"class": cls, "status": "no_mask"})
            continue
        cloud = backproject_fat_depth(fr["depth"], mask, fr["cam"],
                                      depth_unit)
        if len(cloud) > max_points:
            cloud = cloud[rng.choice(len(cloud), max_points, replace=False)]
        R, t = decode(obj)
        fixed = model_points @ settings["fixed_rotation"].T \
            + settings["fixed_translation"]
        target = fixed @ R.T + t
        if len(target) > max_points:
            target = target[rng.choice(len(target), max_points,
                                       replace=False)]
        # mean NN distance cloud -> target
        d = np.sqrt(((cloud[:, None, :] - target[None, :, :]) ** 2)
                    .sum(-1)).min(1)
        row = {
            "class": cls,
            "status": "ok",
            "mean_nn_dist_m": float(d.mean()),
            "median_nn_dist_m": float(np.median(d)),
            "n_cloud": int(len(cloud)),
        }
        if check_quaternion and "quaternion_xyzw" in obj:
            row["quaternion"] = check_quaternion_consistency(obj)
        results.append(row)
    return results


def verify_scene(scene_dir: str, model_points: np.ndarray,
                 max_frames: int | None = None,
                 pose_source: str = "permuted",
                 depth_unit: str = "tenth_mm",
                 check_quaternion: bool = False) -> list[dict]:
    scene = FATScene(scene_dir)
    out = []
    for key in scene.frames[:max_frames]:
        for r in verify_frame(scene, key, model_points,
                              pose_source=pose_source, depth_unit=depth_unit,
                              check_quaternion=check_quaternion):
            out.append({"frame": key, **r})
    return out
