"""Synthetic LineMOD-, YCB-Video-, customCAD- and FallingThings-format
scene generators (counterpart of ``densefusion_tpu/data/synthetic.py``).

A z-sorted point-splat renderer writes miniature datasets in the exact
directory layouts the readers consume (rgb/depth/mask PNGs, ``gt.yml`` and
ASCII PLY models for LineMOD; -color/-depth/-label PNGs, ``-meta.mat`` and
``points.xyz`` for YCB; Unity FrameBuffer/Depth/mask PNGs, ``proj_mat.txt``
and ``transforms.txt`` for customCAD; settings JSONs and per-frame
jpg / depth / seg / json for FallingThings), with exact ground truth, so
tests, benchmarks and examples need no download. One seed gives the same
files as the JAX package's generators.
"""

from __future__ import annotations

import os

import numpy as np

from densefusion_tpu_torch.geometry.camera import LINEMOD_CAM, YCB_CAM_1
from densefusion_tpu_torch.geometry.quaternion import unit_quat_matrix_np
from densefusion_tpu_torch.data.ply import write_ply


def make_asymmetric_model(n_points: int = 4000, scale_mm: float = 50.0,
                          seed: int = 0) -> np.ndarray:
    """Blob of points on a box surface with an off-center bump — deliberately
    asymmetric so ADD is a meaningful metric. Units mm, centered."""
    rng = np.random.default_rng(seed)
    # box faces
    n_box = n_points * 3 // 4
    face = rng.integers(0, 6, n_box)
    uv = rng.uniform(-1, 1, (n_box, 2))
    half = np.array([0.6, 1.0, 0.4])
    pts = np.zeros((n_box, 3))
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        others = [a for a in range(3) if a != axis]
        pts[m, axis] = sign * half[axis]
        pts[m, others[0]] = uv[m, 0] * half[others[0]]
        pts[m, others[1]] = uv[m, 1] * half[others[1]]
    # bump sphere at a corner (breaks symmetry)
    n_bump = n_points - n_box
    d = rng.standard_normal((n_bump, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bump = d * 0.35 + np.array([0.5, 0.8, 0.3])
    return (np.concatenate([pts, bump]) * scale_mm).astype(np.float32)


def make_symmetric_model(n_points: int = 4000, scale_mm: float = 50.0,
                         seed: int = 0) -> np.ndarray:
    """Rotationally symmetric model (surface of revolution around z, a bumpy
    vase profile): any rotation about z is in the symmetry orbit, so ADD is
    ill-defined and ADD-S is the right metric — matching the role of the YCB
    symmetric classes the sym_list marks (``datasets/ycb/dataset.py:89``).
    Units mm, centered."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 1.0, n_points)
    theta = rng.uniform(0.0, 2.0 * np.pi, n_points)
    c = rng.uniform(-0.2, 0.2, 3)
    r = (0.65 + c[0] * np.cos(np.pi * z) + c[1] * np.cos(2 * np.pi * z)
         + c[2] * np.sin(np.pi * z))
    r = np.clip(r, 0.25, 1.0)
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)
    return (pts * scale_mm).astype(np.float32)


def _splat_render(points_cam_mm: np.ndarray, colors: np.ndarray,
                  img_h: int, img_w: int, cam, splat: int = 2):
    """Z-buffered point splatting -> (rgb uint8, depth_mm uint16, mask bool)."""
    z = points_cam_mm[:, 2]
    valid = z > 1.0
    pts = points_cam_mm[valid]
    cols = colors[valid]
    u = np.round(pts[:, 0] / pts[:, 2] * cam.fx + cam.cx).astype(np.int64)
    v = np.round(pts[:, 1] / pts[:, 2] * cam.fy + cam.cy).astype(np.int64)
    depth = np.zeros((img_h, img_w), np.float64)
    rgb = np.full((img_h, img_w, 3), 110, np.uint8)
    zbuf = np.full((img_h, img_w), np.inf)
    order = np.argsort(-pts[:, 2])  # far to near; near overwrites in-pass
    z_sorted = pts[order][:, 2]
    cols_sorted = cols[order]
    for du in range(-splat, splat + 1):
        for dv in range(-splat, splat + 1):
            uu = u[order] + du
            vv = v[order] + dv
            ok = (uu >= 0) & (uu < img_w) & (vv >= 0) & (vv < img_h)
            uo, vo, zo, co = uu[ok], vv[ok], z_sorted[ok], cols_sorted[ok]
            # z-test against earlier passes; within a pass the far->near
            # write order leaves the nearest duplicate standing
            keep = zo <= zbuf[vo, uo]
            uo, vo, zo, co = uo[keep], vo[keep], zo[keep], co[keep]
            zbuf[vo, uo] = zo
            rgb[vo, uo] = co
            depth[vo, uo] = zo
    mask = depth > 0
    return rgb, np.round(depth).astype(np.uint16), mask


def object_colorway(model_mm: np.ndarray, obj_seed: int) -> np.ndarray:
    """Per-object surface coloring: the position ramp pushed through an
    object-specific color basis (base albedo, per-channel gain, axis
    permutation, per-channel ramp direction).

    Real datasets' objects differ in albedo, and a segmenter learns class
    identity largely from it: one ramp shared by every object renders
    near-identical blobs. The ramp itself stays, since position-correlated
    shading is the orientation signal the pose CNN trains on."""
    pmin, pmax = model_mm.min(0), model_mm.max(0)
    ramp = (model_mm - pmin) / np.maximum(pmax - pmin, 1e-6)
    rng = np.random.default_rng((0xC0104, obj_seed))
    base = rng.uniform(25, 115, 3)
    gain = rng.uniform(70, 185, 3)
    direction = rng.integers(0, 2, 3).astype(np.float64)  # per-channel flip
    r = direction + (1.0 - 2.0 * direction) * ramp[:, rng.permutation(3)]
    return np.clip(base + gain * r, 0, 255).astype(np.uint8)


def _random_background(rng, img_h, img_w):
    """Smooth random gradient + noise background so models cannot key on a
    constant backdrop (domain-randomization-lite)."""
    corners = rng.uniform(40, 200, (2, 2, 3))
    ys = np.linspace(0, 1, img_h)[:, None, None]
    xs = np.linspace(0, 1, img_w)[None, :, None]
    top = corners[0, 0] * (1 - xs) + corners[0, 1] * xs
    bot = corners[1, 0] * (1 - xs) + corners[1, 1] * xs
    bg = top * (1 - ys) + bot * ys
    bg = bg + rng.normal(0, 6.0, bg.shape)
    return np.clip(bg, 0, 255).astype(np.uint8)


def generate_linemod_style_dataset(
    root: str, objlist=(1,), n_train: int = 8, n_test: int = 20,
    n_model_points: int = 4000, img_h: int = 480, img_w: int = 640,
    seed: int = 0, realism: bool = False,
) -> None:
    """Write a miniature Linemod_preprocessed tree under ``root``.

    Note the reader subsamples test lists 1/10, so ``n_test=20`` yields 2
    usable eval frames. Ground truth is exact (no mask/pose noise), making
    metric expectations sharp in tests.

    ``realism=True`` adds domain randomization (random gradient backgrounds,
    per-frame illumination scaling, a distractor blob) so training runs can
    generalize to held-out views rather than memorizing the backdrop.
    """
    import yaml
    rng = np.random.default_rng(seed)
    cam = LINEMOD_CAM
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    models_info = {}
    distractor_mm = make_asymmetric_model(1500, scale_mm=45.0, seed=seed + 777)

    for obj in objlist:
        model_mm = make_asymmetric_model(n_model_points, seed=seed + obj)
        write_ply(os.path.join(root, "models", f"obj_{obj:02d}.ply"), model_mm)
        diam = float(np.linalg.norm(
            model_mm.max(axis=0) - model_mm.min(axis=0)))
        models_info[obj] = {"diameter": diam}

        base = os.path.join(root, "data", f"{obj:02d}")
        for sub in ("rgb", "depth", "mask"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        seg_dir = os.path.join(root, "segnet_results", f"{obj:02d}_label")
        os.makedirs(seg_dir, exist_ok=True)

        # position-based coloring (orientation signal) through a distinct
        # per-object colorway (class signal — see object_colorway)
        colors = object_colorway(model_mm, obj)
        if realism:
            # stable procedural surface texture (same across frames — it is
            # the OBJECT's texture): high-frequency sinusoid bands give the
            # CNN orientation-discriminative detail beyond the color ramp
            tex_freq = rng.standard_normal((3, 3)) * 0.35  # cycles/mm
            tex_phase = rng.uniform(0, 2 * np.pi, 3)
            tex = 28.0 * np.sin(model_mm @ tex_freq + tex_phase)
            colors = np.clip(colors.astype(np.float64) + tex, 0,
                             255).astype(np.uint8)

        gt = {}
        n_frames = n_train + n_test
        from PIL import Image
        for frame in range(n_frames):
            # random pose, object kept in view
            q = rng.standard_normal(4)
            q /= np.linalg.norm(q)
            R = unit_quat_matrix_np(*q)
            t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                          rng.uniform(600, 900)])
            pts_cam = model_mm @ R.T + t
            frame_colors = colors
            if realism:
                # per-frame illumination scale + slight color cast
                illum = rng.uniform(0.6, 1.3) * rng.uniform(0.85, 1.15, 3)
                frame_colors = np.clip(colors * illum, 0, 255).astype(np.uint8)
                # sensor-dropout holes (the reference CAD generator's KD-tree
                # radius deletion, cad_to_dataset.py:137-164, scaled to the
                # ~50 mm object)
                keep = delete_point_holes(pts_cam / 1000.0, rng,
                                          max_holes=3,
                                          hole_size_mean=0.008,
                                          hole_size_std=0.003)
                pts_cam = pts_cam[keep]
                frame_colors = frame_colors[keep]
            rgb, depth, mask = _splat_render(pts_cam, frame_colors, img_h,
                                             img_w, cam)
            if realism:
                # composite over a random background; drop in a distractor
                # object near the target (never occluding its mask pixels)
                bg = _random_background(rng, img_h, img_w)
                rgb = np.where(mask[..., None], rgb, bg)
                qd = rng.standard_normal(4)
                qd /= np.linalg.norm(qd)
                Rd = unit_quat_matrix_np(*qd)
                td = t + np.array([rng.uniform(120, 220) * rng.choice([-1, 1]),
                                   rng.uniform(-60, 60),
                                   rng.uniform(50, 150)])
                d_pts = distractor_mm @ Rd.T + td
                d_cols = np.full((len(d_pts), 3),
                                 rng.integers(60, 200, 3), np.uint8)
                d_rgb, d_depth, d_mask = _splat_render(d_pts, d_cols, img_h,
                                                       img_w, cam)
                paint = d_mask & ~mask  # behind-target never steals pixels
                rgb[paint] = d_rgb[paint]
                depth = np.where(paint, d_depth, depth)

                # partial FRONT occluder (<=35% of the object's pixels):
                # the visible mask shrinks, like the reference's front-paste
                # occlusion augmentation (datasets/ycb/dataset.py:116-137).
                # TRAIN frames only — the LineMOD test protocol this mimics
                # is unoccluded (occlusion eval is a separate benchmark), so
                # occluding held-out frames would overstate difficulty
                if frame < n_train and rng.uniform() < 0.5:
                    qo = rng.standard_normal(4)
                    qo /= np.linalg.norm(qo)
                    Ro = unit_quat_matrix_np(*qo)
                    t_o = t + np.array([
                        rng.uniform(25, 60) * rng.choice([-1, 1]),
                        rng.uniform(-25, 25), -rng.uniform(120, 220)])
                    o_pts = distractor_mm * 0.6 @ Ro.T + t_o
                    o_cols = np.full((len(o_pts), 3),
                                     rng.integers(50, 210, 3), np.uint8)
                    o_rgb, o_depth, o_mask = _splat_render(
                        o_pts, o_cols, img_h, img_w, cam)
                    hidden = o_mask & mask
                    if 0 < hidden.sum() <= 0.35 * mask.sum():
                        rgb[o_mask] = o_rgb[o_mask]
                        depth = np.where(o_mask, o_depth, depth)
                        mask = mask & ~o_mask

            Image.fromarray(rgb).save(
                os.path.join(base, "rgb", f"{frame:04d}.png"))
            Image.fromarray(depth).save(
                os.path.join(base, "depth", f"{frame:04d}.png"))
            mask_img = (mask * 255).astype(np.uint8)
            mask_rgb = np.repeat(mask_img[..., None], 3, axis=-1)
            Image.fromarray(mask_rgb).save(
                os.path.join(base, "mask", f"{frame:04d}.png"))
            Image.fromarray(mask_img).save(
                os.path.join(seg_dir, f"{frame:04d}_label.png"))

            vs, us = np.where(mask)
            gt[frame] = [{
                "cam_R_m2c": [float(x) for x in R.reshape(-1)],
                "cam_t_m2c": [float(x) for x in t],
                "obj_bb": [int(us.min()), int(vs.min()),
                           int(us.max() - us.min() + 1),
                           int(vs.max() - vs.min() + 1)],
                "obj_id": int(obj),
            }]

        with open(os.path.join(base, "gt.yml"), "w") as f:
            yaml.safe_dump(gt, f)
        with open(os.path.join(base, "train.txt"), "w") as f:
            f.write("\n".join(f"{i:04d}" for i in range(n_train)) + "\n")
        with open(os.path.join(base, "test.txt"), "w") as f:
            f.write("\n".join(f"{i:04d}"
                              for i in range(n_train, n_frames)) + "\n")

    with open(os.path.join(root, "models", "models_info.yml"), "w") as f:
        yaml.safe_dump(models_info, f)


def generate_ycb_style_dataset(root: str, n_classes: int = 3,
                               n_real: int = 4, n_syn: int = 2,
                               n_test: int = 3, img_h: int = 480,
                               img_w: int = 640, seed: int = 0,
                               posecnn_dir: str | None = None,
                               objs_per_frame: int = 2) -> None:
    """Write a miniature YCB-Video-format tree (multi-object frames with
    -color/-depth/-label PNGs and -meta.mat, models/points.xyz,
    dataset_config lists) that :class:`YCBDataset`, :class:`SegDataset`, and
    — when ``posecnn_dir`` is given (fake PoseCNN labels+rois .mat per test
    keyframe) — :class:`YCBPoseCNNEvalDataset` consume."""
    import scipy.io as scio
    from PIL import Image
    from densefusion_tpu_torch.data.ycb import YCB_SYM

    cam = YCB_CAM_1
    rng = np.random.default_rng(seed)
    cfg_dir = os.path.join(root, "dataset_config")
    os.makedirs(cfg_dir, exist_ok=True)

    classes = [f"{i:03d}_synth_obj" for i in range(1, n_classes + 1)]
    models_mm = {}
    for cid, cls in enumerate(classes, start=1):
        os.makedirs(os.path.join(root, "models", cls), exist_ok=True)
        # classes on the YCB sym_list get genuinely rotation-symmetric
        # geometry so the ADD-S branch trains/scores on real symmetry orbits
        if (cid - 1) in YCB_SYM:
            m = make_symmetric_model(2500, scale_mm=55.0, seed=seed + cid)
        else:
            m = make_asymmetric_model(2500, scale_mm=55.0, seed=seed + cid)
        models_mm[cid] = m
        np.savetxt(os.path.join(root, "models", cls, "points.xyz"),
                   m / 1000.0, fmt="%.6f")  # meters, like YCB points.xyz
    with open(os.path.join(cfg_dir, "classes.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")

    factor_depth = 10000.0

    def render_frame(path_prefix, frame_classes):
        """Render several objects into one frame; z-order by splatting far
        objects first. Returns per-class poses."""
        rgb = np.full((img_h, img_w, 3), 110, np.uint8)
        depth = np.zeros((img_h, img_w), np.float64)
        label = np.zeros((img_h, img_w), np.uint8)
        poses = {}
        order = sorted(frame_classes,
                       key=lambda _: -rng.uniform())  # random z assignment
        for cid in order:
            q = rng.standard_normal(4)
            q /= np.linalg.norm(q)
            R = unit_quat_matrix_np(*q)
            t = np.array([rng.uniform(-0.12, 0.12), rng.uniform(-0.08, 0.08),
                          rng.uniform(0.7, 1.1)]) * 1000.0  # mm
            pts_cam = models_mm[cid] @ R.T + t
            m = models_mm[cid]
            colors = object_colorway(m, cid)
            r_img, d_img, mask = _splat_render(pts_cam, colors, img_h, img_w,
                                               cam, splat=2)
            # composite nearer-than-existing pixels
            nearer = mask & ((depth == 0) | (d_img < depth))
            rgb[nearer] = r_img[nearer]
            depth[nearer] = d_img[nearer]
            label[nearer] = cid
            poses[cid] = (R, t / 1000.0)

        Image.fromarray(rgb).save(path_prefix + "-color.png")
        depth_png = np.round(depth / 1000.0 * factor_depth).astype(np.uint16)
        Image.fromarray(depth_png).save(path_prefix + "-depth.png")
        Image.fromarray(label).save(path_prefix + "-label.png")
        cls_ids = sorted(poses)
        pose_arr = np.zeros((3, 4, len(cls_ids)))
        for k, cid in enumerate(cls_ids):
            R, t_m = poses[cid]
            pose_arr[:, :3, k] = R
            pose_arr[:, 3, k] = t_m
        scio.savemat(path_prefix + "-meta.mat", {
            "cls_indexes": np.array(cls_ids).reshape(-1, 1),
            "poses": pose_arr,
            "factor_depth": np.array([[factor_depth]]),
        })
        return poses

    train_list, test_list = [], []
    os.makedirs(os.path.join(root, "data", "0000"), exist_ok=True)
    os.makedirs(os.path.join(root, "data_syn"), exist_ok=True)
    # real YCB keyframes carry ~3-6 gt objects each; objs_per_frame sizes
    # the synthetic scenes (and the per-keyframe gt-object count the eval
    # protocol scores)
    n_pick = min(objs_per_frame, n_classes)
    for i in range(n_real + n_test):
        name = f"data/0000/{i + 1:06d}"
        picks = list(rng.choice(np.arange(1, n_classes + 1),
                                size=n_pick, replace=False))
        render_frame(os.path.join(root, name), picks)
        (train_list if i < n_real else test_list).append(name)
    for i in range(n_syn):
        name = f"data_syn/{i + 1:06d}"
        picks = list(rng.choice(np.arange(1, n_classes + 1),
                                size=n_pick, replace=False))
        render_frame(os.path.join(root, name), picks)
        train_list.append(name)

    with open(os.path.join(cfg_dir, "train_data_list.txt"), "w") as f:
        f.write("\n".join(train_list) + "\n")
    with open(os.path.join(cfg_dir, "test_data_list.txt"), "w") as f:
        f.write("\n".join(test_list) + "\n")

    if posecnn_dir is not None:
        # fake PoseCNN results: gt labels as predicted labels, tight rois
        os.makedirs(posecnn_dir, exist_ok=True)
        for frame_idx, name in enumerate(test_list):
            label = np.array(Image.open(
                os.path.join(root, name) + "-label.png"))
            rois = []
            for cid in np.unique(label):
                if cid == 0:
                    continue
                vs, us = np.where(label == cid)
                #  roi layout: [_, itemid, cmin, rmin, cmax, rmax]
                rois.append([0, cid, us.min() - 1, vs.min() - 1,
                             us.max() + 1, vs.max() + 1])
            scio.savemat(os.path.join(posecnn_dir, f"{frame_idx:06d}.mat"),
                         {"labels": label.astype(np.float64),
                          "rois": np.asarray(rois, np.float64)})


def delete_point_holes(points_m: np.ndarray, rng: np.random.Generator,
                       max_holes: int = 3, hole_size_mean: float = 0.03,
                       hole_size_std: float = 0.01) -> np.ndarray:
    """Sensor-dropout simulation: delete up to ``max_holes`` random radius
    neighborhoods from a cloud — the KD-tree hole augmentation of the
    reference's CAD data generator (``cad_to_dataset.py:137-164``).
    points_m in meters; returns a boolean KEEP mask over the points."""
    from scipy.spatial import cKDTree
    keep = np.ones(len(points_m), bool)
    n_holes = int(rng.integers(max_holes))  # np.random.randint(max_holes)
    if n_holes == 0:
        return keep
    tree = cKDTree(points_m)
    for _ in range(n_holes):
        center = points_m[int(rng.integers(len(points_m)))]
        radius = max(0.0, float(rng.normal(hole_size_mean, hole_size_std)))
        idx = tree.query_ball_point(center, radius)
        keep[idx] = False
    if not keep.any():
        keep[:] = True  # degenerate: everything deleted — skip augmentation
    return keep


def generate_cad_style_dataset(root: str, n_train: int = 6, n_test: int = 20,
                               img_h: int = 260, img_w: int = 554,
                               seed: int = 0, obj: int = 1,
                               hole_augment: bool = False) -> None:
    """Write a miniature customCAD (Unity-render) dataset tree that
    :class:`densefusion_tpu_torch.data.cad.CADDataset` consumes — the role of the
    reference's CAD generation pipeline (``datasets/customCAD/
    cad_to_dataset.py`` + ``mask_generator.py`` + ``train_test_generator.py``)
    with exact ground truth.

    Encodes the Unity conventions the reader decodes: GL-style projection
    matrix (``proj_mat.txt``), non-linear reversed z-buffer 16-bit depth in
    0.1 mm world units, 65535-valued masks, left-handed quaternions and the
    y-180 fixup in ``transforms.txt`` (see data/cad.py).
    """
    from PIL import Image
    from densefusion_tpu_torch.data.cad import _Y_180

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "data", f"{obj:02d}")
    for sub in ("rgb", "depth", "mask", "meta"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "models"), exist_ok=True)

    model_mm = make_asymmetric_model(3000, scale_mm=60.0, seed=seed)
    write_ply(os.path.join(root, "models", f"obj_{obj:02d}.ply"), model_mm)
    model_units = model_mm * 10.0  # reader multiplies ply by 10 (0.1mm units)

    # GL-style projection in 0.1 mm units; linearize(d) = -P23/(P22 + d)
    # maps d in [0, 1] onto [near, far].
    near, far = 1000.0, 30000.0  # 0.1 m .. 3 m
    c = far / (near - far)
    d = -near * far / (near - far)
    fx_px, fy_px = 500.0, 500.0
    proj = np.zeros((4, 4))
    proj[0, 0] = 2.0 * fx_px / img_w
    proj[1, 1] = -2.0 * fy_px / img_h
    proj[2, 2] = c
    proj[2, 3] = d
    proj[3, 2] = 1.0
    with open(os.path.join(base, "meta", "proj_mat.txt"), "w") as f:
        for row in proj:
            f.write("\t".join(f"{v:.9f}" for v in row) + "\n")

    class _Cam:
        fx, fy, cx, cy = fx_px, fy_px, img_w / 2.0, img_h / 2.0

    pmin, pmax = model_mm.min(0), model_mm.max(0)
    colors = (40 + 210 * (model_mm - pmin) / (pmax - pmin)).astype(np.uint8)

    n_frames = n_train + n_test
    transforms_lines = []
    for frame in range(n_frames):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = unit_quat_matrix_np(*q)
        t_m = np.array([rng.uniform(-0.04, 0.04), rng.uniform(-0.03, 0.03),
                        rng.uniform(0.6, 1.0)])
        t_units = t_m * 10000.0
        posed = model_units @ R.T + t_units  # camera frame, 0.1 mm units

        frame_colors = colors
        if hole_augment:  # sensor-dropout holes (cad_to_dataset.py:137-164)
            keep = delete_point_holes(posed / 10000.0, rng)
            posed = posed[keep]
            frame_colors = colors[keep]
        rgb, depth_units, mask = _splat_render(posed, frame_colors, img_h,
                                               img_w, _Cam, splat=2)
        # encode reversed non-linear z: dval = -d/z - c, png = (1-dval)*65534
        z = depth_units.astype(np.float64)
        dval = np.where(mask, -d / np.maximum(z, 1.0) - c, 0.0)
        png = np.where(mask, np.round((1.0 - dval) * 65534.0), 65535.0)
        depth_png = np.clip(png, 0, 65535).astype(np.uint16)
        mask_png = np.where(mask, 65535, 0).astype(np.uint16)

        # transforms.txt: left-handed quat + pos with z negated; the reader
        # computes R_gt = R_rh(convert(q)) @ y_180, t = pos*1000 (z flipped)
        M = R @ _Y_180
        # matrix -> quat (w, x, y, z)
        tr = np.trace(M)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            qw = 0.25 * s
            qx = (M[2, 1] - M[1, 2]) / s
            qy = (M[0, 2] - M[2, 0]) / s
            qz = (M[1, 0] - M[0, 1]) / s
        else:
            i = int(np.argmax(np.diag(M)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(1.0 + M[i, i] - M[j, j] - M[k, k]) * 2
            qv = [0.0, 0.0, 0.0]
            qv[i] = 0.25 * s
            qv[j] = (M[j, i] + M[i, j]) / s
            qv[k] = (M[k, i] + M[i, k]) / s
            qw = (M[k, j] - M[j, k]) / s
            qx, qy, qz = qv
        # reader negates x and y (left->right hand); pre-negate to cancel
        q_file = (-qx, -qy, qz, qw)
        pos = (t_units[0] / 1000.0, t_units[1] / 1000.0,
               -t_units[2] / 1000.0)

        Image.fromarray(rgb).save(
            os.path.join(base, "rgb", f"FrameBuffer_{frame:04d}.png"))
        Image.fromarray(depth_png).save(
            os.path.join(base, "depth", f"Depth_{frame:04d}.png"))
        Image.fromarray(mask_png).save(
            os.path.join(base, "mask", f"{frame:04d}.png"))
        # transforms indices are 1-off from image indices (dataset.py:117)
        transforms_lines += [
            f"{frame + 1}",
            f"({pos[0]:.6f}, {pos[1]:.6f}, {pos[2]:.6f})",
            f"({q_file[0]:.6f}, {q_file[1]:.6f}, {q_file[2]:.6f}, "
            f"{q_file[3]:.6f})",
        ]

    with open(os.path.join(base, "meta", "transforms.txt"), "w") as f:
        f.write("\n".join(transforms_lines) + "\n")
    with open(os.path.join(base, "train.txt"), "w") as f:
        f.write("\n".join(str(i) for i in range(n_train)) + "\n")
    with open(os.path.join(base, "test.txt"), "w") as f:
        f.write("\n".join(str(i)
                          for i in range(n_train, n_frames)) + "\n")


def generate_fat_style_scene(scene_dir: str, n_frames: int = 2,
                             img_h: int = 270, img_w: int = 480,
                             seed: int = 0) -> np.ndarray:
    """Write a miniature FallingThings-format scene (settings JSONs + per-frame
    jpg/depth/seg/json) with exact ground truth; returns the model points
    (meters) for :func:`densefusion_tpu_torch.data.fat.verify_scene`.

    Encodes the FAT conventions the reader decodes: transposed 4x4s with
    translation in the last row, centimeter x100 scale, the pose axis
    permutation, and 0.1 mm depth units (see data/fat.py docstring).
    """
    import json
    from PIL import Image
    from densefusion_tpu_torch.data.fat import (
        FAT_PERMUTATION, FAT_DEPTH_SCALE, FAT_CM,
    )

    rng = np.random.default_rng(seed)
    os.makedirs(scene_dir, exist_ok=True)
    model_m = make_asymmetric_model(3000, scale_mm=60.0, seed=seed) / 1000.0

    # fixed model transform (a small canonicalization rotation + offset)
    qf = rng.standard_normal(4)
    qf /= np.linalg.norm(qf)
    wf, xf, yf, zf = qf
    Rf = np.array([
        [1 - 2 * (yf * yf + zf * zf), 2 * (xf * yf - wf * zf),
         2 * (wf * yf + xf * zf)],
        [2 * (xf * yf + wf * zf), 1 - 2 * (xf * xf + zf * zf),
         2 * (yf * zf - wf * xf)],
        [2 * (xf * zf - wf * yf), 2 * (wf * xf + yf * zf),
         1 - 2 * (xf * xf + yf * yf)]])
    tf = rng.uniform(-0.02, 0.02, 3)
    fixed_m = np.zeros((4, 4))
    fixed_m[:3, :3] = (Rf * FAT_CM).T
    fixed_m[3, :3] = tf * FAT_CM
    fixed_m[3, 3] = 1.0

    seg_id = 255
    cam = dict(fx=500.0, fy=500.0, cx=img_w / 2.0, cy=img_h / 2.0)
    with open(os.path.join(scene_dir, "_object_settings.json"), "w") as f:
        json.dump({
            "exported_object_classes": ["synth_obj"],
            "exported_objects": [{
                "class": "synth_obj",
                "segmentation_class_id": seg_id,
                "fixed_model_transform": fixed_m.tolist(),
                "cuboid_dimensions": [10.0, 10.0, 10.0],
            }],
        }, f)
    cam_settings = {
        "camera_settings": [
            {"name": side, "horizontal_fov": 64,
             "intrinsic_settings": {**cam, "s": 0},
             "captured_image_size": {"width": img_w, "height": img_h}}
            for side in ("left", "right")
        ]
    }
    with open(os.path.join(scene_dir, "_camera_settings.json"), "w") as f:
        json.dump(cam_settings, f)

    class _Cam:
        fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]

    for frame in range(n_frames):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w_, x_, y_, z_ = q
        R = np.array([
            [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_),
             2 * (w_ * y_ + x_ * z_)],
            [2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_),
             2 * (y_ * z_ - w_ * x_)],
            [2 * (x_ * z_ - w_ * y_), 2 * (w_ * x_ + y_ * z_),
             2 * 0 + 1 - 2 * (x_ * x_ + y_ * y_)]])
        t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                      rng.uniform(0.6, 0.9)])
        posed = (model_m @ Rf.T + tf) @ R.T + t  # meters, camera frame

        colors = np.full((len(posed), 3), 180, np.uint8)
        rgb, depth_raw, mask = _splat_render(
            posed * 1000.0, colors, img_h, img_w, _Cam, splat=2)
        depth_png = np.round(
            depth_raw.astype(np.float64) / 1000.0 * FAT_DEPTH_SCALE
        ).astype(np.uint16)
        seg = np.where(mask, seg_id, 0).astype(np.uint8)

        pose_m = np.zeros((4, 4))
        pose_m[:3, :3] = FAT_PERMUTATION @ R.T
        pose_m[3, :3] = t * FAT_CM
        pose_m[3, 3] = 1.0
        ann = {"objects": [{
            "class": "synth_obj",
            "pose_transform_permuted": pose_m.tolist(),
            # plain-pose convention of the randomized scenes: same matrix
            # recipe under test_randomize.py's decode, translation carried
            # in 'location' (cm)
            "pose_transform": pose_m.tolist(),
            "location": (t * FAT_CM).tolist(),
            "quaternion_xyzw": [x_, y_, z_, w_],
            "bounding_box": {"top_left": [0, 0],
                             "bottom_right": [img_h, img_w]},
        }]}
        key = f"{frame:06d}.left"
        Image.fromarray(rgb).save(os.path.join(scene_dir, key + ".jpg"))
        Image.fromarray(depth_png).save(
            os.path.join(scene_dir, key + ".depth.png"))
        Image.fromarray(seg).save(os.path.join(scene_dir, key + ".seg.png"))
        with open(os.path.join(scene_dir, key + ".json"), "w") as f:
            json.dump(ann, f)
    return model_m
