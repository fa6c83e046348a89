"""Toolbox-exact YCB keyframe scoring and accuracy plots (counterpart of
``densefusion_tpu/eval/ycb_toolbox.py``).

In-repo Python replacement for the MATLAB evaluation the reference drops into
the external YCB_Video_toolbox (``replace_ycb_toolbox/evaluate_poses_keyframe.m``
and ``plot_accuracy_keyframe.m``), with the exact protocol:

* iterate the frame's **ground-truth objects** (``gt.cls_indexes``,
  ``evaluate_poses_keyframe.m:64``), not the detections;
* for each gt object look up the detection of the same class in the PoseCNN
  rois (``:75``); a missing detection scores ``inf`` in every metric
  (``:111-116``); detections whose class has no gt (false positives) are
  never scored;
* ADD uses corresponding points (``:160-174``); ADD-S uses the ``adi``
  direction — a KD-tree of the **estimated** points queried with the **gt**
  points (``:176-193``); both use the FULL model cloud (``points.xyz``);
* rotation error ``re`` = arccos((trace(R_est·R_gt⁻¹) − 1)/2) in degrees
  (``:195-207``); translation error ``te`` = ‖t_gt − t_est‖ (``:209-217``);
* accuracy curves count every gt object in the denominator — distances above
  0.1 m become ``inf`` and stay in ``n`` (``plot_accuracy_keyframe.m:42-46``),
  so misses drag the AUC down exactly as in the toolbox.

Scoring is host-side float64 numpy/scipy (offline post-processing of
``.mat`` pose results, like the MATLAB stage), so it gives the JAX
package's table exactly; the on-device tensor metrics live in
``eval/metrics.py``. ``matplotlib`` is imported only by
:func:`plot_accuracy`.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from densefusion_tpu_torch.eval.metrics import vocap_auc
from densefusion_tpu_torch.geometry.quaternion import unit_quat_matrix_np


# ---------------------------------------------------------------------------
# Pose-error primitives (evaluate_poses_keyframe.m:148-217)
# ---------------------------------------------------------------------------

def add_error(R_est: np.ndarray, t_est: np.ndarray, R_gt: np.ndarray,
              t_gt: np.ndarray, points: np.ndarray) -> float:
    """ADD (Hinterstoisser ACCV'12): mean distance between corresponding
    transformed model points (``evaluate_poses_keyframe.m:160-174``)."""
    pred = points @ R_est.T + t_est
    gt = points @ R_gt.T + t_gt
    return float(np.linalg.norm(pred - gt, axis=-1).mean())


def adi_error(R_est: np.ndarray, t_est: np.ndarray, R_gt: np.ndarray,
              t_gt: np.ndarray, points: np.ndarray) -> float:
    """ADD-S, toolbox direction: mean distance from each **gt** point to its
    nearest **estimated** point — KD-tree of pts_est queried with pts_gt
    (``evaluate_poses_keyframe.m:176-193``). Note this is the reverse of the
    LineMOD/CUDA-KNN direction (``tools/eval_linemod.py:123-128``)."""
    from scipy.spatial import cKDTree
    pred = points @ R_est.T + t_est
    gt = points @ R_gt.T + t_gt
    d, _ = cKDTree(pred).query(gt, k=1)
    return float(d.mean())


def rotation_error_deg(R_est: np.ndarray, R_gt: np.ndarray) -> float:
    """Angular error in degrees (``evaluate_poses_keyframe.m:195-207``)."""
    cos = 0.5 * (np.trace(R_est @ np.linalg.inv(R_gt)) - 1.0)
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def translation_error(t_est: np.ndarray, t_gt: np.ndarray) -> float:
    """‖t_gt − t_est‖ (``evaluate_poses_keyframe.m:209-217``)."""
    return float(np.linalg.norm(np.asarray(t_gt) - np.asarray(t_est)))


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation (MATLAB ``quat2rotm`` convention)."""
    return unit_quat_matrix_np(*(np.asarray(q, np.float64)
                                 / np.linalg.norm(q)))


# ---------------------------------------------------------------------------
# Keyframe scoring (evaluate_poses_keyframe.m main loop)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KeyframeResults:
    """Row-per-gt-object score table, one column per method — the in-memory
    form of ``results_keyframe.mat`` (``evaluate_poses_keyframe.m:145-146``)."""
    methods: list[str]
    distances_sys: np.ndarray        # (count, n_methods) adi
    distances_non: np.ndarray        # (count, n_methods) add
    errors_rotation: np.ndarray      # (count, n_methods) degrees
    errors_translation: np.ndarray   # (count, n_methods) meters
    cls_ids: np.ndarray              # (count,) 1-based class index
    frame_ids: np.ndarray            # (count,) keyframe index

    def save_mat(self, path: str) -> None:
        save_mat_atomic(path, {
            "distances_sys": self.distances_sys,
            "distances_non": self.distances_non,
            "errors_rotation": self.errors_rotation,
            "errors_translation": self.errors_translation,
            "results_cls_id": self.cls_ids.astype(np.float64),
            "results_frame_id": self.frame_ids.astype(np.float64),
        })


def write_atomic(path: str, write) -> None:
    """Call ``write(f)`` on a binary file object that never leaves a partial
    file at ``path``: it is a temporary name in the same directory, renamed
    over ``path`` once ``write`` returns. A write cut short leaves no
    ``path`` (and no temporary file when it fails by raising)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_mat_atomic(path: str, mdict: dict) -> None:
    """``scipy.io.savemat`` through :func:`write_atomic`."""
    import scipy.io as scio
    write_atomic(path, lambda f: scio.savemat(f, mdict))


def load_models(dataset_root: str, config_dir: str | None = None,
                ) -> tuple[list[str], dict[int, np.ndarray]]:
    """Class names + FULL model point clouds (``points.xyz``), keyed by
    1-based class id (``evaluate_poses_keyframe.m:12-18``)."""
    cfg = config_dir or os.path.join(dataset_root, "dataset_config")
    with open(os.path.join(cfg, "classes.txt")) as f:
        classes = [ln.strip() for ln in f if ln.strip()]
    models = {}
    for cid, cls in enumerate(classes, start=1):
        models[cid] = np.loadtxt(
            os.path.join(dataset_root, "models", cls, "points.xyz"),
            dtype=np.float64)
    return classes, models


def score_keyframes(dataset_root: str, posecnn_dir: str,
                    result_dirs: dict[str, str],
                    num_keyframes: int | None = None,
                    config_dir: str | None = None,
                    models: tuple | None = None) -> KeyframeResults:
    """Score per-frame ``.mat`` pose results against gt, toolbox-exactly.

    ``result_dirs`` maps method name -> directory of ``%04d.mat`` files whose
    ``poses`` array is (n_rois, 7) [wxyz quat, xyz trans] in PoseCNN-roi order
    (the format both ``tools/eval_ycb.py:239-240`` and our ``cli.eval_ycb``
    write). ``models`` is :func:`load_models`' result where the caller has
    it already. Mirrors ``evaluate_poses_keyframe.m:36-146``.
    """
    import scipy.io as scio

    cfg = config_dir or os.path.join(dataset_root, "dataset_config")
    classes, models = models or load_models(dataset_root, config_dir)
    with open(os.path.join(cfg, "test_data_list.txt")) as f:
        frames = [ln.strip() for ln in f if ln.strip()]
    if num_keyframes is not None:
        frames = frames[:num_keyframes]

    methods = list(result_dirs)
    rows_sys, rows_non, rows_rot, rows_trans = [], [], [], []
    cls_ids, frame_ids = [], []

    for frame_idx, frame in enumerate(frames):
        meta = scio.loadmat(os.path.join(dataset_root, frame + "-meta.mat"))
        posecnn = scio.loadmat(
            os.path.join(posecnn_dir, f"{frame_idx:06d}.mat"))
        rois = np.atleast_2d(np.asarray(posecnn["rois"], np.float64))
        results = [
            np.atleast_2d(np.asarray(scio.loadmat(
                os.path.join(result_dirs[m], f"{frame_idx:04d}.mat")
            )["poses"], np.float64)) for m in methods]

        gt_ids = meta["cls_indexes"].flatten().astype(np.int64)
        for j, cls_index in enumerate(gt_ids):
            RT_gt = np.asarray(meta["poses"][:, :, j], np.float64)
            R_gt, t_gt = RT_gt[:, :3], RT_gt[:, 3]
            pts = models[int(cls_index)]

            # detection of this gt class (evaluate_poses_keyframe.m:75)
            roi_index = (np.flatnonzero(rois[:, 1] == cls_index)
                         if rois.size else np.array([], np.int64))
            row_sys, row_non, row_rot, row_trans = [], [], [], []
            for poses in results:
                if roi_index.size:
                    pose = poses[roi_index[0]]
                    R = quat_to_matrix_np(pose[:4]) \
                        if np.linalg.norm(pose[:4]) > 0 else np.eye(3)
                    t = pose[4:7]
                    row_sys.append(adi_error(R, t, R_gt, t_gt, pts))
                    row_non.append(add_error(R, t, R_gt, t_gt, pts))
                    row_rot.append(rotation_error_deg(R, R_gt))
                    row_trans.append(translation_error(t, t_gt))
                else:  # missed detection (m:111-116)
                    row_sys.append(np.inf)
                    row_non.append(np.inf)
                    row_rot.append(np.inf)
                    row_trans.append(np.inf)
            rows_sys.append(row_sys)
            rows_non.append(row_non)
            rows_rot.append(row_rot)
            rows_trans.append(row_trans)
            cls_ids.append(int(cls_index))
            frame_ids.append(frame_idx)

    n_m = len(methods)
    return KeyframeResults(
        methods=methods,
        distances_sys=np.asarray(rows_sys, np.float64).reshape(-1, n_m),
        distances_non=np.asarray(rows_non, np.float64).reshape(-1, n_m),
        errors_rotation=np.asarray(rows_rot, np.float64).reshape(-1, n_m),
        errors_translation=np.asarray(rows_trans, np.float64).reshape(-1, n_m),
        cls_ids=np.asarray(cls_ids, np.int64),
        frame_ids=np.asarray(frame_ids, np.int64),
    )


# ---------------------------------------------------------------------------
# Summaries + plots (plot_accuracy_keyframe.m)
# ---------------------------------------------------------------------------

def _auc_and_2cm(distances: np.ndarray,
                 max_distance: float = 0.1) -> tuple[float, float]:
    """One curve's (VOCap AUC, <2cm fraction) with the plot script's exact
    preamble: D > max_distance -> inf, accuracy denominators include the inf
    rows (``plot_accuracy_keyframe.m:42-54,150-170``)."""
    d = np.asarray(distances, np.float64).copy()
    d[d > max_distance] = np.inf
    under_2cm = float((d < 0.02).mean()) if d.size else 0.0
    return vocap_auc(d, max_threshold=max_distance), under_2cm


def summarize(results: KeyframeResults, classes: list[str],
              max_distance: float = 0.1) -> dict:
    """Per-method, per-class metrics table (the numbers MATLAB renders into
    the figure legends, ``plot_accuracy_keyframe.m:52-54``), plus mean finite
    rotation/translation errors."""
    out: dict = {}
    for mi, method in enumerate(results.methods):
        groups: dict[str, np.ndarray] = {
            "all": np.arange(results.cls_ids.size)}
        for cid, cls in enumerate(classes, start=1):
            sel = np.flatnonzero(results.cls_ids == cid)
            if sel.size:
                groups[cls] = sel
        m_out = {}
        for name, sel in groups.items():
            auc_s, cm_s = _auc_and_2cm(results.distances_sys[sel, mi],
                                       max_distance)
            auc_n, cm_n = _auc_and_2cm(results.distances_non[sel, mi],
                                       max_distance)
            rot = results.errors_rotation[sel, mi]
            tr = results.errors_translation[sel, mi]
            finite = np.isfinite(rot)
            m_out[name] = {
                "adds_auc": auc_s * 100, "add_auc": auc_n * 100,
                "adds_under_2cm": cm_s * 100, "add_under_2cm": cm_n * 100,
                "mean_rotation_err_deg":
                    float(rot[finite].mean()) if finite.any() else None,
                "mean_translation_err_m":
                    float(tr[np.isfinite(tr)].mean()) if finite.any() else None,
                "detected": int(finite.sum()), "total": int(sel.size),
            }
        out[method] = m_out
    return out


def plot_accuracy(results: KeyframeResults, classes: list[str],
                  out_dir: str, max_distance: float = 0.1) -> list[str]:
    """Per-class accuracy-threshold figures, paper style: 2x2 subplots
    (ADD-S curve, ADD curve, rotation, translation) with AUC/<2cm legends —
    ``plot_accuracy_keyframe.m:27-148``. Returns the written paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for k, cls in enumerate([*classes, f"All {len(classes)} objects"]):
        sel = np.flatnonzero(results.cls_ids == k + 1)
        if sel.size == 0:  # m:34-36 falls back to all rows
            sel = np.arange(results.cls_ids.size)
        fig, axes = plt.subplots(2, 2, figsize=(12, 9))
        panels = [
            (axes[0, 0], results.distances_sys,
             "Average distance threshold in meter (symmetry)", True),
            (axes[0, 1], results.distances_non,
             "Average distance threshold in meter (non-symmetry)", True),
            (axes[1, 0], results.errors_rotation,
             "Rotation angle threshold", False),
            (axes[1, 1], results.errors_translation,
             "Translation threshold in meter", False),
        ]
        for ax, table, xlabel, clip in panels:
            for mi, method in enumerate(results.methods):
                d = table[sel, mi].copy()
                if clip:
                    d[d > max_distance] = np.inf
                d.sort()
                n = d.size
                acc = np.arange(1, n + 1) / n
                keep = np.isfinite(d)
                label = method
                if clip:
                    auc = vocap_auc(d, max_threshold=max_distance)
                    label = (f"{method}(AUC:{auc * 100:.2f})"
                             f"(<2cm:{(d < 0.02).mean() * 100:.2f})")
                ax.plot(d[keep], acc[keep], linewidth=3, label=label)
            ax.set_xlabel(xlabel)
            ax.set_ylabel("accuracy")
            ax.set_title(cls)
            ax.legend(loc="lower right", fontsize=8)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{cls}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        written.append(path)
    return written
