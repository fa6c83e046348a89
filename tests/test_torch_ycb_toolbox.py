"""Port parity: the YCB keyframe scorer (``densefusion_tpu_torch.eval.
ycb_toolbox``) against ``densefusion_tpu.eval.ycb_toolbox``, exactly
(float64, atol 0): the pose-error primitives, ``score_keyframes`` on the
same result directories (exact, missed, false-positive, zero-quaternion and
far rows), ``summarize``, ``save_mat`` and the file names of
``plot_accuracy``; ``save_mat_atomic`` leaves no partial file."""

import os

import numpy as np
import pytest
import scipy.io as scio

from densefusion_tpu.eval import ycb_toolbox as jtb
from densefusion_tpu_torch.eval import ycb_toolbox as tb

CLASSES = ["001_a", "002_b", "003_c", "004_d"]


def _rotation(rng):
    q = rng.standard_normal(4)
    return jtb.quat_to_matrix_np(q / np.linalg.norm(q)), q


@pytest.fixture(scope="module")
def keyframes(tmp_path_factory):
    """Four classes, five keyframes, two methods. Keyframe 0 has an exact
    pose, 1 a missed gt class and a false-positive roi, 2 a zero quaternion,
    3 a pose 0.5 m off (beyond the curves' 0.1 m) and 4 no roi at all; the
    rest are gt perturbed by a few degrees and millimeters."""
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("toolbox")
    root, posecnn = str(tmp / "root"), str(tmp / "posecnn")
    cfg = os.path.join(root, "dataset_config")
    os.makedirs(cfg)
    os.makedirs(posecnn)
    with open(os.path.join(cfg, "classes.txt"), "w") as f:
        f.write("\n".join(CLASSES) + "\n")
    frames = [f"data/0000/{i + 1:06d}" for i in range(5)]
    with open(os.path.join(cfg, "test_data_list.txt"), "w") as f:
        f.write("\n".join(frames) + "\n")
    for cls in CLASSES:
        os.makedirs(os.path.join(root, "models", cls))
        np.savetxt(os.path.join(root, "models", cls, "points.xyz"),
                   0.04 * rng.standard_normal((300, 3)), fmt="%.6f")
    os.makedirs(os.path.join(root, "data", "0000"))
    dirs = {m: str(tmp / m) for m in ("iterative", "per-pixel")}
    for d in dirs.values():
        os.makedirs(d)
    for i, frame in enumerate(frames):
        gt = [int(c) for c in rng.choice(np.arange(1, 5), size=3,
                                         replace=False)]
        poses = np.zeros((3, 4, len(gt)))
        for k in range(len(gt)):
            poses[:, :3, k] = _rotation(rng)[0]
            poses[:, 3, k] = [rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                              rng.uniform(0.6, 1.0)]
        scio.savemat(os.path.join(root, frame + "-meta.mat"), {
            "cls_indexes": np.asarray(gt, np.float64).reshape(-1, 1),
            "poses": poses})
        rois = list(gt)
        if i == 1:
            rois = rois[1:] + [next(c for c in range(1, 5) if c not in gt)]
        if i == 4:
            rois = []
        scio.savemat(os.path.join(posecnn, f"{i:06d}.mat"), {
            "rois": np.asarray([[0, c, 0, 0, 0, 0, 0] for c in rois],
                               np.float64).reshape(-1, 7)})
        for m, d in dirs.items():
            out = []
            for c in rois:
                k = gt.index(c) if c in gt else 0
                R = poses[:, :3, k]
                dR = _rotation(np.random.default_rng(
                    rng.integers(1 << 31)))[0] if m == "per-pixel" else None
                ang = np.radians(rng.uniform(1, 8))
                rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                               [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
                R_est = R @ (rz if dR is None else dR)
                t_est = poses[:, 3, k] + rng.normal(0, 0.005, 3)
                if i == 0:
                    R_est, t_est = R, poses[:, 3, k]
                q = _matrix_to_quat(R_est)
                if i == 2:
                    q = np.zeros(4)
                if i == 3:
                    t_est = t_est + 0.5
                out.append(np.concatenate([q, t_est]))
            scio.savemat(os.path.join(d, f"{i:04d}.mat"),
                         {"poses": np.asarray(out, np.float64).reshape(-1, 7)})
    return {"root": root, "posecnn": posecnn, "dirs": dirs}


def _matrix_to_quat(R):
    """wxyz of a rotation matrix (from the trace when it is positive, else
    from the largest diagonal element)."""
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
    q = np.zeros(4)
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    q[0] = (R[k, j] - R[j, k]) / s
    return q


def test_primitives_match_jax(rng):
    pts = 0.05 * rng.standard_normal((500, 3))
    for _ in range(5):
        (R1, q), (R2, _) = _rotation(rng), _rotation(rng)
        t1, t2 = rng.standard_normal(3), rng.standard_normal(3)
        for name in ("add_error", "adi_error"):
            assert getattr(tb, name)(R1, t1, R2, t2, pts) == \
                getattr(jtb, name)(R1, t1, R2, t2, pts), name
        assert tb.rotation_error_deg(R1, R2) == jtb.rotation_error_deg(R1, R2)
        assert tb.translation_error(t1, t2) == jtb.translation_error(t1, t2)
        np.testing.assert_array_equal(tb.quat_to_matrix_np(3.0 * q),
                                      jtb.quat_to_matrix_np(3.0 * q))
    assert tb.rotation_error_deg(R1, R1) == jtb.rotation_error_deg(R1, R1)


def _assert_results_equal(got, want):
    assert got.methods == want.methods
    for field in ("distances_sys", "distances_non", "errors_rotation",
                  "errors_translation", "cls_ids", "frame_ids"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("num_keyframes", [None, 3])
def test_score_and_summarize_match_jax(keyframes, num_keyframes):
    args = (keyframes["root"], keyframes["posecnn"], keyframes["dirs"])
    got = tb.score_keyframes(*args, num_keyframes=num_keyframes)
    want = jtb.score_keyframes(*args, num_keyframes=num_keyframes)
    _assert_results_equal(got, want)
    # the fixture's cases are all there: exact, miss, zero quaternion, far
    assert (got.distances_sys == 0).any()
    assert np.isinf(got.distances_sys).any()
    if num_keyframes is None:
        assert (got.distances_sys[:, 0] > 0.1).any()
        assert np.isinf(got.distances_sys[got.frame_ids == 4]).all()
    table = tb.summarize(got, CLASSES)
    assert table == jtb.summarize(want, CLASSES)
    assert set(table) == {"iterative", "per-pixel"}
    assert table["iterative"]["all"]["total"] == got.cls_ids.size


def test_save_mat_matches_jax(keyframes, tmp_path):
    res = tb.score_keyframes(keyframes["root"], keyframes["posecnn"],
                             keyframes["dirs"])
    jres = jtb.score_keyframes(keyframes["root"], keyframes["posecnn"],
                               keyframes["dirs"])
    res.save_mat(str(tmp_path / "ours.mat"))
    jres.save_mat(str(tmp_path / "jax.mat"))
    got, want = (scio.loadmat(str(tmp_path / f)) for f in ("ours.mat",
                                                           "jax.mat"))
    keys = {k for k in want if not k.startswith("__")}
    assert {k for k in got if not k.startswith("__")} == keys
    for k in keys:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(os.listdir(tmp_path)) == ["jax.mat", "ours.mat"]


def test_save_mat_atomic_leaves_no_partial_file(tmp_path, monkeypatch):
    """A write that fails halfway leaves neither the result nor a temporary
    file; an earlier result at the path survives it whole."""
    path = str(tmp_path / "0000.mat")

    def broken(f, mdict):
        f.write(b"MATLAB 5.0 MAT-file, truncated")
        raise OSError("disk full")

    tb.save_mat_atomic(path, {"poses": np.ones((2, 7))})
    monkeypatch.setattr(scio, "savemat", broken)
    with pytest.raises(OSError, match="disk full"):
        tb.save_mat_atomic(path, {"poses": np.zeros((2, 7))})
    with pytest.raises(OSError):
        tb.save_mat_atomic(str(tmp_path / "0001.mat"), {"poses": []})
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["0000.mat"]
    np.testing.assert_array_equal(scio.loadmat(path)["poses"],
                                  np.ones((2, 7)))


def test_plot_accuracy_writes_the_jax_file_names(keyframes, tmp_path):
    pytest.importorskip("matplotlib")
    res = tb.score_keyframes(keyframes["root"], keyframes["posecnn"],
                             keyframes["dirs"])
    got = tb.plot_accuracy(res, CLASSES, str(tmp_path / "ours"))
    want = jtb.plot_accuracy(res, CLASSES, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == len(CLASSES) + 1
    assert all(os.path.getsize(p) > 0 for p in got)
