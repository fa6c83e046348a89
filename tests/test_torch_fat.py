"""Port parity: the FallingThings tools (``data/fat.py``,
``generate_fat_style_scene``, ``cli.verify_fat``, ``cli.reconstruct_fat``).

Host float64 numpy on both sides, held exact: the generators write the
same files byte for byte for one seed; the readers, pose decodes,
quaternion checks and back-projections give equal arrays; ``verify_scene``
gives equal rows under both pose sources and depth units; the
reconstruction's clouds and PLY files are equal; the CLIs print the same
lines and write the same files.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from densefusion_tpu.cli import reconstruct_fat as j_reconstruct_cli
from densefusion_tpu.cli import verify_fat as j_verify_cli
from densefusion_tpu.data import fat as jfat
from densefusion_tpu.data.synthetic import generate_fat_style_scene as j_gen
from densefusion_tpu_torch.cli import reconstruct_fat as reconstruct_cli
from densefusion_tpu_torch.cli import verify_fat as verify_cli
from densefusion_tpu_torch.data import fat, generate_fat_style_scene
from densefusion_tpu_torch.data.ply import write_ply


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX scene, port scene, model points, model PLY) from seed 5."""
    jdir = str(tmp_path_factory.mktemp("fat_jax"))
    tdir = str(tmp_path_factory.mktemp("fat_port"))
    jmodel = j_gen(jdir, n_frames=2, seed=5)
    model = generate_fat_style_scene(tdir, n_frames=2, seed=5)
    np.testing.assert_array_equal(model, jmodel)
    ply = os.path.join(str(tmp_path_factory.mktemp("fat_model")),
                       "model.ply")
    write_ply(ply, model)
    return jdir, tdir, model, ply


def test_generator_writes_the_same_files(scenes):
    jdir, tdir, _, _ = scenes
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert {os.path.splitext(n)[1] for n in names} == {".json", ".jpg",
                                                       ".png"}
    for n in names:
        with open(os.path.join(jdir, n), "rb") as a, \
                open(os.path.join(tdir, n), "rb") as b:
            assert a.read() == b.read(), n


def test_constants_and_quaternions():
    for name in ("FAT_PERMUTATION", "FAT_DEPTH_SCALE", "FAT_CM"):
        np.testing.assert_array_equal(getattr(fat, name), getattr(jfat, name))
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(fat.rotation_from_quaternion_xyzw(q),
                                      jfat.rotation_from_quaternion_xyzw(q))
        np.testing.assert_array_equal(
            fat.permuted_matrix_from_quaternion_xyzw(q),
            jfat.permuted_matrix_from_quaternion_xyzw(q))


def test_scene_reader_and_decodes_match_jax(scenes):
    jdir, tdir, _, _ = scenes
    scene, jscene = fat.FATScene(tdir), jfat.FATScene(jdir)
    assert scene.frames == jscene.frames and len(scene.frames) == 2
    assert scene.cameras.cams == jscene.cameras.cams
    for cls, entry in jscene.objects.objects.items():
        for k, v in entry.items():
            np.testing.assert_array_equal(scene.objects.objects[cls][k], v)
    for key in scene.frames:
        fr, jfr = scene.frame(key), jscene.frame(key)
        for k in ("rgb", "depth", "seg"):
            assert fr[k].dtype == jfr[k].dtype
            np.testing.assert_array_equal(fr[k], jfr[k])
        assert fr["annotation"] == jfr["annotation"]
        obj = fr["annotation"]["objects"][0]
        for dec, jdec in ((fat.fat_pose, jfat.fat_pose),
                          (fat.fat_pose_plain, jfat.fat_pose_plain)):
            for a, b in zip(dec(obj), jdec(obj)):
                np.testing.assert_array_equal(a, b)
        assert fat.check_quaternion_consistency(obj) == \
            jfat.check_quaternion_consistency(obj)
        bad = dict(obj, quaternion_xyzw=[0.0, 0.0, 0.0, 1.0])
        assert not fat.check_quaternion_consistency(bad)["consistent"]
        mask = fr["seg"] == 255
        for unit in ("tenth_mm", "normalized_10m"):
            np.testing.assert_array_equal(
                fat.backproject_fat_depth(fr["depth"], mask, fr["cam"], unit),
                jfat.backproject_fat_depth(jfr["depth"], mask, jfr["cam"],
                                           unit))
            np.testing.assert_array_equal(
                fat.backproject_full_depth(fr["depth"], fr["cam"], unit),
                jfat.backproject_full_depth(jfr["depth"], jfr["cam"], unit))
    with pytest.raises(ValueError, match="depth_unit"):
        fat.backproject_fat_depth(fr["depth"], mask, fr["cam"], "inches")


@pytest.mark.parametrize("pose_source,depth_unit,quat", [
    ("permuted", "tenth_mm", False), ("plain", "tenth_mm", True),
    ("permuted", "normalized_10m", False)])
def test_verify_scene_rows_match_jax(scenes, pose_source, depth_unit, quat):
    jdir, tdir, model, _ = scenes
    kw = dict(pose_source=pose_source, depth_unit=depth_unit,
              check_quaternion=quat)
    rows = fat.verify_scene(tdir, model, **kw)
    assert rows == jfat.verify_scene(jdir, model, **kw)
    assert len(rows) == 2
    if depth_unit == "tenth_mm":
        assert all(r["status"] == "ok" and r["mean_nn_dist_m"] < 0.005
                   for r in rows)
    if quat:
        assert all(r["quaternion"]["consistent"] for r in rows)
    assert fat.verify_scene(tdir, model, max_frames=1, **kw) == rows[:1]


def test_verify_detects_a_bad_pose(scenes, tmp_path):
    """A pose 10 cm off moves the mean NN distance past 2 cm in both."""
    import json
    import shutil

    jdir, tdir, model, _ = scenes
    bad = str(tmp_path / "bad")
    shutil.copytree(tdir, bad)
    key = fat.FATScene(bad).frames[0]
    path = os.path.join(bad, key + ".json")
    with open(path) as f:
        ann = json.load(f)
    ann["objects"][0]["pose_transform_permuted"][3][0] += 10.0
    with open(path, "w") as f:
        json.dump(ann, f)
    rows = fat.verify_scene(bad, model)
    assert rows == jfat.verify_scene(bad, model)
    assert rows[0]["mean_nn_dist_m"] > 0.02


@pytest.mark.parametrize("pose_source", ["permuted", "plain"])
def test_reconstruct_frame_matches_jax(scenes, tmp_path, pose_source):
    jdir, tdir, model, _ = scenes
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    scene, jscene = fat.FATScene(tdir), jfat.FATScene(jdir)
    key = scene.frames[1]
    got = fat.reconstruct_frame(scene, key, model, pose_source=pose_source,
                                out_dir=out)
    want = jfat.reconstruct_frame(jscene, key, model,
                                  pose_source=pose_source, out_dir=jout)
    np.testing.assert_array_equal(got["scene_cloud"], want["scene_cloud"])
    assert len(got["objects"]) == len(want["objects"]) == 1
    for g, w in zip(got["objects"], want["objects"]):
        assert g.keys() == w.keys() and g["class"] == w["class"]
        for k in ("object_cloud", "posed_model"):
            np.testing.assert_array_equal(g[k], w[k])
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(out)) == ["identity.ply",
                                                "projected.ply", "target.ply"]
    for n in names:
        with open(os.path.join(out, n), "rb") as a, \
                open(os.path.join(jout, n), "rb") as b:
            assert a.read() == b.read(), n
    no_model = fat.reconstruct_frame(scene, key)
    assert "posed_model" not in no_model["objects"][0]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("flags", [[], ["--pose_source", "plain",
                                        "--check_quaternion"],
                                   ["--max_frames", "1",
                                    "--threshold_m", "0.0001"]],
                         ids=["default", "plain_quat", "strict"])
def test_verify_fat_cli_matches_jax(scenes, flags):
    jdir, tdir, _, ply = scenes
    rc, text = _run(verify_cli.main, ["--scene", tdir, "--model", ply]
                    + flags)
    jrc, jtext = _run(j_verify_cli.main, ["--scene", jdir, "--model", ply]
                      + flags)
    assert (rc, text) == (jrc, jtext)
    assert rc == (1 if "--threshold_m" in flags else 0)


def test_reconstruct_fat_cli_matches_jax(scenes, tmp_path):
    jdir, tdir, _, ply = scenes
    xyz = str(tmp_path / "model.xyz")
    np.savetxt(xyz, scenes[2][:50])
    for model in (ply, xyz):
        out, jout = str(tmp_path / "p"), str(tmp_path / "j")
        _, text = _run(reconstruct_cli.main, ["--scene", tdir, "--model",
                                              model, "--out_dir", out])
        _, jtext = _run(j_reconstruct_cli.main, ["--scene", jdir, "--model",
                                                 model, "--out_dir", jout])
        assert text.replace(out, "") == jtext.replace(jout, "")
        for n in ("identity.ply", "projected.ply", "target.ply"):
            with open(os.path.join(out, n), "rb") as a, \
                    open(os.path.join(jout, n), "rb") as b:
                assert a.read() == b.read(), n
