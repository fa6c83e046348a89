"""Port parity: the data plane (``densefusion_tpu_torch.data``) against
``densefusion_tpu.data``.

Both packages pass their samples through a host library of one source
(``runtime/libdfnative.so`` on the JAX side, the port's own build of
``densefusion_tpu_torch/csrc/dfnative.cpp``), their default path. With both
libraries on, every field of every sample is exactly equal, in train and
test mode over two epochs: the library's training samples differ from the
numpy path's (the synthetic frames' pixel noise comes from a fixed pool),
and the port's draw the same noise. With both libraries switched off
(``native._load`` patched to find none, on both sides), the numpy paths
are held to each other: every field exact, the image within 1e-6. The
synthetic generators write the same files for one seed.
"""

import filecmp
import os

import numpy as np
import pytest

import densefusion_tpu.native as jnative
import densefusion_tpu_torch.native as tnative
from densefusion_tpu.data import augment as jaugment
from densefusion_tpu.data import common as jcommon
from densefusion_tpu.data import linemod as jlinemod
from densefusion_tpu.data import ply as jply
from densefusion_tpu.data import synthetic as jsynthetic
from densefusion_tpu.data import ycb as jycb
from densefusion_tpu.geometry.camera import LINEMOD_CAM as J_LINEMOD_CAM

import densefusion_tpu_torch.data as tdata
from densefusion_tpu_torch.data import augment, common, linemod, ply, ycb
from densefusion_tpu_torch.data import synthetic
from densefusion_tpu_torch.geometry.camera import LINEMOD_CAM

KW = dict(num_points=256, crop_size=64)
LM_OBJS = [1, 10]        # 10, the eggbox, is symmetric


@pytest.fixture
def no_library(monkeypatch):
    """Both packages' numpy paths: neither native library is found."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)


@pytest.fixture
def with_library():
    """Both packages' default paths, through their native libraries."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    assert tnative.fused_scan_supported()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One seed through both packages' generators: (JAX root, port root)
    for a 4-class YCB set (4 real + 4 synthetic training frames, 2 test
    frames with PoseCNN results) and, under ``lm``, a LineMOD set of objects
    1 and 10 with the realism options, both at 480x640 (at a smaller frame
    the cameras' principal points put most objects out of view)."""
    out = []
    for gen in (jsynthetic, synthetic):
        root = str(tmp_path_factory.mktemp("roots"))
        gen.generate_ycb_style_dataset(
            root, n_classes=4, n_real=4, n_syn=4, n_test=2, seed=3,
            posecnn_dir=os.path.join(root, "posecnn"))
        gen.generate_linemod_style_dataset(
            os.path.join(root, "lm"), objlist=tuple(LM_OBJS), n_train=3,
            n_test=10, seed=3, realism=True)
        out.append(root)
    return tuple(out)


def assert_samples_equal(got, want, img_atol=1e-6, float_atol=0.0):
    """Every field of two PoseSamples: same dtype and shape; the image
    within ``img_atol``; float fields within ``float_atol`` (exact at 0);
    the rest exact."""
    for name in want._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        atol = img_atol if name == "img" else float_atol
        if atol and g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_ply_round_trip(tmp_path, rng):
    pts = rng.standard_normal((100, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (100, 3)).astype(np.uint8)
    for colors in (None, cols):
        path = str(tmp_path / "ours.ply")
        ply.write_ply(path, pts, colors)
        np.testing.assert_allclose(ply.read_ply_vertices(path), pts,
                                   atol=1e-5)
        np.testing.assert_array_equal(jply.read_ply_vertices(path),
                                      ply.read_ply_vertices(path))
        jpath = str(tmp_path / "jax.ply")
        jply.write_ply(jpath, pts, colors)
        assert filecmp.cmp(path, jpath, shallow=False)
    (tmp_path / "bad.ply").write_text("plx\n")
    with pytest.raises(ValueError, match="not a PLY"):
        ply.read_ply_vertices(str(tmp_path / "bad.ply"))


AUGMENTS = ["jitter_params", "apply_color_jitter_uint8",
            "apply_color_jitter_float", "color_jitter", "translation_noise",
            "gaussian_pixel_noise", "resize_bilinear_np"]


def _augment_case(name, rng):
    """(port result, JAX result, port generator, JAX generator) of one
    augmentation from one generator state."""
    img8 = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    imgf = rng.uniform(0, 255, (33, 47, 3)).astype(np.float32)
    seed = int(rng.integers(1 << 30))
    ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    calls = {
        "jitter_params": lambda m, g: m.jitter_params(g),
        "apply_color_jitter_uint8": lambda m, g: m.apply_color_jitter(
            img8, m.jitter_params(g)),
        "apply_color_jitter_float": lambda m, g: m.apply_color_jitter(
            imgf, m.jitter_params(g, hue=0.5)),
        "color_jitter": lambda m, g: m.color_jitter(img8, g),
        "translation_noise": lambda m, g: m.translation_noise(g, 0.03),
        "gaussian_pixel_noise": lambda m, g: m.gaussian_pixel_noise(
            img8, g, 7.0),
        "resize_bilinear_np": lambda m, g: m.resize_bilinear_np(imgf, 20,
                                                                 64),
        # the library's paths: the pool in place on a float32 crop, on a
        # copy of a uint8 one, and its own draws past the pool's size
        "gaussian_pixel_noise_seeded": lambda m, g: m.gaussian_pixel_noise(
            imgf.copy(), g, 7.0, seed=seed),
        "gaussian_pixel_noise_seeded_uint8": lambda m, g:
            m.gaussian_pixel_noise(img8, g, 7.0, seed=seed),
        "gaussian_pixel_noise_seeded_large": lambda m, g:
            m.gaussian_pixel_noise(np.zeros((700, 1000, 3), np.float32), g,
                                   7.0, seed=seed),
    }
    return calls[name](augment, ours), calls[name](jaugment, theirs), \
        ours, theirs


def _assert_augment_equal(got, want, ours, theirs):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)
    assert ours.integers(1 << 30) == theirs.integers(1 << 30)


@pytest.mark.parametrize("name", AUGMENTS)
def test_augment_matches_jax(name, no_library, rng):
    """Each augmentation from the same generator state as the JAX one's
    numpy path: equal results, and the generators left in the same
    state."""
    _assert_augment_equal(*_augment_case(name, rng))


@pytest.mark.parametrize("name", AUGMENTS + [
    "gaussian_pixel_noise_seeded", "gaussian_pixel_noise_seeded_uint8",
    "gaussian_pixel_noise_seeded_large"])
def test_augment_matches_jax_with_library(name, with_library, rng):
    """Both libraries on: uint8 jitter through the fused pass, seeded pixel
    noise from the fixed pool; equal results and generator states."""
    _assert_augment_equal(*_augment_case(name, rng))


def test_resize_bilinear_np_importable_from_data():
    assert tdata.resize_bilinear_np is augment.resize_bilinear_np
    assert common.resize_bilinear_np is augment.resize_bilinear_np


def _frame(rng, h=120, w=160):
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    depth = rng.integers(500, 1500, (h, w)).astype(np.uint16)
    mask = np.zeros((h, w), bool)
    mask[30:75, 40:110] = True
    depth[35:40] = 0
    return rgb, depth, mask


HOOKS = ["plain", "add_t", "rgb_transform", "crop_fn", "mask_fn",
         "native_crop", "crop_at_size", "empty_mask", "few_pixels"]


def _assemble_both(hook, rng):
    """(port sample, JAX sample) of ``assemble_sample`` with one hook, on
    the same inputs and generator state."""
    rgb, depth, mask = _frame(rng)
    model = rng.uniform(-0.05, 0.05, (40, 3)).astype(np.float32)
    target = model + np.float32(0.7)
    bbox = (30, 75, 40, 110)
    num_points, crop = 200, 48
    if hook == "crop_at_size":
        bbox, crop = (30, 70, 40, 80), 40      # the snapped crop is 40x40
    if hook == "empty_mask":
        mask[:] = False
    if hook == "few_pixels":
        mask[:] = False
        mask[50:55, 60:70] = True               # 50 pixels: wrap-padded
    seed = int(rng.integers(1 << 30))

    def run(mod, cam):
        g = np.random.default_rng(seed)
        kw = dict(bbox=bbox, model_points=model, target=target, obj_idx=2,
                  sym=True, num_points=num_points, crop_size=crop, rng=g,
                  point_fn=mod.pinhole_point_fn(depth, cam, cam.depth_scale,
                                                unit_scale=1e-3))
        if hook == "add_t":
            kw["add_t"] = np.array([0.01, -0.02, 0.005], np.float32)
        if hook == "rgb_transform":
            aug = augment if mod is common else jaugment
            kw["rgb_transform"] = lambda c: aug.color_jitter(c, g)
        if hook == "crop_fn":
            kw["crop_fn"] = lambda r0, r1, c0, c1: 255 - rgb[r0:r1, c0:c1]
            kw["mask"] = mask & (depth != 0)
        elif hook == "mask_fn":
            valid = mask & (depth != 0)
            kw["mask_fn"] = lambda r0, r1, c0, c1: valid[r0:r1, c0:c1]
            kw["frame_hw"] = mask.shape
            kw["rgb"] = rgb
        else:
            kw["rgb"], kw["mask"] = rgb, mask & (depth != 0)
        if hook == "native_crop":
            kw["native_crop"] = True
        return mod.assemble_sample(**kw)

    got, want = run(common, LINEMOD_CAM), run(jcommon, J_LINEMOD_CAM)
    assert bool(got.valid) == (hook != "empty_mask")
    if hook == "native_crop":
        assert got.img.shape == (80, 80, 3)
    return got, want


@pytest.mark.parametrize("hook", HOOKS)
def test_assemble_sample_matches_jax(hook, no_library, rng):
    """``assemble_sample`` with each hook, against the JAX function's numpy
    path on the same inputs and generator state."""
    assert_samples_equal(*_assemble_both(hook, rng))


@pytest.mark.parametrize("hook", HOOKS)
def test_assemble_sample_matches_jax_with_library(hook, with_library, rng):
    """The same with both libraries on (back-projection, the fused
    normalize + resize, the ``choose`` remap, the uint8 jitter): every
    field exactly equal."""
    assert_samples_equal(*_assemble_both(hook, rng), img_atol=0.0)


def test_subsample_model_points_matches_jax(rng):
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    for num in (100, 300, 700):
        got = common.subsample_model_points(pts, num,
                                            np.random.default_rng(num))
        want = jcommon.subsample_model_points(pts, num,
                                              np.random.default_rng(num))
        assert got.shape == (num, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["ycb", "linemod"])
def test_generators_write_the_same_files(roots, which):
    """The same tree from both generators for one seed: PNG pixels, the
    ``.mat`` arrays and every text file (``gt.yml``, PLY, ``points.xyz``,
    lists) equal."""
    from PIL import Image
    import scipy.io as scio

    jroot, troot = (os.path.join(r, "lm") if which == "linemod" else r
                    for r in roots)
    seen = {".png": 0, ".mat": 0, ".yml": 0, ".ply": 0, ".xyz": 0}
    for dirpath, dirnames, files in os.walk(jroot):
        rel = os.path.relpath(dirpath, jroot)
        assert sorted(os.listdir(os.path.join(troot, rel))) == \
            sorted(files + dirnames), rel
        if which == "ycb" and dirpath == jroot:
            dirnames.remove("lm")
        for f in files:
            a, b = os.path.join(dirpath, f), os.path.join(troot, rel, f)
            ext = os.path.splitext(f)[1]
            seen[ext] = seen.get(ext, 0) + 1
            if ext == ".png":
                x, y = np.array(Image.open(a)), np.array(Image.open(b))
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=a)
            elif ext == ".mat":
                x, y = scio.loadmat(a), scio.loadmat(b)
                assert {k for k in x if not k.startswith("__")} == \
                    {k for k in y if not k.startswith("__")}
                for k in x:
                    if not k.startswith("__"):
                        np.testing.assert_array_equal(x[k], y[k], err_msg=a)
            else:
                assert filecmp.cmp(a, b, shallow=False), a
    if which == "ycb":
        assert seen[".png"] == 3 * 10 and seen[".mat"] == 10 + 2
        assert seen[".xyz"] == 4
    else:
        assert seen[".yml"] == 3 and seen[".ply"] == 2


def _readers(case, root):
    """(port reader, JAX reader) of one case on ``root``."""
    lm = os.path.join(root, "lm")
    if case.startswith("linemod"):
        mode = case.split("-")[1]
        return (linemod.LineModDataset(lm, mode, objlist=LM_OBJS, **KW),
                jlinemod.LineModDataset(lm, mode, objlist=LM_OBJS, **KW))
    if case.startswith("ycb"):
        mode = case.split("-")[1]
        return ycb.YCBDataset(root, mode, **KW), jycb.YCBDataset(root, mode,
                                                                 **KW)
    pc = os.path.join(root, "posecnn")
    return (ycb.YCBPoseCNNEvalDataset(root, pc, **KW),
            jycb.YCBPoseCNNEvalDataset(root, pc, **KW))


def _compare_readers(case, root, **tol):
    ours, theirs = _readers(case, root)
    assert len(ours) == len(theirs) > 0
    n = 0
    if case == "posecnn":
        for i in range(len(ours)):
            got, want = ours.detections(i), theirs.detections(i)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g[1:] == w[1:]
                assert_samples_equal(g[0], w[0], **tol)
                n += 1
        return n
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            assert_samples_equal(ours[i], theirs[i], **tol)
            n += 1
    return n


@pytest.mark.parametrize("case", [
    "linemod-train", "linemod-test", "linemod-eval", "ycb-train", "ycb-test",
    "posecnn"])
def test_readers_match_jax_without_library(roots, case, no_library):
    """Library off, the same root, seed, epoch and index give the same
    sample: train mode with its noise (color jitter, translation noise; for
    YCB the occluders, backgrounds and pixel noise of synthetic frames)."""
    assert _compare_readers(case, roots[0]) > 0


@pytest.mark.parametrize("case", [
    "linemod-test", "linemod-eval", "ycb-test", "posecnn"])
def test_readers_match_jax_with_library_in_test_mode(roots, case,
                                                     with_library):
    """Both libraries on (PNG decode, back-projection, the fused normalize
    + resize): test-mode samples exactly equal, over two epochs."""
    assert _compare_readers(case, roots[0], img_atol=0.0) > 0


@pytest.mark.parametrize("case", ["linemod-train", "ycb-train"])
def test_readers_match_jax_with_library_in_train_mode(roots, case,
                                                      with_library):
    """Both libraries on, train mode over two epochs: the jitter's fused
    pass; for YCB the occluders and label scans in one frame pass, the
    crop-window mask, the composited backgrounds and the pooled pixel
    noise of synthetic frames. Every field exactly equal."""
    assert _compare_readers(case, roots[0], img_atol=0.0) > 0


def test_ycb_reader_reads_port_root_and_flags(roots):
    """The port reader on the port generator's root: the YCB width's
    fields, symmetric classes flagged from ``YCB_SYM``, the second camera
    from video 60 on, and ``refine`` switching to 2600 mesh points."""
    ds = ycb.YCBDataset(roots[1], "train", **KW)
    assert len(ds) == 8 and len(ds.real) == 4 and len(ds.syn) == 4
    s = ds[0]
    assert s.points.shape == (256, 3) and s.img.shape == (64, 64, 3)
    assert s.model_points.shape == (500, 3) and s.choose.dtype == np.int32
    assert bool(s.sym) == (int(s.obj_idx) in ycb.YCB_SYM)
    assert ds._intrinsics("data/0059/000001") is ycb.YCB_CAM_1
    assert ds._intrinsics("data/0060/000001") is ycb.YCB_CAM_2
    assert ds._intrinsics("data_syn/000001") is ycb.YCB_CAM_1
    assert ycb.YCBDataset(roots[1], "train", refine=True,
                          **KW)[0].model_points.shape == (2600, 3)
    lm = linemod.LineModDataset(os.path.join(roots[1], "lm"), "train",
                                objlist=LM_OBJS, **KW)
    assert lm.sym_list == [1] and linemod.LINEMOD_SYM == [7, 8]
    np.testing.assert_array_equal(
        lm.diameters(),
        jlinemod.LineModDataset(os.path.join(roots[0], "lm"), "train",
                                objlist=LM_OBJS, **KW).diameters())
