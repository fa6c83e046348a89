"""The port's host data-plane library (``densefusion_tpu_torch/native.py``
over its own build of ``csrc/dfnative.cpp``).

* Every entry point against the JAX package's library
  (``densefusion_tpu/native.py`` over ``runtime/libdfnative.so``) on seeded
  inputs: exactly equal. The two are built from one source with one
  ``g++`` command line.
* Every entry point against the port's numpy plain version, at
  ``tests/test_native.py``'s tolerances: back-projection rtol 1e-5, resize
  atol 1e-4, jitter atol 0.35 (float32 against float64 HSV), PNG decode,
  the label scans, compositing and the pool's noise exact.
* The build: ``g++`` output on a failed build is raised (by the build and
  by ``native._load``, which never returns None), concurrent builds into
  one directory leave one whole library, the digest follows the source.
"""

import io
import itertools
import multiprocessing as mp
import types

import numpy as np
import pytest
from PIL import Image

import densefusion_tpu.native as jnative
import densefusion_tpu_torch.native as tnative
from densefusion_tpu_torch.data.augment import (
    apply_color_jitter, jitter_params, resize_bilinear_np,
)
from densefusion_tpu_torch.data.common import pinhole_point_fn_np
from densefusion_tpu_torch.data.schema import (
    IMAGENET_MEAN_255, IMAGENET_STD_255, normalize_image,
)
from densefusion_tpu_torch.geometry.bbox import remap_choose_to_resized
from densefusion_tpu_torch.geometry.camera import LINEMOD_CAM
from densefusion_tpu_torch.ops import build


@pytest.fixture(scope="module", autouse=True)
def libraries():
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    assert tnative.available()


def _png(arr, palette=False) -> bytes:
    im = Image.fromarray(arr)
    if palette:
        im = im.convert("P")
    b = io.BytesIO()
    im.save(b, "PNG")
    return b.getvalue()


def _png16(depth) -> bytes:
    im = Image.new("I;16", depth.shape[::-1])
    im.frombytes(depth.tobytes())
    b = io.BytesIO()
    im.save(b, "PNG")
    return b.getvalue()


def _scene(rng, h=97, w=133):
    """A label with three objects (one a single pixel at a row's end),
    depth with holes, an occluder label of two objects."""
    label = np.zeros((h, w), np.uint8)
    label[10:40, 20:70] = 3
    label[35:80, 60:100] = 7
    label[0, w - 1] = 9
    depth = (rng.integers(0, 3, (h, w)) * 500).astype(np.uint16)
    f_label = np.zeros((h, w), np.uint8)
    f_label[30:60, 40:80] = 2
    f_label[5:15, 5:25] = 4
    return label, depth, f_label


def _crop_layers(rng, h=21, w=34):
    rgb, back, front = (rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                        for _ in range(3))
    label = (rng.random((h, w)) < 0.5).astype(np.uint8) * 5
    fmask = (rng.random((h, w)) < 0.5).astype(np.uint8)
    return rgb, back, label, front, fmask


def _cases(m, rng):
    """Entry point name -> a call of it on module ``m`` (``jnative`` or
    ``tnative``) with inputs drawn from ``rng``."""
    mask = np.zeros((40, 40), np.uint8)
    mask[5:30, 5:30] = 1
    n = 200
    depth = rng.uniform(100, 5000, n).astype(np.float32)
    rows, cols = rng.integers(0, 480, n), rng.integers(0, 640, n)
    img8 = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    imgf = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    label, sdepth, f_label = _scene(rng)
    rgb, back, clabel, front, fmask = _crop_layers(rng)
    pool = rng.standard_normal(2048).astype(np.float32)
    base = rng.uniform(0, 255, 999).astype(np.float32)
    factors = np.array([1.15, 0.85, 1.2, 0.04], np.float32)
    pngs = [_png(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)),
            _png(rng.integers(0, 256, (48, 64)).astype(np.uint8)),
            _png(rng.integers(0, 256, (20, 16, 4)).astype(np.uint8)),
            _png16(rng.integers(0, 65535, (48, 64)).astype(np.uint16)),
            _png(rng.integers(0, 22, (48, 64)).astype(np.uint8), True),
            b"not a png at all"]
    return {
        "choose_pixels": lambda: (m.choose_pixels(mask, 100, seed=7),
                                  m.choose_pixels(mask[:8], 120, seed=1),
                                  m.choose_pixels(mask * 0, 8, seed=0)),
        "backproject": lambda: m.backproject(
            depth, rows, cols, 572.4, 573.5, 325.3, 242.0, 1.0, 1e-3),
        "normalize_resize_uint8": lambda: m.normalize_resize(
            img8, 24, 24, IMAGENET_MEAN_255, IMAGENET_STD_255),
        "normalize_resize_float32": lambda: m.normalize_resize(
            imgf, 32, 48, IMAGENET_MEAN_255, IMAGENET_STD_255),
        "normalize_resize_at_size": lambda: m.normalize_resize(
            img8, 37, 53, IMAGENET_MEAN_255, IMAGENET_STD_255),
        "remap_choose": lambda: m.remap_choose(
            rng.integers(0, 20 * 30, 300), 20, 30, 8, 8),
        "decode_png": lambda: [m.decode_png(p) for p in pngs],
        "color_jitter": lambda: [
            m.color_jitter(img8, np.asarray(o, np.int32), factors)
            for o in itertools.chain(
                itertools.permutations(range(4)),
                ([], [1], [3], [1, 3], [3, 1], [0, 2], [3, 0, 1]))],
        "gaussian_noise": lambda: m.gaussian_noise(imgf.copy(), 7.0, 123),
        "label_depth_hist": lambda: m.label_depth_hist(label, sdepth),
        "apply_front": lambda: m.apply_front(label, f_label, 2, 4),
        "object_mask": lambda: (m.object_mask(label, sdepth, 7),
                                m.object_mask(label, sdepth, 5)),
        "label_hist_bbox": lambda: m.label_hist_bbox(label, sdepth),
        "apply_front_hist_bbox": lambda: m.apply_front_hist_bbox(
            label, f_label, sdepth, 2, 4),
        "object_mask_window": lambda: m.object_mask_window(
            label, sdepth, 7, 30, 85, 55, 105),
        "add_scaled": lambda: m.add_scaled(base.copy(), pool[7:], 3.0),
        "compose_crop": lambda: [
            m.compose_crop(rgb, *b, *f)
            for b in ((None, None), (back, clabel))
            for f in ((None, None), (front, fmask))],
    }


ENTRY_POINTS = list(_cases(tnative, np.random.default_rng(0)))


def _flat(x):
    """The arrays and scalars of a nested result, in order."""
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in _flat(item)]
    return [x]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_equals_jax_library(name):
    got = _flat(_cases(tnative, np.random.default_rng(5))[name]())
    want = _flat(_cases(jnative, np.random.default_rng(5))[name]())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_public_names_cover_jax():
    """Every public name of the JAX module is in the port's, and the
    probes answer True against the port's own build."""
    def public(mod):
        return {k for k, v in vars(mod).items()
                if not k.startswith("_") and k != "annotations"
                and not isinstance(v, types.ModuleType)}
    assert public(jnative) <= public(tnative)
    assert ENTRY_POINTS and all(
        f() for f in (tnative.available, tnative.decode_supported,
                      tnative.loader_kernels_supported,
                      tnative.fused_scan_supported))
    assert tnative._load().df_version() == tnative.VERSION == 4


# -- against the port's numpy plain versions ------------------------------

def test_backproject_matches_plain(rng):
    depth = rng.integers(300, 3000, (60, 80)).astype(np.uint16)
    rows, cols = rng.integers(0, 60, 300), rng.integers(0, 80, 300)
    got = tnative.backproject(depth[rows, cols], rows, cols, LINEMOD_CAM.fx,
                              LINEMOD_CAM.fy, LINEMOD_CAM.cx, LINEMOD_CAM.cy,
                              1.0, 1e-3)
    want = pinhole_point_fn_np(depth, LINEMOD_CAM, 1.0, 1e-3)(rows, cols)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("src,out", [
    ("uint8", (24, 24)), ("float32", (32, 48)), ("uint8", (16, 16))])
def test_normalize_resize_matches_plain(rng, src, out):
    img = (rng.integers(0, 256, (16, 16, 3)) if out == (16, 16)
           else rng.uniform(0, 255, (37, 53, 3))).astype(src)
    got = tnative.normalize_resize(img, *out, IMAGENET_MEAN_255,
                                   IMAGENET_STD_255)
    want = resize_bilinear_np(normalize_image(img), *out)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_remap_choose_matches_plain(rng):
    for shape in ((20, 20, 8, 8), (37, 90, 64, 64), (64, 64, 64, 64)):
        choose = rng.integers(0, shape[0] * shape[1], 500)
        np.testing.assert_array_equal(
            tnative.remap_choose(choose, *shape),
            remap_choose_to_resized(choose, *shape))


def test_decode_png_matches_pil(rng, tmp_path):
    arrays = [rng.integers(0, 256, (48, 64, 3)).astype(np.uint8),
              rng.integers(0, 256, (48, 64)).astype(np.uint8),
              rng.integers(0, 256, (20, 16, 4)).astype(np.uint8)]
    blobs = [_png(a) for a in arrays] + [
        _png(rng.integers(0, 22, (48, 64)).astype(np.uint8), True)]
    for data in blobs:
        got = tnative.decode_png(data)
        want = np.array(Image.open(io.BytesIO(data)))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    depth = rng.integers(0, 65535, (48, 64)).astype(np.uint16)
    path = tmp_path / "d.png"
    path.write_bytes(_png16(depth))
    got = tnative.decode_png_file(str(path))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)
    assert tnative.decode_png(b"not a png at all") is None


def test_color_jitter_matches_plain(rng):
    """Every op order and subset, and drawn factors, within 0.35 of the
    numpy ops in float64."""
    img = rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)
    factors = np.array([1.15, 0.85, 1.2, 0.04], np.float32)
    orders = list(itertools.permutations(range(4))) + [
        [], [1], [3], [1, 3], [3, 1], [0, 2], [3, 0, 1]]
    params = [(np.asarray(o, np.int32), factors) for o in orders] + [
        jitter_params(rng) for _ in range(8)]
    for ops, f in params:
        got = tnative.color_jitter(img, ops, f)
        want = apply_color_jitter(img.astype(np.float64), (ops, f))
        np.testing.assert_allclose(got, want, atol=0.35, err_msg=str(ops))


def test_label_scans_match_plain(rng):
    label, depth, f_label = _scene(rng)
    ids = [3, 7, 9]
    counts, bboxes = tnative.label_hist_bbox(label, depth)
    np.testing.assert_array_equal(
        tnative.label_depth_hist(label, depth)[1:], counts[1:])
    for i in range(1, 256):
        sel = label == i
        assert counts[i] == (sel & (depth != 0)).sum(), i
        if i in ids:
            rs, cs = np.nonzero(sel)
            assert tuple(bboxes[i]) == (rs.min(), rs.max() + 1, cs.min(),
                                        cs.max() + 1)
        else:
            assert tuple(bboxes[i]) == (-1, -1, -1, -1)

    keep = ~np.isin(f_label, [2, 4])
    out, front, n, counts2, bb2 = tnative.apply_front_hist_bbox(
        label, f_label, depth, 2, 4)
    np.testing.assert_array_equal(out, label * keep)
    np.testing.assert_array_equal(front, keep)
    assert n == ((label * keep) != 0).sum()
    c3, b3 = tnative.label_hist_bbox(label * keep, depth)
    np.testing.assert_array_equal(counts2, c3)
    np.testing.assert_array_equal(bb2, b3)
    o3, f3, n3 = tnative.apply_front(label, f_label, 2, 4)
    np.testing.assert_array_equal(o3, label * keep)
    np.testing.assert_array_equal(f3, keep)
    assert n3 == n

    ml, mv, box, cnt = tnative.object_mask(label, depth, 7)
    np.testing.assert_array_equal(ml, label == 7)
    np.testing.assert_array_equal(mv, (label == 7) & (depth != 0))
    assert box == tuple(bboxes[7]) and cnt == counts[7]
    assert tnative.object_mask(label, depth, 5)[2] is None
    np.testing.assert_array_equal(
        tnative.object_mask_window(label, depth, 7, 30, 85, 55, 105),
        mv[30:85, 55:105])


def test_compose_crop_matches_plain(rng):
    rgb, back, label, front, fmask = _crop_layers(rng)
    want = np.where((label == 0)[..., None], back, rgb)
    want = np.where(fmask.astype(bool)[..., None], want, front)
    np.testing.assert_array_equal(
        tnative.compose_crop(rgb, back, label, front, fmask), want)
    np.testing.assert_array_equal(
        tnative.compose_crop(rgb, back, label, None, None),
        np.where((label == 0)[..., None], back, rgb))
    np.testing.assert_array_equal(
        tnative.compose_crop(rgb, None, None, front, fmask),
        np.where(fmask.astype(bool)[..., None], rgb, front))
    with pytest.raises(ValueError):
        tnative.compose_crop(rgb, back, None, None, None)


def test_pixel_noise_matches_plain(rng):
    """The pool's noise is ``img + scale * pool[:n]`` in float32;
    the library's own draws are deterministic in the seed with N(0, 7)'s
    moments."""
    img = rng.uniform(0, 255, 999).astype(np.float32)
    pool = rng.standard_normal(2048).astype(np.float32)
    got = tnative.add_scaled(img.copy(), pool[7:], 3.0)
    np.testing.assert_array_equal(got, img + np.float32(3.0) * pool[7:1006])
    with pytest.raises(ValueError):
        tnative.add_scaled(img.copy(), pool[:100], 3.0)
    base = rng.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    a = tnative.gaussian_noise(base.copy(), 7.0, seed=123)
    np.testing.assert_array_equal(
        a, tnative.gaussian_noise(base.copy(), 7.0, seed=123))
    assert not np.array_equal(
        a, tnative.gaussian_noise(base.copy(), 7.0, seed=124))
    resid = (a - base).ravel()
    assert abs(resid.mean()) < 0.5 and 6.0 < resid.std() < 8.0


def test_choose_pixels_matches_plain_sampling():
    """Uniform without replacement (another RNG stream than the numpy
    path): sorted, unique mask pixels; wrap-padded like ``np.pad``."""
    mask = np.zeros((40, 40), np.uint8)
    mask[5:30, 5:30] = 1
    out = tnative.choose_pixels(mask, 100, seed=7)
    assert len(set(out.tolist())) == 100 and (np.diff(out) > 0).all()
    assert set(out.tolist()) <= set(np.flatnonzero(mask).tolist())
    few = np.zeros((10, 10), np.uint8)
    few[0, :5] = 1
    np.testing.assert_array_equal(
        tnative.choose_pixels(few, 12, seed=1),
        np.pad(np.flatnonzero(few), (0, 7), "wrap"))
    assert tnative.choose_pixels(few * 0, 8, 0) is None


# -- the build ---------------------------------------------------------------

def _copy_source(tmp_path, text=None):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "dfnative.cpp").write_text(
        text if text is not None
        else (build.CSRC / "dfnative.cpp").read_text())
    return csrc


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    csrc = _copy_source(tmp_path, "int df_version() { return 4 }\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*expected"):
        build.build_host(csrc, tmp_path / "build")
    assert list((tmp_path / "build").iterdir()) == []
    # native._load raises too: no quiet fallback to the numpy path
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative._load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.available()


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Four processes build into one directory at once, as xdist workers
    or torchrun ranks do at first use: each succeeds, one library remains,
    it loads and reports version 4."""
    csrc, out = _copy_source(tmp_path), tmp_path / "build"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=build.build_host, args=(csrc, out))
             for _ in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    path = build.host_library_path(csrc, out)
    assert [f.name for f in out.iterdir()] == [path.name]
    import ctypes
    assert ctypes.CDLL(str(path)).df_version() == 4


def test_host_digest_follows_the_source(tmp_path):
    csrc = _copy_source(tmp_path)
    first = build.host_library_path(csrc, tmp_path)
    assert first.name.startswith("libdfnative-") and first.parent == tmp_path
    assert build.host_library_path(csrc, tmp_path) == first
    (csrc / "dfnative.cpp").write_text(
        (csrc / "dfnative.cpp").read_text() + "// edited\n")
    assert build.host_library_path(csrc, tmp_path) != first
    assert build.host_library_path().parent == build.BUILD
