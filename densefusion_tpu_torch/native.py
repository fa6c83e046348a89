"""ctypes bindings for the port's host data-plane library
(``csrc/dfnative.cpp``; counterpart of ``densefusion_tpu/native.py``).

The library is built with ``g++`` by :func:`densefusion_tpu_torch.ops.build.
build_host` at first use, into the package's ``build/``, and loaded once per
process. It is the readers' default path: ``data/common.py`` routes
back-projection, the fused normalize + resize and the ``choose`` remap
through it, ``data/cache.py`` PNG decode, ``data/augment.py`` color jitter
and pixel noise, ``data/ycb.py`` occluder compositing and the label scans.
A failed build raises; there is no quiet fallback. The numpy code beside
each call is the plain version, taken only where ``_load`` is switched off
on purpose (the tests patch it to return None). ``choose_pixels``
(reservoir sampling) is bound but not wired in: its RNG stream differs from
the readers' per-sample generators.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from densefusion_tpu_torch.ops import build

_lock = threading.Lock()
_lib = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)

VERSION = 4     # df_version() of csrc/dfnative.cpp

_SIGNATURES = {
    "df_version": (ctypes.c_int, []),
    "df_choose_pixels": (ctypes.c_int64, [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _i64p]),
    "df_backproject": (None, [
        _f32p, _i64p, _i64p, ctypes.c_int64] + [ctypes.c_float] * 6
        + [_f32p]),
    "df_normalize_resize": (None, [
        _u8p, ctypes.c_int64, ctypes.c_int64, _f32p, ctypes.c_int64,
        ctypes.c_int64, _f32p, _f32p]),
    "df_normalize_resize_f32": (None, [
        _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, ctypes.c_int64,
        ctypes.c_int64, _f32p, _f32p]),
    "df_remap_choose": (None, [
        _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _i64p]),
    "df_png_info": (ctypes.c_int, [
        _u8p, ctypes.c_int64, _i64p, _i64p, _i64p, _i64p]),
    "df_png_decode": (ctypes.c_int, [_u8p, ctypes.c_int64, _u8p]),
    "df_color_jitter": (None, [
        _u8p, ctypes.c_int64, ctypes.c_int64, _i32p, ctypes.c_int64,
        _f32p, _f32p]),
    "df_gaussian_noise": (None, [
        _f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_uint64]),
    "df_label_hist_bbox": (None, [
        _u8p, _u16p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p]),
    "df_apply_front_hist_bbox": (ctypes.c_int64, [
        _u8p, _u8p, _u16p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _u8p, _u8p, _i64p, _i64p]),
    "df_object_mask_window": (None, [_u8p, _u16p] + [ctypes.c_int64] * 6
                              + [_u8p]),
    "df_add_scaled": (None, [
        _f32p, ctypes.c_int64, _f32p, ctypes.c_float]),
    "df_label_depth_hist": (None, [
        _u8p, _u16p, ctypes.c_int64, _i64p]),
    "df_apply_front": (ctypes.c_int64, [
        _u8p, _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _u8p, _u8p]),
    "df_object_mask": (ctypes.c_int64, [
        _u8p, _u16p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _u8p, _u8p, _i64p]),
    "df_compose_crop": (None, [
        _u8p, _u8p, _u8p, _u8p, _u8p, ctypes.c_int64, _u8p]),
}


def _load():
    """The loaded library, built first if this checkout has none yet.
    Raises if ``g++`` fails or the library is not version 4."""
    global _lib
    with _lock:
        if _lib is None:
            path = build.host_library_path()
            if not path.exists():
                build.build_host()
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            if lib.df_version() != VERSION:
                raise RuntimeError(f"{path}: df_version() is "
                                   f"{lib.df_version()}, want {VERSION}")
            _lib = lib
        return _lib


def available() -> bool:
    """True, once the library is loaded (building it first if needed);
    False only where ``_load`` is switched off on purpose. The other
    probes below are the JAX module's names for its library versions; the
    port builds version 4, so they answer as ``available``."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctype)


def choose_pixels(mask: np.ndarray, num_points: int,
                  seed: int) -> np.ndarray | None:
    """Native counterpart of ``data.common.choose_mask_pixels`` (uniform
    without replacement too, from another RNG stream); None for an empty
    mask."""
    lib = _load()
    mask_u8 = np.ascontiguousarray(mask.reshape(-1), dtype=np.uint8)
    out = np.empty(num_points, np.int64)
    found = lib.df_choose_pixels(
        _ptr(mask_u8, _u8p), mask_u8.size, num_points,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), _ptr(out, _i64p))
    if found == 0:
        return None
    return out


def backproject(depth: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                fx: float, fy: float, cx: float, cy: float,
                depth_scale: float, unit_scale: float = 1.0) -> np.ndarray:
    """(n,) depths at pixels (rows, cols) -> (n, 3) float32 points."""
    lib = _load()
    d = np.ascontiguousarray(depth, np.float32)
    r = np.ascontiguousarray(rows, np.int64)
    c = np.ascontiguousarray(cols, np.int64)
    if not (d.ndim == r.ndim == c.ndim == 1 and d.size == r.size == c.size):
        raise ValueError(f"backproject: depth, rows and cols must be 1-D of "
                         f"one length, got {d.shape}, {r.shape}, {c.shape}")
    out = np.empty((d.size, 3), np.float32)
    lib.df_backproject(_ptr(d, _f32p), _ptr(r, _i64p), _ptr(c, _i64p),
                       d.size, fx, fy, cx, cy, depth_scale, unit_scale,
                       _ptr(out, _f32p))
    return out


def normalize_resize(img: np.ndarray, out_h: int, out_w: int,
                     mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8/float -> normalized resized (out_h, out_w, 3) f32."""
    lib = _load()
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"normalize_resize: want (h, w, 3), got {img.shape}")
    h, w = img.shape[:2]
    out = np.empty((out_h, out_w, 3), np.float32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    if img.dtype == np.uint8:
        src = np.ascontiguousarray(img)
        lib.df_normalize_resize(_ptr(src, _u8p), h, w, _ptr(out, _f32p),
                                out_h, out_w, _ptr(mean32, _f32p),
                                _ptr(std32, _f32p))
    else:
        src = np.ascontiguousarray(img, np.float32)
        lib.df_normalize_resize_f32(_ptr(src, _f32p), h, w, _ptr(out, _f32p),
                                    out_h, out_w, _ptr(mean32, _f32p),
                                    _ptr(std32, _f32p))
    return out


def remap_choose(choose: np.ndarray, crop_h: int, crop_w: int,
                 out_h: int, out_w: int) -> np.ndarray:
    """Flat crop indices -> the nearest indices of the resized crop."""
    lib = _load()
    ch = np.ascontiguousarray(choose, np.int64)
    out = np.empty_like(ch)
    lib.df_remap_choose(_ptr(ch, _i64p), ch.size, crop_h, crop_w, out_h,
                        out_w, _ptr(out, _i64p))
    return out


def decode_supported() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "df_png_decode")


# palette (3) decodes to raw indices, matching np.array(PIL P-mode image)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray | None:
    """Decode a PNG byte string to (h, w[, c]) uint8, or uint16 for 16-bit
    gray depth maps. None for formats the decoder does not take (the
    caller falls back to PIL). Palette images decode to their indices, as
    ``np.array`` of PIL's P-mode image."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int64()
    h = ctypes.c_int64()
    depth = ctypes.c_int64()
    ctype = ctypes.c_int64()
    rc = lib.df_png_info(_ptr(buf, _u8p), buf.size, ctypes.byref(w),
                         ctypes.byref(h), ctypes.byref(depth),
                         ctypes.byref(ctype))
    if rc != 0:
        return None
    channels = _PNG_CHANNELS.get(ctype.value)
    if channels is None:
        return None
    if depth.value == 16:
        if ctype.value != 0:
            return None
        out = np.empty((h.value, w.value), np.uint16)
    else:
        shape = (h.value, w.value) if channels == 1 \
            else (h.value, w.value, channels)
        out = np.empty(shape, np.uint8)
    rc = lib.df_png_decode(_ptr(buf, _u8p), buf.size,
                           out.ctypes.data_as(_u8p))
    if rc != 0:
        return None
    return out


def decode_png_file(path: str) -> np.ndarray | None:
    with open(path, "rb") as f:
        return decode_png(f.read())


# op ids for df_color_jitter (order of data/augment.py's ops list)
JITTER_BRIGHTNESS, JITTER_CONTRAST, JITTER_SATURATION, JITTER_HUE = 0, 1, 2, 3


def color_jitter(img: np.ndarray, ops: np.ndarray,
                 factors: np.ndarray) -> np.ndarray:
    """Fused ColorJitter on a (h, w, 3) uint8 crop; ``ops`` is the op-id
    application order, ``factors[op_id]`` the drawn factor (hue: shift)."""
    lib = _load()
    src = np.ascontiguousarray(img, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"color_jitter: want (h, w, 3), got {src.shape}")
    h, w = src.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    ops32 = np.ascontiguousarray(ops, np.int32)
    f32 = np.ascontiguousarray(factors, np.float32)
    if f32.size != 4 or ((ops32 < 0) | (ops32 > 3)).any():
        raise ValueError("color_jitter: want 4 factors and op ids in 0-3")
    lib.df_color_jitter(_ptr(src, _u8p), h, w, _ptr(ops32, _i32p), ops32.size,
                        _ptr(f32, _f32p), _ptr(out, _f32p))
    return out


def gaussian_noise(img: np.ndarray, scale: float, seed: int) -> np.ndarray:
    """In-place additive N(0, scale) noise on a float32 array."""
    lib = _load()
    arr = np.ascontiguousarray(img, np.float32)
    lib.df_gaussian_noise(_ptr(arr, _f32p), arr.size,
                          ctypes.c_float(scale),
                          ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF))
    return arr


def loader_kernels_supported() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "df_label_depth_hist")


def label_depth_hist(label: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Per-label-value count of nonzero-depth pixels -> (256,) int64."""
    lib = _load()
    lab = np.ascontiguousarray(label.reshape(-1), np.uint8)
    dep = np.ascontiguousarray(depth.reshape(-1), np.uint16)
    _same_size(lab, dep)
    counts = np.empty(256, np.int64)
    lib.df_label_depth_hist(_ptr(lab, _u8p), _ptr(dep, _u16p), lab.size,
                            _ptr(counts, _i64p))
    return counts


def apply_front(label: np.ndarray, f_label: np.ndarray, id0: int, id1: int
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Zero the label under two occluder objects of ``f_label``; returns
    (new_label, front_mask(bool), surviving_count)."""
    lib = _load()
    lab = np.ascontiguousarray(label, np.uint8)
    fl = np.ascontiguousarray(f_label, np.uint8)
    _same_size(lab, fl)
    out = np.empty_like(lab)
    front = np.empty(lab.shape, np.uint8)
    count = lib.df_apply_front(_ptr(lab, _u8p), _ptr(fl, _u8p), lab.size,
                               id0, id1, _ptr(out, _u8p), _ptr(front, _u8p))
    return out, front.view(bool), int(count)


def object_mask(label: np.ndarray, depth: np.ndarray, obj_id: int
                ) -> tuple[np.ndarray, np.ndarray, tuple | None, int]:
    """One-pass (label==id) mask, depth-valid mask, tight bbox
    (rmin, rmax_excl, cmin, cmax_excl) and valid-pixel count."""
    lib = _load()
    h, w = label.shape
    lab = np.ascontiguousarray(label, np.uint8)
    dep = np.ascontiguousarray(depth, np.uint16)
    _same_size(lab, dep)
    mask_label = np.empty((h, w), np.uint8)
    mask_valid = np.empty((h, w), np.uint8)
    bbox = np.empty(4, np.int64)
    count = lib.df_object_mask(_ptr(lab, _u8p), _ptr(dep, _u16p), h, w,
                               obj_id, _ptr(mask_label, _u8p),
                               _ptr(mask_valid, _u8p), _ptr(bbox, _i64p))
    box = None if bbox[0] < 0 else (int(bbox[0]), int(bbox[1]),
                                    int(bbox[2]), int(bbox[3]))
    return mask_label.view(bool), mask_valid.view(bool), box, int(count)


def fused_scan_supported() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "df_label_hist_bbox")


def _same_size(*arrs: np.ndarray) -> None:
    if len({a.shape for a in arrs}) != 1:
        raise ValueError(f"want arrays of one shape, got "
                         f"{[a.shape for a in arrs]}")


def _unpack_bboxes(bbox: np.ndarray) -> np.ndarray:
    """(256, 4) int64 per-id (rmin, rmax_excl, cmin, cmax_excl); rows of -1
    mean the id never appears."""
    return bbox.reshape(256, 4)


def label_hist_bbox(label: np.ndarray, depth: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """One pass: per-id depth-valid pixel counts (256,) AND per-id tight
    bboxes (256, 4) of the label image."""
    lib = _load()
    h, w = label.shape
    lab = np.ascontiguousarray(label, np.uint8)
    dep = np.ascontiguousarray(depth, np.uint16)
    _same_size(lab, dep)
    counts = np.empty(256, np.int64)
    bbox = np.empty(256 * 4, np.int64)
    lib.df_label_hist_bbox(_ptr(lab, _u8p), _ptr(dep, _u16p), h, w,
                           _ptr(counts, _i64p), _ptr(bbox, _i64p))
    return counts, _unpack_bboxes(bbox)


def apply_front_hist_bbox(label: np.ndarray, f_label: np.ndarray,
                          depth: np.ndarray, id0: int, id1: int
                          ) -> tuple[np.ndarray, np.ndarray, int,
                                     np.ndarray, np.ndarray]:
    """apply_front + label_hist_bbox fused into one frame pass: returns
    (new_label, front_mask(bool), surviving_count, counts, bboxes)."""
    lib = _load()
    h, w = label.shape
    lab = np.ascontiguousarray(label, np.uint8)
    fl = np.ascontiguousarray(f_label, np.uint8)
    dep = np.ascontiguousarray(depth, np.uint16)
    _same_size(lab, fl, dep)
    out = np.empty_like(lab)
    front = np.empty(lab.shape, np.uint8)
    counts = np.empty(256, np.int64)
    bbox = np.empty(256 * 4, np.int64)
    count = lib.df_apply_front_hist_bbox(
        _ptr(lab, _u8p), _ptr(fl, _u8p), _ptr(dep, _u16p), h, w, id0, id1,
        _ptr(out, _u8p), _ptr(front, _u8p), _ptr(counts, _i64p),
        _ptr(bbox, _i64p))
    return out, front.view(bool), int(count), counts, _unpack_bboxes(bbox)


def object_mask_window(label: np.ndarray, depth: np.ndarray, obj_id: int,
                       r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
    """Depth-valid (label == id) mask of the [r0:r1, c0:c1] window only."""
    lib = _load()
    lab = np.ascontiguousarray(label, np.uint8)
    dep = np.ascontiguousarray(depth, np.uint16)
    _same_size(lab, dep)
    h, w = lab.shape
    if not (0 <= r0 <= r1 <= h and 0 <= c0 <= c1 <= w):
        raise ValueError(f"object_mask_window: window [{r0}:{r1}, {c0}:{c1}]"
                         f" outside the {h}x{w} frame")
    out = np.empty((r1 - r0, c1 - c0), np.uint8)
    lib.df_object_mask_window(_ptr(lab, _u8p), _ptr(dep, _u16p),
                              w, r0, r1, c0, c1, obj_id, _ptr(out, _u8p))
    return out.view(bool)


def add_scaled(img: np.ndarray, pool: np.ndarray, scale: float) -> np.ndarray:
    """In place ``img += scale * pool[:img.size]`` on float32 buffers (the
    noise pool's path; ``img`` a writable contiguous f32 array, ``pool`` a
    contiguous f32 view of at least ``img.size``)."""
    lib = _load()
    for name, a in (("img", img), ("pool", pool)):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            raise ValueError(f"add_scaled: {name} must be contiguous float32")
    if not img.flags.writeable or pool.size < img.size:
        raise ValueError("add_scaled: img must be writable and pool hold at "
                         "least img.size values")
    lib.df_add_scaled(_ptr(img, _f32p), img.size, _ptr(pool, _f32p),
                      ctypes.c_float(scale))
    return img


def compose_crop(rgb: np.ndarray, back: np.ndarray | None,
                 label: np.ndarray | None, front: np.ndarray | None,
                 front_mask: np.ndarray | None) -> np.ndarray:
    """Fused window compositing: back behind label==0, front where
    front_mask==0. All inputs are (h, w, 3)/(h, w) uint8 crop windows;
    ``back`` comes with ``label`` and ``front`` with ``front_mask``."""
    lib = _load()
    src = np.ascontiguousarray(rgb, np.uint8)
    n = src.shape[0] * src.shape[1]
    out = np.empty_like(src)
    if (back is None) != (label is None) or \
            (front is None) != (front_mask is None):
        raise ValueError("compose_crop: back needs label, front needs "
                         "front_mask")

    def u8(arr, shape):
        if arr is None:
            return None
        arr = np.ascontiguousarray(arr, np.uint8)
        if arr.shape != shape:
            raise ValueError(f"compose_crop: want {shape}, got {arr.shape}")
        return arr

    # contiguous copies, kept alive through the call
    back_c, front_c = u8(back, src.shape), u8(front, src.shape)
    label_c, fm_c = u8(label, src.shape[:2]), u8(front_mask, src.shape[:2])
    lib.df_compose_crop(*(ctypes.cast(None, _u8p) if a is None
                          else _ptr(a, _u8p)
                          for a in (src, back_c, label_c, front_c, fm_c)),
                        n, _ptr(out, _u8p))
    return out
