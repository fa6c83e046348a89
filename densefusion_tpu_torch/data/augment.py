"""Image / cloud augmentations (host-side, explicitly seeded; counterpart
of ``densefusion_tpu/data/augment.py``).

Equivalents of the reference's torchvision augmentations: ColorJitter
(0.2, 0.2, 0.2, 0.05) on every training frame, uniform translation noise on
cloud and target, additive gaussian pixel noise on synthetic frames. Every
function takes an explicit ``np.random.Generator``, so runs are
reproducible and the data order can be checkpointed. Jitter and pixel
noise run in the host library (:mod:`densefusion_tpu_torch.native`); the
numpy code is their plain version.
"""

from __future__ import annotations

import functools

import numpy as np

from densefusion_tpu_torch import native


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return a * f + b * (1.0 - f)


def _grayscale(img: np.ndarray) -> np.ndarray:
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return g[..., None]


def _rgb_to_hsv(img: np.ndarray):
    img = np.asarray(img, np.float32)
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    dd = np.maximum(delta, 1e-12)
    h = np.where(maxc == r, (g - b) / dd % 6.0,
                 np.where(maxc == g, (b - r) / dd + 2.0, (r - g) / dd + 4.0))
    h = np.where(delta == 0, 0.0, h) / 6.0
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    rgb = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)],
    )
    return rgb


def jitter_params(rng: np.random.Generator, brightness: float = 0.2,
                  contrast: float = 0.2, saturation: float = 0.2,
                  hue: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
    """Draw ColorJitter factors and their order once: returns (ops,
    factors), ``ops`` the op ids in application order (0 brightness, 1
    contrast, 2 saturation, 3 hue) and ``factors[op_id]`` the drawn factor
    (for hue, the shift)."""
    kinds = []
    factors = np.ones(4, np.float32)
    if brightness:
        factors[0] = rng.uniform(1 - brightness, 1 + brightness)
        kinds.append(0)
    if contrast:
        factors[1] = rng.uniform(1 - contrast, 1 + contrast)
        kinds.append(1)
    if saturation:
        factors[2] = rng.uniform(1 - saturation, 1 + saturation)
        kinds.append(2)
    if hue:
        factors[3] = rng.uniform(-hue, hue)
        kinds.append(3)
    ops = np.asarray(kinds, np.int32)[rng.permutation(len(kinds))]
    return ops, factors


def apply_color_jitter(img: np.ndarray,
                       params: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """Apply drawn jitter params to a (H, W, 3) image in 0-255 range ->
    float32 in 0-255; a uint8 image takes the library's fused pass (float32
    HSV; within 0.35 of the numpy ops)."""
    ops, factors = params
    if img.dtype == np.uint8 and native.available():
        return native.color_jitter(img, ops, factors)
    img = np.asarray(img, np.float32)
    for k in ops:
        if k == 0:
            img = img * factors[0]
        elif k == 1:
            img = _blend(img, np.full_like(img, _grayscale(img).mean()),
                         factors[1])
        elif k == 2:
            img = _blend(img, np.broadcast_to(_grayscale(img), img.shape),
                         factors[2])
        else:
            h, s, v = _rgb_to_hsv(img * np.float32(1 / 255.0))
            img = _hsv_to_rgb((h + factors[3]) % 1.0, s, v) * np.float32(255.0)
    return np.clip(img, 0.0, 255.0)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.05) -> np.ndarray:
    """torchvision ColorJitter equivalent on a (H, W, 3) uint8/float image in
    0-255 range; factors drawn uniformly, ops applied in random order."""
    return apply_color_jitter(
        img, jitter_params(rng, brightness, contrast, saturation, hue))


def translation_noise(rng: np.random.Generator, noise_trans: float) -> np.ndarray:
    """Uniform per-axis translation jitter added to BOTH the cloud and the
    target: the pose label moves with the input, so this augments the
    viewpoint, not the label."""
    return rng.uniform(-noise_trans, noise_trans, size=3).astype(np.float32)


_NOISE_POOL_BITS = 21  # 2^21 N(0,1) floats (8 MB), more than a frame window


@functools.cache
def _noise_pool() -> np.ndarray:
    """The fixed, read-only N(0, 1) pool of the library's pixel noise,
    drawn once per process from the JAX package's seed."""
    pool = np.random.default_rng(0x6E6F6973).standard_normal(
        1 << _NOISE_POOL_BITS).astype(np.float32)
    pool.setflags(write=False)
    return pool


def gaussian_pixel_noise(img: np.ndarray, rng: np.random.Generator,
                         scale: float = 7.0,
                         seed: int | None = None) -> np.ndarray:
    """Additive N(0, scale) pixel noise (synthetic YCB frames). With
    ``seed`` and the library: a slice of the fixed pool at offset ``seed %
    (pool.size - img.size + 1)`` scaled in, or, for images larger than the
    pool, the library's own draws from ``seed``; in place where ``img`` is a
    writable contiguous float32 array. Otherwise drawn from ``rng``."""
    if seed is not None and native.available():
        arr = np.asarray(img)
        if not (arr.dtype == np.float32 and arr.flags.c_contiguous
                and arr.flags.writeable):
            arr = arr.astype(np.float32, copy=True)
        pool = _noise_pool()
        if arr.size < pool.size:
            off = seed % (pool.size - arr.size + 1)
            return native.add_scaled(arr, pool[off:], scale)
        return native.gaussian_noise(arr, scale, seed)
    return np.asarray(img, np.float32) + rng.normal(0.0, scale, img.shape)


def resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) image, half-pixel convention, pure
    numpy."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h - 0.5, 0, h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)
