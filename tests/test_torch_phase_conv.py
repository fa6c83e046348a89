"""Port parity of the decoder's 3x3 VALID convolution (TPU kernel 6) and the
phase-conv decoder layers that run it.

The same numpy-seeded inputs go through the JAX package (its Pallas kernel
in interpret mode, as ``tests/test_phase_conv.py`` runs it, and its XLA
convolution) and the port's three routes: the plain version, the kernel
route (on the CPU its autograd Function runs the plain version) and the
library convolution. On the card the kernel itself is held to the plain
version (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The kernel's arithmetic (3xTF32: each float32 operand split into two TF32
parts, three tensor-core products per product) cannot run here; a torch
emulation of it is held to the JAX package's XLA convolution, and to a
float64 reference at the decoder's channel depths, where one TF32 product
alone is too coarse: that test is the written reason for the split.

Tolerance: rtol 1e-5 / atol 1e-5, the JAX kernel test's own, for the plain
and kernel routes and the emulation (float32, the same products summed in
another order).
The library route (oneDNN's blocked sums on the CPU) reaches 2e-5 absolute
on outputs of magnitude ~20 at Cin=256, and is held at atol 1e-4. The
layers compose the phase kernels and border corrections in another order
too, and are held at rtol 1e-4 / atol 1e-5 like ``test_torch_models.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from densefusion_tpu.models import layers as jlayers
from densefusion_tpu.ops.phase_conv import conv3x3_valid as jconv
from densefusion_tpu.ops.phase_conv import conv3x3_valid_xla
from densefusion_tpu_torch.models import layers
from densefusion_tpu_torch.ops import phase_conv

from tests.torch_port_util import to_np

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
LIBRARY_TOL = dict(rtol=1e-5, atol=1e-4)
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)

# tests/test_phase_conv.py's SHAPES: (B, h, w, Cin, Cout)
SHAPES = [
    (2, 8, 8, 16, 32),      # small, ragged channels
    (1, 24, 24, 64, 96),    # up-ish shape, sub-lane cout
    (2, 12, 10, 130, 5),    # cin > 1 lane, tiny cout
    (1, 5, 7, 3, 9),        # tiny odd map (stem-like channels)
    (1, 24, 24, 256, 256),  # lane-aligned (up2 phase shape at 1/4 channels)
]


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((b, h + 2, w + 2, cin)).astype(np.float32)
    pk = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    return xp, pk


@functools.lru_cache(maxsize=None)
def _jax_outputs(shape):
    """(Pallas kernel in interpret mode, XLA convolution) on ``shape``."""
    xp, pk = (jnp.asarray(a) for a in _inputs(shape))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jconv(xp, pk, backend="pallas"))
    return pallas, np.asarray(conv3x3_valid_xla(xp, pk))


ROUTES = {
    "plain": phase_conv.conv3x3_valid_plain,
    "kernel": functools.partial(phase_conv.conv3x3_valid, backend="kernel"),
    "library": phase_conv.conv3x3_valid_library,
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_matches_jax(route, shape):
    xp, pk = _inputs(shape)
    got = to_np(ROUTES[route](torch.from_numpy(xp), torch.from_numpy(pk)))
    pallas, xla = _jax_outputs(shape)
    assert got.shape == xla.shape
    tol = LIBRARY_TOL if route == "library" else CONV_TOL
    np.testing.assert_allclose(got, pallas, **tol)
    np.testing.assert_allclose(got, xla, **tol)


def test_auto_is_the_library_route():
    xp, pk = (torch.from_numpy(a) for a in _inputs(SHAPES[0]))
    assert torch.equal(phase_conv.conv3x3_valid(xp, pk),
                       phase_conv.conv3x3_valid_library(xp, pk))
    with pytest.raises(ValueError, match="backend"):
        phase_conv.conv3x3_valid(xp, pk, backend="pallas")


@pytest.mark.parametrize("device,route", [("cpu", "library"),
                                          ("cuda", "kernel"),
                                          ("cuda:1", "kernel")])
def test_auto_backend_by_device(device, route):
    """``"auto"`` is the kernel on the card (it measured faster than cuDNN's
    float32 convolution at the decoder's shapes) and the library elsewhere;
    the choice needs no card to be read."""
    assert phase_conv.auto_backend(torch.device(device)) == route


def test_auto_dispatches_to_the_resolved_route(monkeypatch):
    """``conv3x3_valid_nchw(..., "auto")`` runs the route ``auto_backend``
    names for the input's device: resolved to the kernel route, a CPU input
    runs the kernel's plain version."""
    xp, pk = (torch.from_numpy(a) for a in _inputs(SHAPES[2]))
    xp = xp.permute(0, 3, 1, 2).contiguous()
    seen = []

    def fake(device):
        seen.append(torch.device(device).type)
        return "kernel"

    monkeypatch.setattr(phase_conv, "auto_backend", fake)
    got = phase_conv.conv3x3_valid_nchw(xp, pk)
    assert seen == ["cpu"]
    assert torch.equal(got, phase_conv.conv3x3_valid_plain_nchw(xp, pk))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 stored mantissa bits) to nearest,
    ties away from zero, by bit mask: add half of the 13 dropped bits to the
    magnitude and clear them (``cvt.rna.tf32.f32``'s rounding, and the
    kernel's ``tf32_rna``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def conv_3xtf32(xp, pk):
    """The kernel's arithmetic through the nine-shift convolution: both
    operands split, hi*lo + lo*hi + hi*hi, lo*lo dropped. The products of
    two TF32 numbers are exact in float32; they are summed in float64 (the
    kernel sums all three into one float32 sum per output, so three float32
    sums would add roundings it does not make). float64 result."""
    (xh, xl), (wh, wl) = split_tf32(xp), split_tf32(pk)

    def conv(a, b):
        return phase_conv.conv3x3_valid_plain_nchw(a.double(), b.double())

    return conv(xh, wl) + conv(xl, wh) + conv(xh, wh)


def test_tf32_rna_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4000)
         * 10.0 ** rng.integers(-20, 20, 4000)).astype(np.float32)
    # exact ties: 11 significant bits and a half, both signs
    ties = np.ldexp(np.arange(1024, 2048) + 0.5, -7).astype(np.float32)
    x = np.concatenate([x, ties, -ties])
    m, e = np.frexp(np.abs(x.astype(np.float64)))   # |x| = m 2^e, m in [.5, 1)
    want = np.sign(x) * np.floor(m * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), want)
    hi, lo = split_tf32(torch.from_numpy(x))
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_3xtf32_emulation_matches_jax(shape):
    xp, pk = _inputs(shape)
    got = conv_3xtf32(torch.from_numpy(xp).permute(0, 3, 1, 2),
                      torch.from_numpy(pk)).float()
    _, xla = _jax_outputs(shape)
    np.testing.assert_allclose(to_np(got.permute(0, 2, 3, 1)), xla,
                               **CONV_TOL)


# the decoder's three phase convolutions at B=1 (192 px crops), Cout cut to
# 64 to keep the float64 reference cheap: (h = w, Cin)
DECODER_DEPTHS = [(24, 1024), (48, 256), (96, 64)]


@pytest.mark.parametrize("hw,cin", DECODER_DEPTHS, ids=str)
def test_3xtf32_keeps_float32_accuracy(hw, cin):
    """Against a float64 reference, the emulation's sums in float64 so
    that only the split shows: 3xTF32 stays within 1e-6 of the largest
    output; one TF32 product (hi*hi) misses the 1e-4 gate of
    ``chip_smoke.py`` [3d]. Weights scaled by 1/sqrt(9 Cin), as in
    ``chip_smoke.conv_cases``."""
    rng = np.random.default_rng(6)
    xp = torch.from_numpy(rng.standard_normal(
        (1, cin, hw + 2, hw + 2)).astype(np.float32))
    pk = torch.from_numpy((rng.standard_normal((3, 3, cin, 64))
                           / np.sqrt(9 * cin)).astype(np.float32))
    want = phase_conv.conv3x3_valid_plain_nchw(xp.double(), pk.double())
    scale = float(want.abs().max())
    err3 = float((conv_3xtf32(xp, pk) - want).abs().max())
    one = phase_conv.conv3x3_valid_plain_nchw(tf32_rna(xp).double(),
                                              tf32_rna(pk).double())
    err1 = float((one - want).abs().max())
    assert err3 <= 1e-6 * scale
    assert err1 > 1e-4 * scale


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (1, 12, 10, 130, 5)],
                         ids=str)
def test_gradients(shape, layout):
    """The kernel route's input and weight gradients are the library
    route's, bit for bit (its backward is the library's), and agree with
    ``jax.grad`` of the JAX kernel's custom VJP."""
    xp, pk = _inputs(shape)
    b, h, w, _, cout = shape
    g = np.random.default_rng(1).standard_normal(
        (b, h, w, cout)).astype(np.float32)

    def port_grads(backend):
        x = torch.from_numpy(xp)
        if layout == "nchw":
            x = x.permute(0, 3, 1, 2).contiguous()
        x.requires_grad_(True)
        k = torch.from_numpy(pk).requires_grad_(True)
        if layout == "nchw":
            y = phase_conv.conv3x3_valid_nchw(x, k, backend)
            y = y.permute(0, 2, 3, 1)
        else:
            y = phase_conv.conv3x3_valid(x, k, backend)
        (y * torch.from_numpy(g)).sum().backward()
        gx = x.grad.permute(0, 2, 3, 1) if layout == "nchw" else x.grad
        return to_np(gx), to_np(k.grad)

    gx_k, gk_k = port_grads("kernel")
    gx_l, gk_l = port_grads("library")
    np.testing.assert_array_equal(gx_k, gx_l)
    np.testing.assert_array_equal(gk_k, gk_l)

    def loss(x, k):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jconv(x, k, backend="pallas") * g)

    jgx, jgk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp),
                                              jnp.asarray(pk))
    np.testing.assert_allclose(gx_k, np.asarray(jgx), **CONV_TOL)
    np.testing.assert_allclose(gk_k, np.asarray(jgk), **CONV_TOL)


def _layer_inputs(h, w, cin=6, cout=5, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / cin).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    port = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
            torch.from_numpy(bias))
    return (jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)), port


@pytest.mark.parametrize("backend", ["library", "kernel"])
def test_phase_conv_phases(backend):
    jargs, args = _layer_inputs(5, 7)
    want = jlayers.phase_conv_phases(*jargs)
    got = layers.phase_conv_phases(*args, conv_backend=backend)
    np.testing.assert_allclose(to_np(got).transpose(0, 2, 3, 1),
                               np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("backend", ["library", "kernel"])
@pytest.mark.parametrize("border", ["zero", "replicate"])
@pytest.mark.parametrize("hw", [(5, 5), (6, 4), (1, 3)], ids=str)
def test_phase_upsample_conv3x3(hw, border, backend):
    """Both borders, both routes, square, oblong and one-row maps (where the
    top and bottom ring corrections meet)."""
    jargs, args = _layer_inputs(*hw)
    want = jlayers.phase_upsample_conv3x3(*jargs, border=border)
    got = layers.phase_upsample_conv3x3(*args, border=border,
                                        conv_backend=backend)
    np.testing.assert_allclose(to_np(got).transpose(0, 2, 3, 1),
                               np.asarray(want), **LAYER_TOL)


def test_zero_border_equals_dense_zero_padded_conv():
    """The zero border's ring corrections give exactly the dense
    ``conv3x3(zero_pad(upsample2x(x)))``."""
    _, (x, k, bias) = _layer_inputs(6, 5)
    up = layers.resize_bilinear(x, (12, 10))
    want = torch.nn.functional.conv2d(up, k, bias, padding=1)
    got = layers.phase_upsample_conv3x3(x, k, bias, border="zero")
    np.testing.assert_allclose(to_np(got), to_np(want), **LAYER_TOL)


def test_layer_gradients_kernel_equals_library():
    """Through a whole zero-border stage, the kernel route's gradients are
    the library route's, bit for bit (a linear loss, so both backward passes
    start from the same cotangent)."""
    _, args = _layer_inputs(4, 5)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, 8, 10)).astype(np.float32))
    grads = {}
    for backend in ("library", "kernel"):
        x, k, bias = (a.clone().requires_grad_(True) for a in args)
        (layers.phase_upsample_conv3x3(x, k, bias, border="zero",
                                       conv_backend=backend) * g).sum() \
            .backward()
        grads[backend] = [a.grad for a in (x, k, bias)]
    for a, b in zip(grads["kernel"], grads["library"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("xp_shape,pk_shape,dtype,match", [
    ((1, 3, 6, 6), (3, 3, 3, 4), torch.float32, "CUDA"),
    ((1, 3, 6, 6), (3, 3, 3, 4), torch.float64, "float32"),
    ((1, 3, 6, 6), (3, 3, 2, 4), torch.float32, "pk"),
    ((3, 6, 6), (3, 3, 3, 4), torch.float32, "rank-4"),
], ids=["cpu-tensor", "float64", "channel-mismatch", "rank-3"])
def test_kernel_wrapper_refuses(xp_shape, pk_shape, dtype, match):
    """The wrapper launches or raises: CPU tensors, other dtypes and wrong
    shapes raise, and the launch count stays unchanged."""
    kernel = phase_conv.phase_conv_kernel
    before = kernel.launches
    with pytest.raises(ValueError, match=match):
        kernel(torch.zeros(xp_shape, dtype=dtype),
               torch.zeros(pk_shape, dtype=dtype))
    assert kernel.launches == before


def test_kernel_wrapper_refuses_non_contiguous():
    xp = torch.zeros((1, 6, 6, 3)).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        phase_conv.phase_conv_kernel(xp, torch.zeros((3, 3, 3, 4)))


# ---------------------------------------------------------------------------
# The bf16 kernel's channels-last map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_bf16_same_on_channels_last_map(shape):
    """The plain version gives bit-identical bf16 results on a channels-last
    and on a contiguous NCHW map of the same values: the bf16 kernel's
    layout changes no number that the card's checks hold it to."""
    xp, pk = _inputs(shape)
    x = torch.from_numpy(np.ascontiguousarray(xp.transpose(0, 3, 1, 2))) \
        .to(torch.bfloat16)
    k = torch.from_numpy(pk).to(torch.bfloat16)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    assert x_cl.is_contiguous(memory_format=torch.channels_last) \
        and not x_cl.is_contiguous()
    want = phase_conv.conv3x3_valid_plain_nchw(x, k)
    got = phase_conv.conv3x3_valid_plain_nchw(x_cl, k)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("dtype,backend,channels_last", [
    (torch.bfloat16, "kernel", True),     # the bf16 kernel's layout
    (torch.bfloat16, "library", False),   # F.pad's map, as before
    (torch.float32, "kernel", False),     # the float32 decoder's map,
    (torch.float32, "library", False),    # unchanged
], ids=["bf16-kernel", "bf16-library", "f32-kernel", "f32-library"])
def test_phase_conv_phases_hands_the_route_its_layout(
        monkeypatch, dtype, backend, channels_last):
    """``phase_conv_phases`` pads in the layout its route takes: the bf16
    kernel route gets a channels-last map (written so in the pad's one
    copy), every other route F.pad's contiguous map; the values are F.pad's
    replicate border in every case, and so is the layer's output."""
    _, (x, k, bias) = _layer_inputs(5, 7)
    x, k, bias = x.to(dtype), k.to(dtype), bias.to(dtype)
    seen = []

    def spy(xp, pk, conv_backend="auto"):
        seen.append(xp)
        return phase_conv.conv3x3_valid_nchw(xp, pk, conv_backend)

    want = layers.phase_conv_phases(x, k, bias, conv_backend=backend)
    monkeypatch.setattr(layers, "conv3x3_valid_nchw", spy)
    got = layers.phase_conv_phases(x, k, bias, conv_backend=backend)
    (xp,) = seen
    ref = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="replicate")
    assert torch.equal(xp, ref) and torch.equal(got, want)
    assert xp.is_contiguous(memory_format=torch.channels_last) \
        == channels_last
    assert xp.is_contiguous() != channels_last
    assert torch.equal(phase_conv.replicate_pad(x, backend), ref)


def test_bf16_kernel_wrapper_refuses_nchw_map():
    """The bf16 kernel's wrapper checks the map's layout before anything
    else: an NCHW-contiguous bf16 map raises for its layout, a
    channels-last one passes that check and is refused only for lying on
    the CPU; nothing launches."""
    kernel = phase_conv.phase_conv_bf16_kernel
    before = kernel.launches
    xp = torch.zeros((2, 16, 10, 12), dtype=torch.bfloat16)
    pk = torch.zeros((3, 3, 16, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        kernel(xp, pk)
    with pytest.raises(ValueError, match="CUDA"):
        kernel(xp.contiguous(memory_format=torch.channels_last), pk)
    assert kernel.launches == before
    assert kernel.layout == torch.channels_last
    assert phase_conv.phase_conv_kernel.layout == torch.contiguous_format
