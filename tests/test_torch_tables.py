"""The model step's constant tables (``models/layers.py`` ``table``).

The PSP priors' resize weights and the decoder's upsample taps are built
on their device once per key and reused, so a warm forward copies nothing
from the host. Held here on the CPU:

* every table equals ``like.new_tensor(build(...))``, which each call
  made before the cache, bit for bit in float32, bf16 and float16, and
  the numpy table cast to the type on its own;
* a repeated key is a hit; another size, type, device or builder is a
  miss (``device_table.cache_info()``);
* PSPNet under every decoder gives bitwise the same output on its first
  call (misses) and its second (hits only, as many as a forward has
  tables); PoseNet's outputs and gradients, float32 and bf16, are bitwise
  those of tables made anew at each call;
* a table first made under ``torch.inference_mode`` serves a forward that
  records gradients; ``torch.compile`` stores nothing while it traces;
  ``quat_conjugate`` (no table at all now) gives ``q * [1, -1, -1, -1]``.

The export round trip is in ``tests/test_torch_export.py``. The card's
side, that no forward, pipeline call or phase-1 step synchronises, is
``tests/test_torch_cuda.py::test_model_step_issues_no_sync``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

from densefusion_tpu_torch.geometry import quat_conjugate
from densefusion_tpu_torch.models import PoseNet, layers
from densefusion_tpu_torch.models.pspnet import PSPNet

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _fresh(like, build, *args):
    """A table made anew at each call: what every forward did before the
    cache."""
    return like.new_tensor(build(*args))


@pytest.fixture
def tables():
    """The model step's cache, emptied and its counts zeroed."""
    layers.device_table.cache_clear()
    yield layers.device_table
    layers.device_table.cache_clear()


def _counts(cache):
    info = cache.cache_info()
    return info.hits, info.misses


def _stored(like, build, *args):
    """The stored table of a key that a test made (a hit, no miss)."""
    misses = layers.device_table.cache_info().misses
    t = layers.table(like, build, *args)
    assert layers.device_table.cache_info().misses == misses
    return t


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kind,n_in,n_out", [
    ("half_pixel", 1, 24), ("half_pixel", 2, 24), ("half_pixel", 3, 24),
    ("half_pixel", 6, 24), ("half_pixel", 6, 4),     # downsampling
    ("align_corners", 12, 24), ("align_corners", 1, 5),
    ("taps", None, None),
])
def test_table_equals_new_tensor(tables, kind, n_in, n_out, dtype):
    like = torch.zeros(2, dtype=dtype)
    if kind == "taps":
        got = layers.upsample_taps(like)
        data = [layers.UPSAMPLE_TAPS_EVEN, layers.UPSAMPLE_TAPS_ODD]
        cast = torch.tensor(data, dtype=torch.float64).to(dtype)
    else:
        build = (layers._resize_weights if kind == "half_pixel"
                 else layers._align_corners_matrix)
        got = layers.table(like, build, n_in, n_out)
        data = build(n_in, n_out)
        cast = torch.from_numpy(data).to(dtype)
    want = like.new_tensor(data)
    assert got.dtype == dtype and got.device == like.device
    assert torch.equal(got, want) and torch.equal(got, cast)
    assert not got.requires_grad
    assert _counts(tables) == (0, 1)
    again = (layers.upsample_taps(like) if kind == "taps"
             else layers.table(like, build, n_in, n_out))
    assert again is got and _counts(tables) == (1, 1)


@pytest.mark.parametrize("change", ["none", "size", "dtype", "device",
                                    "function"])
def test_another_key_is_a_miss(tables, change):
    like = torch.zeros(1)
    build, n_in = layers._resize_weights, 3
    first = layers.table(like, build, n_in, 24)
    if change == "size":
        n_in = 6
    elif change == "dtype":
        like = like.to(torch.bfloat16)
    elif change == "device":
        like = torch.zeros(1, device="meta")
    elif change == "function":
        build = layers._align_corners_matrix
    second = layers.table(like, build, n_in, 24)
    hit = change == "none"
    assert (second is first) == hit
    assert _counts(tables) == ((1, 1) if hit else (0, 2))
    assert second.dtype == like.dtype and second.device == like.device


# tables a 32x48 crop's forward asks for: 8 PSP resize tables (four priors,
# rows and columns; the 4x6 map's sizes repeat none), plus three tap tables
# (fused: up1-3's phase kernels; sparse, zero border: up3's taps) or six
# resize tables (dense up1-3) or four (dense up1-2, sparse align-corners
# up3, whose taps are per point)
@pytest.mark.parametrize("decoder,sparse,dtype,lookups", [
    ("fused", False, torch.float32, 11),
    ("fused", True, torch.float32, 11),
    ("fused", True, torch.bfloat16, 11),
    ("dense", False, torch.float32, 14),
    ("dense", True, torch.float32, 13),
    ("align", False, torch.float32, 14),
    ("align", True, torch.float32, 12),
])
def test_pspnet_first_call_equals_the_second(tables, decoder, sparse, dtype,
                                             lookups):
    torch.manual_seed(0)
    net = PSPNet(fused_decoder=decoder == "fused",
                 align_corners=decoder == "align",
                 dtype=None if dtype == torch.float32 else dtype).eval()
    img = torch.randn(2, 32, 48, 3)
    at = (torch.randperm(32 * 48)[:20].reshape(2, 10) if sparse else None)
    with torch.no_grad():
        first = net(img, sample_at=at)
        hits, misses = _counts(tables)
        second = net(img, sample_at=at)
    assert misses > 0 and hits + misses == lookups
    assert _counts(tables) == (hits + lookups, misses)
    assert torch.equal(first, second)
    assert tables.cache_info().currsize == misses
    assert _stored(img.to(dtype), layers._resize_weights, 1, 4).dtype == dtype


def _posenet_step(net, inputs, seed):
    """Outputs and parameter gradients of one train-mode forward."""
    net.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(seed)
    out = net(*inputs, generator=gen)
    loss = sum((v.float() * (i + 1)).sum() for i, (k, v) in
               enumerate(sorted(out.items())) if k != "emb")
    loss.backward()
    return ({k: v.detach().clone() for k, v in out.items()},
            {n: p.grad.clone() for n, p in net.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize("dtype,fused", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float32, False),
], ids=["f32-fused", "bf16-fused", "f32-dense"])
def test_posenet_outputs_and_gradients_unchanged(monkeypatch, dtype, fused):
    torch.manual_seed(1)
    net = PoseNet(3, fused_decoder=fused,
                  dtype=None if dtype == torch.float32 else dtype).train()
    g = torch.Generator().manual_seed(2)
    b, n = 2, 16
    inputs = (torch.randn(b, 32, 48, 3, generator=g),
              torch.randn(b, n, 3, generator=g),
              torch.randperm(32 * 48, generator=g)[:b * n].reshape(b, n),
              torch.tensor([0, 2]))
    with monkeypatch.context() as m:
        m.setattr(layers, "table", _fresh)
        want = _posenet_step(net, inputs, 7)
    layers.device_table.cache_clear()
    _posenet_step(net, inputs, 7)                      # the misses
    hits, misses = _counts(layers.device_table)
    got = _posenet_step(net, inputs, 7)                # hits only
    assert misses > 0
    assert _counts(layers.device_table) == (hits + hits + misses, misses)
    for w, h in zip(want, got):
        assert w.keys() == h.keys()
        for k in w:
            assert torch.equal(w[k], h[k]), k


def test_table_made_in_inference_mode_serves_training(tables):
    torch.manual_seed(0)
    net = PSPNet()
    img = torch.randn(1, 32, 48, 3)
    with torch.inference_mode():
        net.eval()(img)
    like = torch.zeros(1)
    assert not _stored(like, layers._upsample_taps).is_inference()
    assert not _stored(like, layers._resize_weights, 1, 4).is_inference()
    made = _counts(tables)
    net.train()(img, generator=torch.Generator().manual_seed(0)).sum() \
        .backward()
    hits, misses = _counts(tables)
    assert misses == made[1] and hits > made[0]
    assert net.psp.bottleneck.weight.grad is not None


def test_compile_stores_nothing(tables):
    x = torch.randn(2, 3, 4, 6)
    w = torch.randn(4, 5, 3, 3)
    f = torch.compile(lambda x, w: (layers.resize_bilinear(x, (8, 12)),
                                    layers.phase_conv_weight(w)),
                      backend="eager")
    traced = f(x, w)
    assert _counts(tables) == (0, 0) and tables.cache_info().currsize == 0
    eager = (layers.resize_bilinear(x, (8, 12)), layers.phase_conv_weight(w))
    assert all(torch.equal(a, b) for a, b in zip(traced, eager))
    assert _counts(tables) == (0, 3)
    stored = [_stored(x, layers._resize_weights, 4, 8),
              _stored(x, layers._resize_weights, 6, 12),
              _stored(w, layers._upsample_taps)]
    assert all(type(t) is torch.Tensor and not is_fake(t) for t in stored)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_quat_conjugate_equals_the_sign_product(dtype):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(5, 7, 4, generator=g).to(dtype)
    q[0, 0] = torch.tensor([0.0, -0.0, 0.0, -0.0])
    q.requires_grad_(True)
    got = quat_conjugate(q)
    want = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    # bitwise, signed zeros included
    assert torch.equal(got.detach().view(bits), want.detach().view(bits))
    up = torch.randn(5, 7, 4, generator=g).to(dtype)
    (gg,) = torch.autograd.grad(got, q, up)
    (gw,) = torch.autograd.grad(want, q, up)
    assert torch.equal(gg, gw)
