"""Port parity of the bf16 compute path against the JAX package's
``dtype=jnp.bfloat16`` path, on the CPU.

* Kernel 6's bf16 route: the port's plain version (float32 sums of exact
  bf16 products, one rounding) against the JAX Pallas kernel in interpret
  mode and ``conv3x3_valid_xla`` in bf16, at rtol / atol 1e-2 (the JAX
  kernel test's bf16 tolerance, ``tests/test_phase_conv.py:50-52``); the
  kernel route's bf16 gradients against the library route's.
* The layers in bf16 on the same bf16 inputs and carried weights, each
  within one bf16 ulp of the largest element (2^-7 relative): the phase
  kernels' composition, ``PSPUpsample`` under the three decoders, PReLU, the
  two fusion nets and the PoseNet heads. They follow the JAX package's
  cast points: the weights cast before use, the bias added after the
  product's rounding, the composition rounded where JAX rounds it.
* ``PoseNet`` / ``PoseRefineNet`` with ``dtype=torch.bfloat16`` against
  the JAX networks with ``dtype=jnp.bfloat16`` (run op by op, so every
  bf16 op rounds, as the JAX package defines them): the outputs are
  float32, and the port's bf16 output lies nearer JAX's bf16 output than
  JAX's float32 output does: the mean absolute difference is at most 0.75
  of the bf16-float32 gap's, and more of the bf16-valued outputs (the
  heads') equal JAX's bf16 ones exactly than JAX's float32 outputs rounded
  to bf16 do. The nets amplify the single-ulp differences that the two
  libraries' convolution sums leave (0.1% of the trunk's elements), so a
  bound in max norm does not hold: over seeds 0-7 at N=128 the mean
  ratio read 0.04-0.69 and the max-norm ratio 0.41-1.17.
* bf16 train steps of both phases: float32 gradients and Adam state,
  finite, nonzero; ``Dropout2d``'s keep probability in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from densefusion_tpu.models import PoseNet as JPoseNet
from densefusion_tpu.models import PoseRefineNet as JRefiner
from densefusion_tpu.models import layers as jlayers
from densefusion_tpu.models.posenet import DenseFusionFeat as JFusion
from densefusion_tpu.models.posenet import apply_head_stacks
from densefusion_tpu.models.pspnet import PSPUpsample as JUpsample
from densefusion_tpu.models.refiner import RefineFeat as JRefineFeat
from densefusion_tpu.ops.phase_conv import conv3x3_valid as jconv
from densefusion_tpu.ops.phase_conv import conv3x3_valid_xla
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.data import PoseSample, to_device
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
from densefusion_tpu_torch.models import layers
from densefusion_tpu_torch.models.posenet import DenseFusionFeat
from densefusion_tpu_torch.models.pspnet import PSPUpsample
from densefusion_tpu_torch.models.refiner import RefineFeat
from densefusion_tpu_torch.ops import phase_conv
from densefusion_tpu_torch.train import (
    TrainState, make_optimizer, make_pose_train_step, make_refine_train_step,
)

from tests.torch_port_util import (
    NUM_OBJ, EMB, fill_params, init_params, jnp_args, posenet_inputs, to_np,
)

BF16 = torch.bfloat16
ULP = 2.0 ** -7        # one bf16 ulp, relative to the largest element
B, CROP, N = 2, 32, 16
N_NET = 128     # the networks' points: enough outputs for a mean


def _bf16_np(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, as float32."""
    return torch.from_numpy(x).to(BF16).float().numpy()


def _nchw(x: np.ndarray, dtype=BF16) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return to_np(t.float()).transpose(0, 2, 3, 1)


def _within_ulp(got: np.ndarray, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= ULP * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# Kernel 6, bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 64), (1, 12, 10, 130, 5)])
def test_kernel6_bf16_plain_matches_jax(shape):
    """The bf16 plain version against the JAX Pallas kernel (interpret
    mode) and XLA's convolution, both in bf16; its output is bf16."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(0)
    xp = _bf16_np(rng.standard_normal((b, h + 2, w + 2, cin))
                  .astype(np.float32))
    pk = _bf16_np((rng.standard_normal((3, 3, cin, cout)) * 0.1)
                  .astype(np.float32))
    jxp = jnp.asarray(xp).astype(jnp.bfloat16)
    jpk = jnp.asarray(pk).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        pallas = jconv(jxp, jpk, backend="pallas")
    xla = conv3x3_valid_xla(jxp, jpk)
    got = phase_conv.conv3x3_valid_plain(torch.from_numpy(xp).to(BF16),
                                         torch.from_numpy(pk).to(BF16))
    assert got.dtype == BF16 and pallas.dtype == jnp.bfloat16
    for want in (pallas, xla):
        np.testing.assert_allclose(
            to_np(got.float()), np.asarray(want.astype(jnp.float32)),
            rtol=1e-2, atol=1e-2)


def test_kernel6_bf16_route_gradients_equal_library():
    """The kernel route in bf16: its backward is the library
    convolution's, in bf16, so both input and weight gradients equal the
    library route's bit for bit."""
    rng = np.random.default_rng(1)
    xp = torch.from_numpy(rng.standard_normal((2, 32, 10, 10))
                          .astype(np.float32)).to(BF16)
    pk = torch.from_numpy((rng.standard_normal((3, 3, 32, 64)) * 0.1)
                          .astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.standard_normal((2, 64, 8, 8))
                         .astype(np.float32)).to(BF16)
    grads = {}
    for backend in ("kernel", "library"):
        x, k = xp.clone().requires_grad_(True), pk.clone().requires_grad_(True)
        (phase_conv.conv3x3_valid_nchw(x, k, backend) * g).sum().backward()
        grads[backend] = (x.grad, k.grad)
    for a, b in zip(grads["kernel"], grads["library"]):
        assert a.dtype == BF16 and torch.equal(a, b)


def test_kernel6_route_refuses_mixed_types():
    """The kernel route takes float32 or bf16 operands of one type and
    raises on anything else, on any device."""
    x = torch.zeros((1, 3, 6, 6))
    for xp, pk in ((x.to(BF16), torch.zeros((3, 3, 3, 4))),
                   (x.double(), torch.zeros((3, 3, 3, 4)).double())):
        with pytest.raises(ValueError, match="both"):
            phase_conv.conv3x3_valid_nchw(xp, pk, "kernel")
    kernel = phase_conv.phase_conv_bf16_kernel
    before = kernel.launches
    with pytest.raises(ValueError, match="bfloat16"):
        kernel(x.cuda() if torch.cuda.is_available() else x,
               torch.zeros((3, 3, 3, 4)))
    assert kernel.launches == before


# ---------------------------------------------------------------------------
# Layers in bf16
# ---------------------------------------------------------------------------

def test_phase_conv_weight_bf16():
    """The four phase kernels composed in bf16 after the weight's cast, in
    the JAX package's order (``layers.py:99-104``)."""
    rng = np.random.default_rng(2)
    k = rng.standard_normal((3, 3, 24, 16)).astype(np.float32)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    m = jnp.stack([jnp.asarray(jlayers.UPSAMPLE_TAPS_EVEN, jnp.bfloat16),
                   jnp.asarray(jlayers.UPSAMPLE_TAPS_ODD, jnp.bfloat16)])
    want = jnp.einsum("pti,quj,tucd->pqijcd", m, m, kb)
    want = want.transpose(2, 3, 4, 0, 1, 5).reshape(3, 3, 24, 4 * 16)
    got = layers.phase_conv_weight(
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(BF16))
    assert got.dtype == BF16
    _within_ulp(to_np(got.float()), want)


@pytest.mark.parametrize("mode", ["fused", "fused-zero", "dense",
                                  "align-corners"])
def test_psp_upsample_bf16(mode):
    """``PSPUpsample`` in bf16 under each decoder: the fused phase
    convolution (replicate border), the fused one with the zero border's
    ring corrections (``layers.py:152,162``), the dense resize-then-conv
    with zero padding and the align-corners resize."""
    flags = {"fused": dict(fused=True, border="replicate"),
             "fused-zero": dict(fused=True, border="zero"),
             "dense": dict(fused=False, border="zero"),
             "align-corners": dict(fused=False, border="zero",
                                   align_corners=True)}[mode]
    rng = np.random.default_rng(3)
    x = _bf16_np(rng.standard_normal((2, 6, 5, 16)).astype(np.float32))
    jm = JUpsample(8, dtype=jnp.bfloat16, **flags)
    params = fill_params(jax.eval_shape(jm.init, jax.random.key(0),
                                        jnp.asarray(x)), rng)
    want = jm.apply(params, jnp.asarray(x).astype(jnp.bfloat16))
    m = PSPUpsample(16, 8, fused=flags["fused"], border=flags["border"],
                    align_corners=flags.get("align_corners", False))
    p = params["params"]
    m.load_state_dict({
        "conv.1.weight": torch.from_numpy(np.asarray(
            p["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()),
        "conv.1.bias": torch.from_numpy(np.asarray(p["conv"]["bias"])),
        "conv.2.weight": torch.from_numpy(
            np.asarray(p["prelu"]["slope"]).reshape(1))})
    with torch.no_grad():
        got = m(_nchw(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(_nhwc(got), want)


def test_prelu_bf16():
    """The slope is cast to the input's type (``layers.py:30``)."""
    x = _bf16_np(np.linspace(-3, 3, 97, dtype=np.float32))
    slope = np.float32(0.2371)
    want = jlayers.PReLU().apply({"params": {"slope": jnp.asarray(slope)}},
                                 jnp.asarray(x).astype(jnp.bfloat16))
    got = layers.prelu(torch.from_numpy(x).to(BF16),
                       torch.tensor([slope]))
    assert got.dtype == BF16
    np.testing.assert_array_equal(to_np(got.float()),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["posenet", "refiner"])
def test_fusion_bf16(kind):
    """``DenseFusionFeat`` / ``RefineFeat`` in bf16: the cloud and the
    embedding cast in, the global mean taken in bf16."""
    jcls, cls = {"posenet": (JFusion, DenseFusionFeat),
                 "refiner": (JRefineFeat, RefineFeat)}[kind]
    rng = np.random.default_rng(4)
    pts = (0.05 * rng.standard_normal((2, 40, 3)) + [0, 0, 0.6]) \
        .astype(np.float32)
    emb = (rng.standard_normal((2, 40, EMB)) - 3.0).astype(np.float32)
    jm = jcls(dtype=jnp.bfloat16)
    params = fill_params(jax.eval_shape(jm.init, jax.random.key(0),
                                        jnp.asarray(pts), jnp.asarray(emb)),
                         rng)
    want = jm.apply(params, jnp.asarray(pts), jnp.asarray(emb))
    state = {k.removeprefix("feat."): v for k, v in compat._export(
        {"params": {"fusion": params["params"]}},
        compat._fusion_map("feat.")).items()}
    m = cls(EMB, BF16)
    m.load_state_dict(state)
    with torch.no_grad():
        got = m(torch.from_numpy(pts), torch.from_numpy(emb))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(to_np(got.float()), want)


def test_heads_bf16():
    """The three PoseNet head stacks in bf16 (layer 1 merged, the object's
    slice of the last layer) against ``apply_head_stacks(dtype=bf16)``."""
    rng = np.random.default_rng(5)
    inputs = posenet_inputs(rng, B, CROP, N)
    params = init_params(JPoseNet(num_obj=NUM_OBJ), rng, *jnp_args(*inputs),
                         conf_scale=8.0)
    feat = _bf16_np(np.abs(rng.standard_normal((B, N, 1408)))
                    .astype(np.float32))
    obj = np.array([2, 0], np.int32)
    p = params["params"]
    heads = [[(p[h][f"fc{i}"]["kernel"], p[h][f"fc{i}"]["bias"])
              for i in range(1, 5)] for h in ("head_r", "head_t", "head_c")]
    want = apply_head_stacks(jnp.asarray(feat).astype(jnp.bfloat16), heads,
                             NUM_OBJ, (4, 3, 1), dtype=jnp.bfloat16,
                             obj=jnp.asarray(obj))
    net = PoseNet(NUM_OBJ, dtype=BF16)
    net.load_state_dict(compat.posenet_state_dict_from_flax(params))
    with torch.no_grad():
        got = net._heads(torch.from_numpy(feat).to(BF16),
                         torch.from_numpy(obj).long())
    for g, w in zip(got, want):
        assert g.dtype == BF16
        _within_ulp(to_np(g.float()), w)


# ---------------------------------------------------------------------------
# The networks in bf16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    """Seeded inputs and JAX weights; the JAX PoseNet's and refiner's
    float32 and bf16 outputs (op by op); the port's networks in bf16 and
    float32 on the same weights."""
    rng = np.random.default_rng(6)
    inputs = posenet_inputs(rng, B, CROP, N_NET)
    args = jnp_args(*inputs)
    jpose = JPoseNet(num_obj=NUM_OBJ)
    p_pose = init_params(jpose, rng, *args, conf_scale=8.0)
    jref = JRefiner(num_obj=NUM_OBJ)
    emb = (rng.standard_normal((B, N_NET, EMB)) - 3.0).astype(np.float32)
    p_ref = init_params(jref, rng, args[1], jnp.asarray(emb), args[3])
    want = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        pose = JPoseNet(num_obj=NUM_OBJ, dtype=dtype).apply(p_pose, *args)
        ref = JRefiner(num_obj=NUM_OBJ, dtype=dtype).apply(
            p_ref, args[1], jnp.asarray(emb), args[3])
        want[name] = {**{k: np.asarray(v) for k, v in pose.items()},
                      **{f"refine_{k}": np.asarray(v)
                         for k, v in ref.items()}}
    port = {}
    for name, dtype in (("f32", None), ("bf16", BF16)):
        pose = PoseNet(NUM_OBJ, dtype=dtype)
        pose.load_state_dict(compat.posenet_state_dict_from_flax(p_pose))
        ref = PoseRefineNet(NUM_OBJ, dtype=dtype)
        ref.load_state_dict(compat.refiner_state_dict_from_flax(p_ref))
        port[name] = (pose.eval(), ref.eval())
    return inputs, emb, want, port


def _port_outputs(nets, name):
    inputs, emb, _, port = nets
    pose, ref = port[name]
    img, pts, choose, obj = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        out = pose(img, pts, choose.long(), obj.long())
        rout = ref(pts, torch.from_numpy(emb), obj.long())
    return {**out, **{f"refine_{k}": v for k, v in rout.items()}}


KEYS = ("pred_r", "pred_t", "pred_c", "emb", "refine_pred_r",
        "refine_pred_t")
BF16_VALUED = ("pred_r", "pred_t", "pred_c_logit", "refine_pred_r",
               "refine_pred_t")   # bf16 results cast to float32


def test_bf16_networks_follow_jax(nets):
    """The port's bf16 outputs are float32 and nearer JAX's bf16 outputs
    than JAX's float32 outputs are (module docstring); the float32 nets
    agree at the float32 tolerance."""
    _, _, want, _ = nets
    got = _port_outputs(nets, "bf16")
    got32 = _port_outputs(nets, "f32")
    for k in KEYS:
        g, jb, j32 = to_np(got[k]), want["bf16"][k], want["f32"][k]
        assert got[k].dtype == torch.float32 and jb.dtype == np.float32
        gap = np.abs(jb - j32)
        diff = np.abs(g - jb)
        assert gap.max() > 0, k
        assert diff.mean() <= 0.75 * gap.mean(), (k, diff.mean(), gap.mean())
        np.testing.assert_allclose(to_np(got32[k]), j32, rtol=1e-4,
                                   atol=1e-5)
    for k in BF16_VALUED:
        g, jb = to_np(got[k]), want["bf16"][k]
        rounded = to_np(torch.tensor(want["f32"][k]).to(BF16).float())
        assert (g == jb).mean() > (rounded == jb).mean(), k


def test_bf16_posenet_launch_free_on_cpu(nets):
    """On the CPU the bf16 PoseNet runs the library convolution ("auto"),
    so neither kernel-6 wrapper is called."""
    counts = (phase_conv.phase_conv_kernel.launches,
              phase_conv.phase_conv_bf16_kernel.launches)
    _port_outputs(nets, "bf16")
    assert (phase_conv.phase_conv_kernel.launches,
            phase_conv.phase_conv_bf16_kernel.launches) == counts


# ---------------------------------------------------------------------------
# bf16 training
# ---------------------------------------------------------------------------

def _batch(rng, m):
    model = rng.uniform(-0.05, 0.05, (B, m, 3))
    target = model + np.array([0.0, 0.0, 0.6])
    points = target[:, rng.integers(0, m, N)] \
        + 0.005 * rng.standard_normal((B, N, 3))
    return to_device(PoseSample(
        points=points.astype(np.float32),
        choose=rng.integers(0, CROP * CROP, (B, N)).astype(np.int32),
        img=rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32),
        target=target.astype(np.float32),
        model_points=model.astype(np.float32),
        obj_idx=np.array([1, 2], np.int32), sym=np.array([True, False]),
        valid=np.ones((B,), bool)), "cpu")


@pytest.mark.parametrize("phase", [1, 2])
def test_bf16_train_steps(nets, phase):
    """A bf16 phase-1 and phase-2 step on the CPU: float32 parameters,
    gradients and Adam moments, finite and nonzero; the trained module's
    parameters move."""
    pose, ref = (m.train() for m in nets[3]["bf16"])
    module = pose if phase == 1 else ref
    state = TrainState(step=0, posenet=pose, refiner=ref,
                       optimizer=make_optimizer(module.parameters(), 1e-3),
                       generator=torch.Generator().manual_seed(0))
    step = (make_pose_train_step(state, use_adds=True) if phase == 1
            else make_refine_train_step(state, refine_iters=2))
    before = [p.detach().clone() for p in module.parameters()]
    metrics = step(_batch(np.random.default_rng(7), 30), 0.015)
    pose.eval(), ref.eval()
    assert np.isfinite(float(metrics["loss"]))
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().sum()) > 0 for g in grads)
    moments = [s for s in state.optimizer.state.values()]
    assert moments and all(s["exp_avg"].dtype == torch.float32
                           and s["exp_avg_sq"].dtype == torch.float32
                           for s in moments)
    assert any(not torch.equal(p, b)
               for p, b in zip(module.parameters(), before))
    # put the shared fixture's weights back
    with torch.no_grad():
        for p, b in zip(module.parameters(), before):
            p.copy_(b)


def test_dropout2d_keep_probability_is_float32(monkeypatch):
    """``Dropout2d`` draws its mask from float32 keep probabilities in a
    bf16 map (flax draws with a Python-float keep probability): the kept
    fraction of 2M channels at p=0.15 is within four standard errors of
    0.85, where a bf16 0.85 (0.8515625) sits six away."""
    seen = []
    bernoulli = torch.bernoulli

    def spy(probs, *args, **kwargs):
        seen.append(probs.dtype)
        return bernoulli(probs, *args, **kwargs)

    monkeypatch.setattr(torch, "bernoulli", spy)
    n = 2_000_000
    x = torch.ones((1, n, 1, 1), dtype=BF16)
    y = layers.Dropout2d(0.15).train()(x, torch.Generator().manual_seed(0))
    assert seen == [torch.float32] and y.dtype == BF16
    kept = float((y.flatten() > 0).double().mean())
    se = np.sqrt(0.85 * 0.15 / n)
    assert abs(kept - 0.85) < 4 * se, (kept, se)
