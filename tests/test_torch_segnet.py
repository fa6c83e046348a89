"""Port parity: SegNet, its layers, loss and train / eval steps, and the
SegNet half of ``compat``.

The JAX modules run on the CPU; the same numpy-seeded variables go to the
port through ``densefusion_tpu_torch.compat``. A narrow SegNet (the
reference's 2, 2, 3, 3, 3 encoder layers at widths up to 16) on 32x32
frames at B=2: its deepest conv stage (2x2) holds n=8 values per channel,
where torch's unbiased running variance would be 8/7 of flax's; the BN
layer alone is held at n=2 (B=2, 1x1), where it would be twice.
Tolerances: pool / unpool exact; the eval forward 1e-5 of the largest
logit, the train forward 5e-5; running statistics rtol 1e-5; the loss
rtol 1e-6; the train steps as ``test_three_train_steps_match_jax`` says.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as jnn
import optax

from densefusion_tpu.compat import segnet_state_dict_from_variables
from densefusion_tpu.losses import segmentation_loss as j_seg_loss
from densefusion_tpu.models import SegNet as JSegNet
from densefusion_tpu.models.layers import max_pool_argmax as j_pool
from densefusion_tpu.models.layers import max_unpool as j_unpool
from densefusion_tpu.train.seg import (
    SegTrainState as JSegTrainState, make_seg_eval_step as j_eval_step,
    make_seg_train_step as j_train_step,
)
from densefusion_tpu_torch import compat
from densefusion_tpu_torch.losses import segmentation_loss
from densefusion_tpu_torch.models import SegNet
from densefusion_tpu_torch.models.layers import max_pool_argmax, max_unpool
from densefusion_tpu_torch.models import segnet as segnet_module
from densefusion_tpu_torch.models.segnet import BatchNorm2d, Conv3x3
from densefusion_tpu_torch.train import make_optimizer
from densefusion_tpu_torch.train.seg import (
    SegTrainState, create_seg_train_state, make_seg_eval_step,
    make_seg_train_step,
)

from tests.torch_port_util import to_np

ENC = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))
DEC = ((16, 16, 16), (16, 16, 16), (16, 16, 12), (12, 8), (8,))
NUM_CLASSES, B, H, W = 5, 2, 32, 32
LR = 1e-4


def seg_variables(model, rng, h=H, w=W):
    """JAX variables of ``model`` with every leaf drawn from ``rng``: conv
    kernels N(0, 2 / fan_in), biases and BN shifts N(0, 0.05^2), BN scales
    near 1, running means N(0, 0.1^2) and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.key(0), jnp.zeros((1, h, w, 3)))

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(leaf.shape)
        if name == "kernel":
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_segnet(variables, num_classes=NUM_CLASSES, enc=ENC, dec=DEC):
    net = SegNet(num_classes, enc, dec)
    net.load_state_dict(compat.segnet_state_dict_from_flax(
        variables, net.enc_counts), strict=True)
    return net


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return to_np(x).transpose(0, 2, 3, 1)


def _flat_stats(tree):
    return {"/".join(getattr(k, "key", str(k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jnet = JSegNet(num_classes=NUM_CLASSES, enc_stages=ENC, dec_stages=DEC)
    variables = seg_variables(jnet, rng)
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, (B, H, W)).astype(np.int32)
    return jnet, variables, x, label


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_pool_unpool_match_jax(ties):
    """Pooled values, argmax positions (torch's flat index against JAX's
    window position) and the unpooled map exact; with ties (values drawn
    from {-1, 0, 1}, and all-zero windows) the first position in row-major
    order wins in both."""
    rng = np.random.default_rng(1)
    if ties:
        x = rng.integers(-1, 2, (2, 8, 12, 3)).astype(np.float32)
        x[:, :2, :2] = 0.0
    else:
        x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    jp, jpos = j_pool(jnp.asarray(x))
    pooled, idx = max_pool_argmax(nchw(x))
    np.testing.assert_array_equal(nhwc(pooled), np.asarray(jp))
    w = x.shape[2]
    row, col = to_np(idx) // w, to_np(idx) % w
    pos = ((row % 2) * 2 + col % 2).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    np.testing.assert_array_equal(nhwc(max_unpool(pooled, idx)),
                                  np.asarray(j_unpool(jp, jpos)))


def test_pool_unpool_gradient_matches_jax_without_ties():
    """On tie-free inputs the gradient of ``sum(unpool(pool(x)) * g)``
    equals JAX's exactly (one argmax per window)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)

    def jf(v):
        p, pos = j_pool(v)
        return jnp.sum(j_unpool(p, pos) * g)

    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = nchw(x).requires_grad_(True)
    p, idx = max_pool_argmax(xt)
    (max_unpool(p, idx) * nchw(g)).sum().backward()
    np.testing.assert_array_equal(nhwc(xt.grad), want)


def test_pool_gradient_on_exact_ties():
    """On an exact tie torch's max-pool gives the whole gradient to the
    argmax, where ``jnp.max`` splits it evenly: the pooled gradient summed
    over each window agrees, and torch's sits at JAX's argmax position."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 2:, 2:, 0] = [[3.0, 3.0], [1.0, 3.0]]
    want = np.asarray(jax.grad(lambda v: jnp.sum(j_pool(v)[0]))(
        jnp.asarray(x)))
    xt = nchw(x).requires_grad_(True)
    max_pool_argmax(xt)[0].sum().backward()
    got = nhwc(xt.grad)
    np.testing.assert_allclose(want[0, :2, :2, 0], 0.25)
    np.testing.assert_allclose(want[0, 2:, 2:, 0],
                               [[1 / 3, 1 / 3], [0, 1 / 3]], atol=1e-7)
    np.testing.assert_array_equal(got[0, :, :, 0], [[1, 0, 1, 0],
                                                    [0, 0, 0, 0],
                                                    [1, 0, 1, 0],
                                                    [0, 0, 0, 0]])
    for r in (0, 2):
        for c in (0, 2):
            np.testing.assert_allclose(got[0, r:r + 2, c:c + 2].sum(),
                                       want[0, r:r + 2, c:c + 2].sum(),
                                       rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 1, 1, 6), (2, 3, 5, 6)],
                         ids=["n2", "n30"])
def test_batchnorm_matches_flax(shape):
    """The port's BN against flax ``BatchNorm(momentum=0.9)``: the train
    output, and the running statistics after two updates (biased variance,
    as flax keeps; at n=2 torch's ``nn.BatchNorm2d`` would double it)."""
    rng = np.random.default_rng(3)
    c = shape[-1]
    bn = jnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = bn.init(jax.random.key(0), jnp.zeros(shape))
    stats = {"mean": 0.1 * rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    params = {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    port = BatchNorm2d(c)
    port.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                          "bias": torch.from_numpy(params["bias"]),
                          "running_mean": torch.from_numpy(stats["mean"]),
                          "running_var": torch.from_numpy(stats["var"])})
    assert set(port.state_dict()) == {"weight", "bias", "running_mean",
                                      "running_var"}
    jstats = stats
    for _ in range(2):
        x = (1.0 + rng.standard_normal(shape)).astype(np.float32)
        y, mutated = bn.apply({"params": params, "batch_stats": jstats},
                              jnp.asarray(x), mutable=["batch_stats"])
        jstats = mutated["batch_stats"]
        got = port(nchw(x))
        np.testing.assert_allclose(nhwc(got), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(to_np(port.running_mean),
                               np.asarray(jstats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(to_np(port.running_var),
                               np.asarray(jstats["var"]), rtol=1e-5)
    port.eval()
    x = rng.standard_normal(shape).astype(np.float32)
    y = jnn.BatchNorm(use_running_average=True, momentum=0.9).apply(
        {"params": params, "batch_stats": jstats}, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(y),
                               rtol=1e-5, atol=1e-6)


# -- SegNet -----------------------------------------------------------------

# (B, Cin, H, W, Cout): the narrow net's first, widening, deepest and
# classifier convs, the full width's first conv and a 512 -> 512 one
CONV_SHAPES = [(2, 3, 32, 32, 8), (2, 8, 16, 16, 12), (2, 16, 2, 2, 16),
               (2, 8, 32, 32, 5), (2, 3, 24, 32, 64), (2, 512, 4, 6, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("routes", [None, ("cudnn", "cudnn"),
                                    ("cudnn_fwd", "cudnn_nhwc"),
                                    ("aten_fwd", "cudnn")],
                         ids=["rule", "cudnn", "fwd-nhwc", "aten-fwd"])
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=lambda s: "{1}to{4}-{2}x{3}".format(*s))
def test_conv3x3_matches_conv2d_autograd(shape, routes, dtype, monkeypatch):
    """``Conv3x3``'s forward equals ``F.conv2d`` bit for bit; its input,
    weight and bias gradients equal autograd's through ``F.conv2d`` bit for
    bit by the rule's route on the CPU (autograd's own), and by each route
    the rule can pick on the card (run here on the CPU: the flipped
    forward, cuDNN's backward entry, channels-last) within float32
    round-off (1e-5 of each gradient's largest element) or, in float64,
    1e-12; ``backward_routes`` counts the calls."""
    b, cin, h, w, cout = shape
    gen = torch.Generator().manual_seed(cin * 1000 + cout)
    conv = Conv3x3(cin, cout).to(dtype)
    with torch.no_grad():
        conv.bias.normal_(generator=gen)
    x = torch.randn((b, cin, h, w), generator=gen, dtype=dtype,
                    requires_grad=True)
    g = torch.randn((b, cout, h, w), generator=gen, dtype=dtype)
    if routes is not None:
        monkeypatch.setattr(segnet_module, "backward_route",
                            lambda *_: routes)
    want_y = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    want = torch.autograd.grad(want_y, (x, conv.weight, conv.bias), g)
    before = segnet_module.backward_routes()
    y = conv(x)
    assert torch.equal(y, want_y)
    got = torch.autograd.grad(y, (x, conv.weight, conv.bias), g)
    d, wr = routes or ("autograd", "autograd")
    assert segnet_module.backward_routes() - before == {("dgrad", d): 1,
                                                        ("wgrad", wr): 1}
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for name, gv, wv in zip(("input", "weight", "bias"), got, want):
        if routes is None:
            assert torch.equal(gv, wv), name
        else:
            assert float((gv - wv).abs().max()) <= \
                tol * float(wv.abs().max()), name


def test_conv3x3_route_rule_and_first_layer():
    """The rule keeps autograd's route on the CPU and outside float32; a
    conv whose input needs no gradient (SegNet's first) takes no dgrad."""
    x = torch.zeros((1, 3, 8, 8))
    w = torch.zeros((4, 3, 3, 3))
    assert segnet_module.backward_route(x, w) == ("autograd", "autograd")
    assert segnet_module.backward_route(x.double(), w.double()) == (
        "autograd", "autograd")
    conv = Conv3x3(3, 4)
    before = segnet_module.backward_routes()
    conv(torch.randn((1, 3, 8, 8))).sum().backward()
    assert segnet_module.backward_routes() - before == {
        ("wgrad", "autograd"): 1}
    assert isinstance(conv, torch.nn.Conv2d)
    assert [n for n, _ in conv.named_parameters()] == ["weight", "bias"]


def test_compat_round_trip(setup):
    """flax variables -> state_dict -> variables exact; the state_dict has
    exactly JAX's ``segnet_state_dict_from_variables`` keys and values (no
    ``num_batches_tracked``); a reference dict that carries them loads."""
    _, variables, _, _ = setup
    net = SegNet(NUM_CLASSES, ENC, DEC)
    sd = compat.segnet_state_dict_from_flax(variables, net.enc_counts)
    want = segnet_state_dict_from_variables(variables)
    assert set(sd) == set(want) == set(net.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(to_np(sd[k]), np.asarray(v), err_msg=k)
    back = compat.segnet_variables_from_state_dict(
        {**sd, "bn11.num_batches_tracked": torch.tensor(3)}, net.enc_counts)
    assert list(back) == ["params", "batch_stats"]
    for tree in ("params", "batch_stats"):
        got, ref = _flat_stats(back[tree]), _flat_stats(variables[tree])
        assert list(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_full_width_names_match_reference():
    """At full width the port's state_dict is the reference's: the key set
    JAX's exporter gives for the default SegNet, with its shapes."""
    net = SegNet()
    variables = jax.eval_shape(functools.partial(JSegNet().init, train=False),
                               jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), variables)
    want = segnet_state_dict_from_variables(zeros)
    sd = net.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert list(sd)[:6] == ["conv11.weight", "conv11.bias", "bn11.weight",
                            "bn11.bias", "bn11.running_mean",
                            "bn11.running_var"]
    assert list(sd)[-2:] == ["conv11d.weight", "conv11d.bias"]


def test_eval_forward_matches_jax(setup):
    jnet, variables, x, _ = setup
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))
    net = port_segnet(variables).eval()
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    assert got.shape == (B, H, W, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("batch", [2, 1])
def test_train_forward_and_statistics_match_jax(setup, batch):
    """Train mode: logits within 5e-5 of the largest, and every running
    statistic equal to flax's ``batch_stats`` (rtol 1e-5); at B=2 the
    deepest stage holds n=8 values per channel, at B=1 n=4. (Normalizing
    with batch statistics amplifies float32 rounding: at B=2 a float64 run
    of the port puts the port's logits 1.1e-5 and JAX's 1.6e-5 of the
    largest away; in eval mode both are within 4e-7 of it.)"""
    jnet, variables, x, _ = setup
    x = x[:batch]
    want, mutated = jnet.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    want = np.asarray(want)
    net = port_segnet(variables).train()
    got = nhwc(net(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-5 * np.abs(want).max())
    stats = compat.segnet_variables_from_state_dict(
        net.state_dict(), net.enc_counts)["batch_stats"]
    got_s, want_s = _flat_stats(stats), _flat_stats(mutated["batch_stats"])
    assert set(got_s) == set(want_s)
    for k, v in want_s.items():
        np.testing.assert_allclose(got_s[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the stage-5 statistics differ from nn.BatchNorm2d's unbiased update
    n = batch * (H // 16) * (W // 16)
    deep = np.asarray(mutated["batch_stats"]["enc5_3"]["bn"]["var"])
    prior = np.asarray(variables["batch_stats"]["enc5_3"]["bn"]["var"])
    batch_var = (deep - 0.9 * prior) / 0.1
    unbiased = 0.9 * prior + 0.1 * batch_var * n / (n - 1)
    assert np.abs(unbiased - deep).max() > 1e-3 * np.abs(deep).max()


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weighted"])
def test_segmentation_loss_matches_jax(weighted):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((2, 6, 5, 4))).astype(np.float32)
    label = rng.integers(0, 4, (2, 6, 5)).astype(np.int32)
    w = np.where(label > 0, 7.0, 1.0).astype(np.float32) if weighted \
        else None
    want = float(j_seg_loss(jnp.asarray(logits), jnp.asarray(label),
                            None if w is None else jnp.asarray(w)))
    got = float(segmentation_loss(
        nchw(logits), torch.from_numpy(label),
        None if w is None else torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if weighted:   # an all-zero weight map divides by 1, not 0
        zero = segmentation_loss(nchw(logits), torch.from_numpy(label),
                                 torch.zeros(label.shape))
        assert float(zero) == 0.0


def _jax_state(jnet, variables, tx):
    return JSegTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))


def _pre_bn_bias(key: str) -> bool:
    """A conv bias ahead of a BN: its exact gradient is 0."""
    return key.endswith("conv/bias") and not key.startswith("classifier")


def _moments(net, state, jstate):
    opt = compat.adam_to_optax(state.optimizer, net, "segnet")
    assert int(opt["0"]["count"]) == int(jstate.opt_state[0].count)
    return [(_flat_stats(opt["0"][m]), _flat_stats(getattr(
        jstate.opt_state[0], m))) for m in ("mu", "nu")]


@pytest.mark.parametrize("fg_weight", [None, 7.0], ids=["ce", "fg7"])
def test_three_train_steps_match_jax(setup, fg_weight):
    """Three Adam steps from the carried weights against
    ``make_seg_train_step``, each on its own batch.

    * every loss to rtol 2e-5; the running statistics to 1e-5 of each
      tensor's largest after step 1, which ran on the same parameters,
      and to 1e-3 after steps 2 and 3, which ran on parameters up to 2 lr
      per step apart (below);
    * after step 1, the moments: mu (0.1 g) to 1e-3 and nu to 2e-3 of
      each tensor's largest. Train-mode BN makes float32 gradients noisy:
      the port's and JAX's are each 2-3e-4 of the largest from a float64
      run of the port. The conv biases ahead of a BN have a gradient of 0
      in exact arithmetic (BN subtracts their shift), so theirs are
      rounding noise, held below 1e-4 of the largest mu;
    * after every step, the parameters within 1e-6 where their first
      moment is above 1e-2 of its tensor's largest (step 1), and within
      2 lr per step taken everywhere: Adam's first update is
      ``lr * g / (|g| + eps)``, so where g is at noise size each
      framework moves by any value in [-lr, lr]. That spread feeds the
      next gradients, so after step 3 the moments are held as directions:
      cosine similarity above 0.99 per tensor (float64 puts both float32
      runs 7-13% of the largest away elementwise there)."""
    jnet, variables, x, label = setup
    rng = np.random.default_rng(5)
    tx = optax.adam(LR)
    jstate = _jax_state(jnet, variables, tx)
    jstep = j_train_step(jnet, tx, fg_weight=fg_weight)
    net = port_segnet(variables)
    state = SegTrainState(step=0, segnet=net,
                          optimizer=make_optimizer(net.parameters(), LR))
    step = make_seg_train_step(state, fg_weight=fg_weight)
    for i in range(3):
        xi = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        jstate, jloss = jstep(jstate, jnp.asarray(xi), jnp.asarray(label))
        loss = step(nchw(xi), torch.from_numpy(label))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5,
                                   err_msg=f"step {i}")
        got = compat.segnet_variables_from_state_dict(net.state_dict(),
                                                      net.enc_counts)
        (mu, jmu), (nu, jnu) = _moments(net, state, jstate)
        assert set(mu) == set(jmu)
        params = _flat_stats(got["params"])
        jparams = _flat_stats(jstate.params)
        top = max(np.abs(v).max() for v in jmu.values())
        for k in jmu:
            scale = np.abs(jmu[k]).max()
            noise = _pre_bn_bias(k)
            if i == 0:
                if noise:
                    assert max(np.abs(mu[k]).max(), scale) <= 1e-4 * top, k
                else:
                    assert np.abs(mu[k] - jmu[k]).max() <= 1e-3 * scale, k
                    assert np.abs(nu[k] - jnu[k]).max() <= \
                        2e-3 * np.abs(jnu[k]).max(), k
            clear = np.abs(jmu[k]) > 1e-2 * scale
            if i == 0 and not noise:
                np.testing.assert_allclose(params[k][clear],
                                           jparams[k][clear], rtol=0,
                                           atol=1e-6, err_msg=k)
            assert np.abs(params[k] - jparams[k]).max() <= \
                2 * (i + 1) * LR + 1e-6, k
        stats = _flat_stats(got["batch_stats"])
        for k, v in _flat_stats(jstate.batch_stats).items():
            # step 1 ran on the same parameters; later steps on parameters
            # up to 2 lr per step apart
            tol = 1e-5 if i == 0 else 1e-3
            assert np.abs(stats[k] - v).max() <= tol * np.abs(v).max(), \
                (i, k)
    assert state.step == 3
    for k in jmu:
        for a, b in ((mu[k], jmu[k]), (nu[k], jnu[k])):
            if _pre_bn_bias(k):
                continue
            cos = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
            assert cos > 0.99, (k, cos)


def test_eval_step_matches_jax(setup):
    """Loss, pixel accuracy and foreground IoU against ``make_seg_eval_step``
    on labels built from the JAX prediction (so IoU is neither 0 nor 1)."""
    jnet, variables, x, _ = setup
    logits = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))
    rng = np.random.default_rng(6)
    label = np.where(rng.random(logits.shape[:3]) < 0.7,
                     logits.argmax(-1),
                     rng.integers(0, NUM_CLASSES, logits.shape[:3]))
    label = label.astype(np.int32)
    net = port_segnet(variables)
    for fg in (None, 5.0):
        want = j_eval_step(jnet, fg_weight=fg)(
            variables["params"], variables["batch_stats"], jnp.asarray(x),
            jnp.asarray(label))
        got = make_seg_eval_step(net, fg_weight=fg)(nchw(x),
                                                    torch.from_numpy(label))
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            assert float(g) == float(w)
        assert 0.0 < float(got[2]) < 1.0


def test_eval_step_iou_semantics():
    """The JAX test's hand-built case: pred [[1, 0], [2, 2]] against gt
    [[1, 0], [2, 1]] gives accuracy 3/4 and IoU 2/3."""
    logits = torch.zeros((1, 3, 2, 2))
    for (y, x), c in {(0, 0): 1, (0, 1): 0, (1, 0): 2, (1, 1): 2}.items():
        logits[0, c, y, x] = 1.0

    class Stub(torch.nn.Module):
        def forward(self, x):
            return logits

    label = torch.tensor([[[1, 0], [2, 1]]])
    _, acc, iou = make_seg_eval_step(Stub())(torch.zeros((1, 3, 2, 2)),
                                             label)
    assert float(acc) == 0.75
    assert float(iou) == pytest.approx(2.0 / 3.0)


def test_create_seg_train_state_initializers():
    """Fresh weights: He-normal over fan-out (std sqrt(2 / (out * 9))),
    zero biases, BN at identity, the same weights from one seed."""
    a = create_seg_train_state(SegNet(4, ENC, DEC), lr=1e-4, seed=3,
                               device="cpu")
    b = create_seg_train_state(SegNet(4, ENC, DEC), lr=1e-4, seed=3,
                               device="cpu")
    for (k, v), (_, u) in zip(a.segnet.state_dict().items(),
                              b.segnet.state_dict().items()):
        assert torch.equal(v, u), k
    w = a.segnet.conv33.weight
    np.testing.assert_allclose(float(w.detach().std()), np.sqrt(2 / (16 * 9)),
                               rtol=0.1)
    assert float(a.segnet.conv33.bias.abs().max()) == 0.0
    assert float(a.segnet.bn33.running_var.min()) == 1.0
    owned = {id(p) for g in a.optimizer.param_groups for p in g["params"]}
    assert owned == {id(p) for p in a.segnet.parameters()}


def test_seg_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_seg_train_state(SegNet(4, ENC, DEC))
