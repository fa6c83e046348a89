"""The plain reference against the port, on the CPU at a small size: the
networks, the pipeline, the phase-1 loss and its gradients with the same
dropout draws, Adam and the ADD / ADD-S distances."""

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import judge
from perfbench.reference import loss as ref_loss
from perfbench.reference import model as ref
from perfbench.tests import tiny

SEED = 2_718_281_828_459


@pytest.fixture(scope="module")
def setup():
    from densefusion_tpu_torch.models import PoseNet, PoseRefineNet

    cfg = tiny.config()
    sd_p, sd_r = inputs.model_weights(cfg, SEED, "cpu")
    port = PoseNet(cfg["num_obj"]), PoseRefineNet(cfg["num_obj"])
    plain = ref.posenet(cfg), ref.refiner(cfg)
    for pair in (port, plain):
        pair[0].load_state_dict(sd_p)
        pair[1].load_state_dict(sd_r)
    batch = inputs.make_pool(cfg, tiny.traffic("train-p1-b32"), SEED)[0]
    return cfg, port, plain, batch, judge.tensors(batch, "cpu")


def test_networks_agree(setup):
    cfg, (pn, rn), (pr, rr), _, x = setup
    with torch.no_grad():
        out = pn.eval()(x["img"], x["points"], x["choose"], x["obj"])
        r, t, logit, emb = pr.eval()(x["img"], x["points"], x["choose"],
                                     x["obj"])
        for a, b in ((out["pred_r"], r), (out["pred_t"], t),
                     (out["pred_c_logit"], logit)):
            assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
        assert torch.allclose(out["emb"], emb, rtol=1e-4, atol=1e-3)
        a, b = rn(x["points"], emb, x["obj"]), rr(x["points"], emb, x["obj"])
        assert torch.allclose(a["pred_r"], b[0], rtol=1e-4, atol=1e-5)
        assert torch.allclose(a["pred_t"], b[1], rtol=1e-4, atol=1e-5)


def test_pipeline_poses_agree(setup):
    from densefusion_tpu_torch.eval import InferencePipeline

    cfg, (pn, rn), _, batch, x = setup
    pipe = InferencePipeline(pn, rn, refine_iters=3, return_unrefined=True,
                             device="cpu")
    got = [v.numpy() for v in pipe(x["img"], x["points"], x["choose"],
                                   x["obj"])]
    cfg = dict(cfg, refine_iters=3)
    reference = judge.Reference(cfg, SEED, "cpu")
    want = reference.poses(batch)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    gaps = judge.pose_gaps([reference.candidates(batch)],
                           [(0, got[2], got[3], got[4])])
    assert max(gaps.values()) < 1e-4


def test_train_step_agrees_with_the_same_dropout(setup):
    from densefusion_tpu_torch.losses import pose_loss

    cfg, (pn, _), (pr, _), _, x = setup
    outs = []
    for net, plain in ((pn, False), (pr, True)):
        net.train()
        net.zero_grad()
        gen = torch.Generator().manual_seed(5)
        if plain:
            r, t, logit, _ = net(x["img"], x["points"], x["choose"],
                                 x["obj"], generator=gen)
            lo = ref_loss.pose_loss(r, t, logit, x["points"], x["target"],
                                    x["model"], x["sym"], cfg["w"])
        else:
            o = net(x["img"], x["points"], x["choose"], x["obj"],
                    generator=gen)
            lo = pose_loss(o["pred_r"], o["pred_t"], o["pred_c"],
                           x["target"], x["model"], x["points"], x["sym"],
                           cfg["w"], use_adds=True,
                           pred_c_logit=o["pred_c_logit"]).loss
        lo.backward()
        grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        outs.append((float(lo.detach()), grads))
    (lp, gp), (lr, gr) = outs
    assert bool(x["sym"].any()) and not bool(x["sym"].all())
    assert abs(lp - lr) <= 1e-5 * abs(lr)
    for n in gr:
        scale = float(gr[n].norm()) + 1e-12
        assert float((gp[n] - gr[n]).norm()) <= 1e-3 * scale, n


def test_adam_matches_the_ports():
    from densefusion_tpu_torch.train.state import make_optimizer

    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(50, generator=g)
    a, b = p0.clone().requires_grad_(), p0.clone()
    opt, plain = make_optimizer([a], 1e-3), ref_loss.Adam([b], 1e-3)
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        a.grad = grad.clone()
        opt.step()
        plain.step([grad])
    assert torch.allclose(a.detach(), b, rtol=0, atol=1e-7)


def test_distances_agree(setup):
    from densefusion_tpu_torch.eval.metrics import pose_distances

    _, _, _, _, x = setup
    g = torch.Generator().manual_seed(1)
    q = ref.normalize(torch.randn(len(x["obj"]), 4, generator=g))
    t = torch.randn(len(x["obj"]), 3, generator=g) * 0.1 + x["target"][:, 0]
    got = pose_distances(x["model"], q, t, x["target"], x["sym"])
    want = ref_loss.pose_distances(x["model"], q, t, x["target"], x["sym"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("key,value", [("trunk", "resnet34"),
                                       ("psp_in", 256),
                                       ("decoder_widths", [512, 256, 64,
                                                           64])])
def test_widths_the_reference_cannot_build_raise(key, value):
    with pytest.raises((KeyError, ValueError)):
        ref.posenet(dict(tiny.config(), **{key: value}))


def test_the_reference_is_built_at_the_configurations_widths():
    cfg = dict(tiny.config(), decoder_widths=[1024, 128, 32, 16],
               fusion_widths=[32, 64, 256, 512], head_widths=[320, 128, 64],
               refiner_widths=[256, 64])
    net, refiner = ref.posenet(cfg), ref.refiner(cfg)
    assert net.cnn.model.module.up_2.conv[1].weight.shape[:2] == (32, 128)
    assert net.cnn.model.module.final[0].weight.shape[1] == 16
    assert net.feat.conv6.weight.shape[0] == 512
    assert net.conv1_r.weight.shape[:2] == (320, 2 * (32 + 64) + 512)
    assert refiner.conv2_t.weight.shape == (64, 256)
    x = judge.tensors(inputs.make_pool(cfg, tiny.traffic("serve-b64"),
                                       SEED)[0], "cpu")
    with torch.no_grad():
        r, _, _, emb = net.eval()(x["img"], x["points"], x["choose"],
                                  x["obj"])
        assert r.shape[:2] == x["points"].shape[:2]
        assert refiner(x["points"], emb, x["obj"])[0].shape == (4, 4)
