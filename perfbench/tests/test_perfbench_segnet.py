"""The SegNet cell on the CPU at a small size (the reference's 2, 2, 3, 3,
3 encoder layers at widths up to 16, 64x96 frames, B=2, seeded weights):
the plain reference against the port's SegNet and training step, the
reference's refusals and FLOP count, the driver through the harness, its
spans and its judgement of planted faults.

Tolerances. The port's BatchNorm takes the one-pass variance (``mean(x^2)
- mean(x)^2``), the reference's the two-pass one, and their sums run in
other orders: logits within 1e-5 of the largest in eval mode and 5e-5 in
train mode, the first loss within 1e-6. The steps are judged as the cell
judges them, over norms (``seg_gaps``): the worst first gradient and the
worst running statistic within 1e-2 (BatchNorm's scale and shift
gradients sum terms that mostly cancel; five seeds read up to 2.1e-3 and
2.3e-3), the worst change after three Adam steps within the cell's own
limit, 0.3 (Adam moves an element whose gradient is noise by lr either
way; five seeds read up to 0.106). The harness's runs are held to the
cell's own limits file.
"""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, seg_inputs, spans
from perfbench.harness import Bench, run_cell
from perfbench.reference import segnet as ref

SEED = 6_022_140_857
CELL = "segnet-ycb-train-b3"
ENC = [[8, 8], [12, 12], [16, 16, 16], [16, 16, 16], [16, 16, 16]]
DEC = [[16, 16, 16], [16, 16, 16], [16, 16, 12], [12, 8], [8]]
LIMITS = Bench().limits(CELL)


def config():
    cfg = Bench().config("segnet-ycb")
    cfg.update(height=64, width=96, enc_stages=ENC, dec_stages=DEC)
    return cfg


def traffic():
    t = Bench().traffic("seg-train-b3")
    t.update(batch=2, pool=2, traced_steps=1)
    return t


@pytest.fixture(scope="module")
def setup():
    from densefusion_tpu_torch.models import SegNet

    cfg, trf = config(), traffic()
    sd = seg_inputs.segnet_weights(cfg, SEED, "cpu")
    port = SegNet(cfg["num_classes"], ENC, DEC)
    port.load_state_dict(sd)
    plain = ref.segnet(cfg)
    plain.load_state_dict(sd)
    return cfg, trf, sd, port, plain, seg_inputs.make_pool(cfg, trf, SEED,
                                                           "cpu")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("mode,tol", [("eval", 1e-5), ("train", 5e-5)])
def test_the_networks_agree(setup, mode, tol):
    _, _, sd, port, plain, pool = setup
    port, plain = copy.deepcopy(port), copy.deepcopy(plain)
    x = pool[0]["rgb"]
    with torch.no_grad():
        got = getattr(port, mode)()(x)
        want = getattr(plain, mode)()(x)
    assert got.shape == (2, 22, 64, 96)
    assert rel(got, want) <= tol
    if mode == "train":
        pb, rb = dict(port.named_buffers()), dict(plain.named_buffers())
        assert pb.keys() == rb.keys() and len(rb) == 2 * 25
        gaps = ref.stats_gaps(pb, rb)
        assert max(gaps.values()) <= 1e-5
        assert float(rb["bn11.running_mean"].abs().max()) > 0


def test_three_steps_agree(setup):
    from densefusion_tpu_torch.models import SegNet
    from densefusion_tpu_torch.train.seg import (
        create_seg_train_state, make_seg_train_step,
    )

    cfg, trf, sd, _, _, pool = setup
    state = create_seg_train_state(SegNet(cfg["num_classes"], ENC, DEC),
                                   lr=cfg["lr"], device="cpu")
    state.segnet.load_state_dict(sd)
    step = make_seg_train_step(state, fg_weight=cfg["fg_weight"])
    names = [n for n, _ in state.segnet.named_parameters()]
    losses, grads = [], None
    for s in range(3):
        losses.append(float(step(pool[s % 2]["rgb"], pool[s % 2]["label"])))
        if grads is None:
            grads = {n: p.grad.norm().item()
                     for n, p in state.segnet.named_parameters()}
    change = {n: float((p.detach() - sd[n]).norm())
              for n, p in state.segnet.named_parameters()}
    stats = {n: b.clone() for n, b in state.segnet.named_buffers()}
    want = ref.train_steps(cfg, SEED, pool, "cpu", 3)
    r_losses, r_grads = want[:2]
    assert list(r_grads) == names
    assert abs(losses[0] - r_losses[0]) <= 1e-6 * r_losses[0]
    assert losses[2] < losses[0]
    gaps = ref.seg_gaps((losses, grads, change, stats), want)
    assert gaps["grad_gap"] <= 1e-2 and gaps["stats_gap"] <= 1e-2
    assert gaps["change_gap"] <= 0.3
    # the pre-BatchNorm conv biases have no gradient but round-off
    med = sorted(r_grads.values())[len(r_grads) // 2]
    biases = [n for n in names if n.startswith("conv") and
              n.endswith(".bias") and n != "conv11d.bias"]
    assert len(biases) == 25
    assert all(r_grads[n] < 1e-4 * med for n in biases)


@pytest.mark.parametrize("enc,dec,match", [
    (ENC, DEC[:4], "as many decoder stages"),
    (ENC, [[16, 16, 16, 16]] + DEC[1:], "encoder stage it unpools has 3"),
    (ENC, [[16, 16, 16], [16, 16, 24]] + DEC[2:], "unpools a 24-wide"),
    (ENC, DEC[:4] + [[]], "1-9 convolutions"),
], ids=["stages", "deeper", "wider", "empty"])
def test_widths_the_reference_cannot_build_raise(enc, dec, match):
    cfg = dict(config(), enc_stages=enc, dec_stages=dec)
    with pytest.raises(ValueError, match=match):
        ref.segnet(cfg)
    with pytest.raises(ValueError, match=match):
        ref.train_flops(cfg)


def test_the_flop_count():
    cfg = Bench().config("segnet-ycb")
    layers = ref.conv_layers(cfg)
    assert len(layers) == 26
    # by hand: conv11, 3 -> 64 channels at 480x640; the classifier, 64 ->
    # 22 at the same size
    assert layers[0] == (480, 640, 3, 64) and layers[-1] == (480, 640, 64,
                                                              22)
    first = 2 * 9 * 480 * 640 * 3 * 64
    forward = sum(2 * 9 * h * w * a * b for h, w, a, b in layers)
    assert ref.train_flops(cfg) == 3 * forward - first
    assert ref.train_flops(cfg) == pytest.approx(1.1466e12, rel=1e-4)
    # torch's own count of the reference's forward and backward on meta
    # tensors: the same products
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = ref.segnet(cfg)
        x = torch.empty(1, 3, 480, 640)
        label = torch.zeros(1, 480, 640, dtype=torch.long)
    with FlopCounterMode(display=False) as counter:
        torch.nn.functional.cross_entropy(net(x), label).backward()
    assert counter.get_total_flops() == ref.train_flops(cfg)


def tiny_run(traced=False):
    return run_cell(Bench(), CELL, SEED, 1.0, traced, time.perf_counter(),
                    device="cpu", config=config(), traffic=traffic(),
                    limits=LIMITS)


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_correct_through_the_harness(traced):
    bench = Bench()
    r = tiny_run(traced)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(LIMITS) and r["failed"] == 0
    expected = {m["name"] for m in bench.metrics_of(CELL, traced)}
    if traced:
        # no device time on the CPU: the host's span and the share remain
        assert set(r["metrics"]) == {"seg_step_host_ms.train",
                                     "mfu_pct.train"}
        assert set(r["metrics"]) <= expected
    else:
        assert set(r["metrics"]) == expected == {"train_samples_per_s",
                                                 "setup_s"}


def test_the_limits_file_holds_every_check_and_its_readings():
    limits = Bench().limits(CELL)
    assert set(limits) == set(LIMITS)
    raw = harness._json(Bench().here / "limits" / f"{CELL}.json")["checks"]
    for name, c in raw.items():
        assert c["lower"] < c["limit"] < c["upper"], name


def test_half_the_batch_left_out(monkeypatch):
    import densefusion_tpu_torch.train.seg as seg

    loss = seg.segmentation_loss

    def half(logits, label, weights=None):
        n = len(logits) // 2
        return loss(logits[:n], label[:n], weights)

    monkeypatch.setattr(seg, "segmentation_loss", half)
    r = tiny_run()
    assert r["correct"] is False
    for name in ("loss_gap", "grad_gap"):
        c = r["checks"][name]
        assert c["value"] > c["limit"], name


def test_the_drivers_half_batch_fault_is_judged_incorrect():
    bench = Bench()
    drv = bench.driver("seg_train").Driver(config(), traffic(), SEED, "cpu")
    gaps = drv.control(half_batch=True)
    ok, _ = harness.within_limits(gaps, LIMITS)
    assert not ok and gaps["grad_gap"] > LIMITS["grad_gap"]


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)
    r = tiny_run()
    assert r["correct"] is False
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_running_statistics_left_unchanged(monkeypatch):
    from densefusion_tpu_torch.models import segnet

    forward = segnet.BatchNorm2d.forward

    def frozen(self, x):
        saved = (self.running_mean.clone(), self.running_var.clone())
        out = forward(self, x)
        with torch.no_grad():
            self.running_mean.copy_(saved[0])
            self.running_var.copy_(saved[1])
        return out

    monkeypatch.setattr(segnet.BatchNorm2d, "forward", frozen)
    r = tiny_run()
    assert r["correct"] is False
    c = r["checks"]["stats_gap"]
    assert c["value"] > c["limit"]


def test_the_spans_count_the_segments_work():
    from densefusion_tpu_torch.utils.profiling import clear_spans

    bench = Bench()
    trf = dict(traffic(), traced_steps=2)
    drv = bench.driver("seg_train").Driver(config(), trf, 5_000_000_011,
                                           "cpu")
    drv.setup()
    clear_spans()
    trace = harness.profile(drv.traced, host=False)
    harness.profile(drv.traced, host=True)     # the harness's second segment
    run = SimpleNamespace(trace=trace)
    records = spans.segment(run)
    roots = [r for r in records if r["name"] == "seg.step"]
    assert len(roots) == 2
    assert sum(r["units"] for r in roots) == trace.units
    per = spans.host_ms_per(run, "seg.step")
    assert per is not None and per > 0
    names = {r["name"] for r in records}
    assert {"segnet.encoder", "segnet.decoder", "seg.backward"} <= names
