"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: an answer altered where it is produced, a
step that leaves the state unchanged, or one parameter of it unchanged or
moved double, half of the batch left out with the mean taken over the rest. (No cell spans chips, so no exchange between
chips can be left out.) The harness's look for a card is skipped: the
cells run at a small size on the CPU through the rest of a run."""

import time

import pytest
import torch

from perfbench.harness import Bench, run_cell
from perfbench.tests import tiny


def run(workload):
    bench = Bench()
    w = bench.workload(workload)
    return run_cell(bench, workload, 9_876_543_210, 0.5, False,
                    time.perf_counter(), device="cpu",
                    config=tiny.config(w["config"]),
                    traffic=tiny.traffic(w["traffic"]),
                    limits=tiny.limits())


@pytest.mark.parametrize("workload", ["ycb-serve-b64",
                                      "linemod-eval-k4-b32"])
def test_a_pose_altered_where_it_is_made(workload, monkeypatch):
    from densefusion_tpu_torch.eval.pipeline import InferencePipeline

    infer = InferencePipeline._infer

    def altered(self, *args):
        out = list(infer(self, *args))
        out[-2] = out[-2] + torch.tensor([1e-3, 0.0, 0.0])  # translation
        return tuple(out)

    monkeypatch.setattr(InferencePipeline, "_infer", altered)
    r = run(workload)
    assert r["correct"] is False
    assert r["checks"]["t_gap"]["value"] > r["checks"]["t_gap"]["limit"]


def test_a_distance_altered_where_it_is_made(monkeypatch):
    import densefusion_tpu_torch.eval.metrics as metrics

    dist = metrics.pose_distances
    monkeypatch.setattr(metrics, "pose_distances",
                        lambda *a: dist(*a) * (1 + 1e-3))
    r = run("linemod-eval-k4-b32")
    assert r["correct"] is False
    assert r["checks"]["dis_gap"]["value"] > r["checks"]["dis_gap"]["limit"]


@pytest.mark.parametrize("workload", ["ycb-train-p1-b32",
                                      "linemod-train-p1-b32"])
def test_a_step_that_leaves_the_state_unchanged(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)
    r = run(workload)
    assert r["correct"] is False
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["ycb-train-p1-b32",
                                      "linemod-train-p1-b32"])
@pytest.mark.parametrize("scale", [0.0, 2.0])
@pytest.mark.parametrize("leaf", ["conv1_r.weight", "feat.conv5.bias"])
def test_one_parameter_left_unchanged_or_moved_double(workload, scale, leaf,
                                                      monkeypatch):
    from densefusion_tpu_torch.models import PoseNet

    names = [n for n, _ in PoseNet(4).named_parameters()]
    index = names.index(leaf)
    step = torch.optim.Adam.step

    def faulty(self, *args, **kw):
        p = self.param_groups[0]["params"][index]
        before = p.detach().clone()
        out = step(self, *args, **kw)
        with torch.no_grad():
            p.copy_(before + scale * (p - before))
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", faulty)
    r = run(workload)
    assert r["correct"] is False
    c = r["checks"]["change_gap"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("workload", ["ycb-train-p1-b32",
                                      "linemod-train-p1-b32"])
def test_half_the_batch_left_out(workload, monkeypatch):
    import densefusion_tpu_torch.train.steps as steps

    loss = steps.pose_loss

    def half(*args, sample_weight=None, **kw):
        sw = sample_weight.clone()
        sw[len(sw) // 2:] = 0.0
        return loss(*args, sample_weight=sw, **kw)

    monkeypatch.setattr(steps, "pose_loss", half)
    r = run(workload)
    assert r["correct"] is False
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("workload", ["ycb-serve-b64", "linemod-eval-k4-b32",
                                      "ycb-train-p1-b32",
                                      "linemod-train-p1-b32"])
def test_the_unbroken_path_is_correct(workload):
    assert run(workload)["correct"] is True
