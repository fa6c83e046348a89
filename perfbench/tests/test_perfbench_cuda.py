"""On the card, at a small size: the cells' program comes out correct and
the control (the reference in the program's place with TF32 on) does not.
Marked ``cuda``; each test decides for itself whether there is a card.
Run there with

    python -m pytest --noconftest -o addopts="" -m cuda perfbench/tests
"""

import time

import pytest
import torch

from perfbench.harness import Bench, run_cell, within_limits
from perfbench.tests import tiny

pytestmark = pytest.mark.cuda
WORKLOADS = ["ycb-serve-b64", "linemod-eval-k4-b32", "ycb-train-p1-b32",
             "linemod-train-p1-b32"]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small(bench, workload):
    w = bench.workload(workload)
    cfg = tiny.config(w["config"])
    cfg.update(crop_size=96, num_points=256, num_mesh_points=128)
    trf = tiny.traffic(w["traffic"])
    trf.update(batch=8)
    return cfg, trf


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_program_is_correct_on_the_card(workload):
    need_card()
    bench = Bench()
    cfg, trf = small(bench, workload)
    r = run_cell(bench, workload, 31_415_926_535, 1.0, True,
                 time.perf_counter(), device="cuda", config=cfg,
                 traffic=trf, limits=bench.limits(workload))
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(workload, seed):
    need_card()
    bench = Bench()
    cfg, trf = small(bench, workload)
    drv = bench.driver(trf["kind"]).Driver(cfg, trf, seed, "cuda")
    correct, checks = within_limits(drv.control(), bench.limits(workload))
    assert correct is False, checks
