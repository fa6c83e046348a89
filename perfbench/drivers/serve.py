"""Serving: one caller of the port's ``PoseEstimator.estimate_batch`` in a
closed loop, each request a batch of detections from the pool, its poses
numpy on the host when it returns. Judged by the poses every request
returned against the plain reference's."""

from __future__ import annotations

import time

import torch

from perfbench import counts, inputs
from perfbench.harness import closed_loop, require_precision
from perfbench.reference import judge


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        require_precision(cfg, {("float32", False)})
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.outputs = []       # (pool index, quat, trans, conf) per request

    def setup(self):
        from densefusion_tpu_torch.data import PoseSample
        from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
        from densefusion_tpu_torch.serve import PoseEstimator

        cfg = self.cfg
        t = time.perf_counter()
        self.pool = inputs.make_pool(cfg, self.traffic, self.seed)
        self.setup_phases = {"pool": time.perf_counter() - t}
        t = time.perf_counter()
        self.requests = [
            [PoseSample(**{k: v[i] for k, v in batch.items()})
             for i in range(self.traffic["batch"])] for batch in self.pool]
        sd_p, sd_r = inputs.model_weights(cfg, self.seed, self.device)
        with self.device:    # default init on the device, then replaced
            posenet = PoseNet(cfg["num_obj"], emb_dim=cfg["emb_dim"])
            refiner = PoseRefineNet(cfg["num_obj"], emb_dim=cfg["emb_dim"])
        self.est = PoseEstimator(
            posenet, refiner, sd_p, sd_r, num_points=cfg["num_points"],
            crop_size=cfg["crop_size"], refine_iters=cfg["refine_iters"],
            device=self.device)
        del sd_p, sd_r
        self.setup_phases["model"] = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(self.traffic["warmup"]):
            self.request(i)
        self.setup_phases["warmup"] = time.perf_counter() - t
        self.outputs.clear()

    def request(self, i):
        k = i % len(self.requests)
        q, t, c, _ = self.est.estimate_batch(self.requests[k])
        self.outputs.append((k, q, t, c))

    def flops_per_unit(self):
        """The reference's FLOPs of one pose at this cell's shapes."""
        return counts.inference_flops(self.cfg, self.traffic["batch"],
                                      self.cfg["refine_iters"])

    def window(self, seconds):
        return closed_loop(self.request, seconds, self.traffic["batch"])

    def traced(self):
        n = self.traffic["traced_requests"]
        start = len(self.outputs)
        for i in range(start, start + n):
            self.request(i)
        return n * self.traffic["batch"]

    def release(self):
        del self.est
        self.requests = None

    def check(self):
        ref = judge.Reference(self.cfg, self.seed, self.device)
        per_batch = [ref.candidates(b) for b in self.pool]
        return judge.pose_gaps(per_batch, self.outputs)

    def control(self):
        """The reference in the program's place, with TF32 on: one
        request per pool batch, judged as the program's are."""
        self.pool = inputs.make_pool(self.cfg, self.traffic, self.seed)
        ref = judge.Reference(self.cfg, self.seed, self.device)
        with judge.tf32():
            self.outputs = [(k, *ref.poses(b)[2:]) for k, b in
                            enumerate(self.pool)]
        return self.check()
