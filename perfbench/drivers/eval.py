"""Scored evaluation: what ``cli/eval_linemod.py`` does per batch, from the
port's public calls: ``InferencePipeline(..., return_unrefined=True)``,
then ``pose_distances`` of the unrefined and the refined poses, read to the
host. A closed loop over the pool's collated batches. Judged by the poses
and distances every request returned against the plain reference's."""

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
        self.outputs = []   # (pool index, q0, t0, q, t, conf, d0, d)

    def setup(self):
        from densefusion_tpu_torch.eval import InferencePipeline
        from densefusion_tpu_torch.models import PoseNet, PoseRefineNet

        cfg = self.cfg
        t = time.perf_counter()
        self.pool = inputs.make_pool(cfg, self.traffic, self.seed)
        self.setup_phases = {"pool": time.perf_counter() - t}
        t = time.perf_counter()
        sd_p, sd_r = inputs.model_weights(cfg, self.seed, self.device)
        with self.device:    # default init on the device, then replaced
            posenet = PoseNet(cfg["num_obj"], emb_dim=cfg["emb_dim"])
            refiner = PoseRefineNet(cfg["num_obj"], emb_dim=cfg["emb_dim"])
        posenet.load_state_dict(sd_p, strict=True)
        refiner.load_state_dict(sd_r, strict=True)
        del sd_p, sd_r
        self.pipe = InferencePipeline(
            posenet, refiner, refine_iters=cfg["refine_iters"],
            return_unrefined=True, device=self.device)
        self.setup_phases["model"] = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(self.traffic["warmup"]):
            self.request(i)
        self.setup_phases["warmup"] = time.perf_counter() - t
        self.outputs.clear()

    def request(self, i):
        from densefusion_tpu_torch.eval.metrics import pose_distances

        k = i % len(self.pool)
        b = self.pool[k]
        q0, t0, q, t, conf = self.pipe(b["img"], b["points"], b["choose"],
                                       b["obj_idx"])
        model, target, sym = (torch.as_tensor(b[f], device=self.device)
                              for f in ("model_points", "target", "sym"))
        d0 = pose_distances(model, q0, t0, target, sym)
        d = pose_distances(model, q, t, target, sym)
        self.outputs.append((k, *(x.cpu().numpy() for x in
                                  (q0, t0, q, t, conf, d0, d))))

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
        del self.pipe

    def check(self):
        ref = judge.Reference(self.cfg, self.seed, self.device)
        per_batch = [ref.candidates(b) for b in self.pool]
        return judge.pose_gaps(per_batch, self.outputs)

    def control(self):
        """The reference in the program's place, with TF32 on (its poses
        and its distances): one request per pool batch."""
        self.pool = inputs.make_pool(self.cfg, self.traffic, self.seed)
        ref = judge.Reference(self.cfg, self.seed, self.device)
        with judge.tf32():
            for k, b in enumerate(self.pool):
                q0, t0, q, t, conf = ref.poses(b)
                self.outputs.append((k, q0, t0, q, t, conf,
                                     ref.distances(b, q0, t0),
                                     ref.distances(b, q, t)))
        return self.check()
