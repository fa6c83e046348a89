"""Phase-1 training: the port's ``make_pose_train_step`` (ADD / ADD-S loss,
one Adam step on the PoseNet) over one ``TrainState``, its steps issued
back to back on a pool of batches that lives on the device.

Set-up builds the state from the seed's weights and takes its first
``checked_steps`` steps through the same step function on pool batches 0,
1, ... (all rows differ): the loss of each, each parameter's first
gradient as Adam holds it after step 1 (its first moment over 1 - b1), and
each parameter's change after the last of them, read before the window's
first step moves it. The same state then runs the window. A step counts
when its completion event on the device lies inside the window; the host
adds no sync between steps and reads the losses once the window has
closed."""

from __future__ import annotations

import time

import torch

from perfbench import counts, inputs
from perfbench.harness import Window, require_precision
from perfbench.reference import judge


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        require_precision(cfg, {("float32", False)})
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)

    def setup(self):
        from densefusion_tpu_torch.data import PoseSample, to_device
        from densefusion_tpu_torch.device import resolve_device
        from densefusion_tpu_torch.models import PoseNet, PoseRefineNet
        from densefusion_tpu_torch.train.state import (
            TrainState, make_optimizer,
        )
        from densefusion_tpu_torch.train.steps import make_pose_train_step

        cfg = self.cfg
        # the port's device policy, as create_train_state applies it
        dev = self.device = resolve_device(self.device)
        t = time.perf_counter()
        self.pool = inputs.make_pool(cfg, self.traffic, self.seed)
        self.setup_phases = {"pool": time.perf_counter() - t}
        t = time.perf_counter()
        self.batches = [to_device(PoseSample(**b), dev) for b in self.pool]
        sd_p, sd_r = inputs.model_weights(cfg, self.seed, dev)
        with self.device:    # default init on the device, then replaced
            posenet = PoseNet(cfg["num_obj"], emb_dim=cfg["emb_dim"])
            refiner = PoseRefineNet(cfg["num_obj"], emb_dim=cfg["emb_dim"])
        posenet.load_state_dict(sd_p, strict=True)
        refiner.load_state_dict(sd_r, strict=True)
        del sd_r
        posenet.to(dev)
        refiner.to(dev)
        gen = torch.Generator(device=dev).manual_seed(
            inputs.stream(self.seed, inputs.DROPOUT))
        self.state = TrainState(
            step=0, posenet=posenet, refiner=refiner,
            optimizer=make_optimizer(posenet.parameters(), cfg["lr"]),
            generator=gen)
        self.step = make_pose_train_step(self.state, use_adds=True)
        self.i = 0
        self.setup_phases["model"] = time.perf_counter() - t
        t = time.perf_counter()
        self.checked = self._first_steps(sd_p)
        self.setup_phases["checked_steps"] = time.perf_counter() - t
        del sd_p

    def _first_steps(self, start):
        """The checked steps -> (losses, first gradient norms, change
        norms), as floats."""
        named = list(self.state.posenet.named_parameters())
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        losses, grads = [], None
        for _ in range(self.traffic["checked_steps"]):
            losses.append(self._issue()["loss"])
            if grads is None:   # a step that kept no moment moved nothing
                st = self.state.optimizer.state
                grads = torch.stack([
                    st[p]["exp_avg"].norm() / (1 - b1) if "exp_avg" in
                    st.get(p, {}) else p.new_zeros(()) for _, p in named])
        change = torch.stack([(p.detach() - start[n].to(p.device)).norm()
                              for n, p in named])
        names = [n for n, _ in named]
        return ([float(x) for x in torch.stack(losses).cpu()],
                dict(zip(names, grads.cpu().tolist())),
                dict(zip(names, change.cpu().tolist())))

    def _issue(self):
        out = self.step(self.batches[self.i % len(self.batches)],
                        self.cfg["w"])
        self.i += 1
        return out

    def flops_per_unit(self):
        """The reference's FLOPs of one sample's phase-1 step at this
        cell's shapes."""
        return counts.pose_train_flops(self.cfg, self.traffic["batch"])

    def window(self, seconds):
        cuda = self.device.type == "cuda"
        win = Window(seconds)
        losses, done = [], []
        if cuda:
            torch.cuda.synchronize()
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            losses.append(self._issue()["loss"])
            win.attempted += 1
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                done.append(ev)
            else:
                done.append(time.perf_counter() + seconds - end)
        if cuda:
            torch.cuda.synchronize()
            done = [begin.elapsed_time(ev) / 1e3 for ev in done]
        finite = torch.isfinite(torch.stack(losses)).cpu() if losses else []
        win.failed = int(sum(not bool(f) for f in finite))
        steps = sum(1 for t in done if t <= seconds)
        win.units = steps * self.traffic["batch"]
        return win

    def traced(self):
        n = self.traffic["traced_steps"]
        for _ in range(n):
            self._issue()
        return n * self.traffic["batch"]

    def release(self):
        del self.state, self.step, self.batches

    def _reference(self, **kw):
        return judge.train_steps(self.cfg, self.seed, self.pool, self.device,
                                 self.traffic["checked_steps"], **kw)

    def check(self):
        judge.full_f32()
        return judge.train_gaps(self.checked, self._reference())

    def detail(self):
        """Per-step loss gaps, the parameters with the largest gradient and
        change gaps, and the least that a step leaving one parameter
        unchanged would read in the change: what a calibration looks at."""
        judge.full_f32()
        (losses, grads, change), ref = self.checked, self._reference()
        r_losses, r_grads, r_change = ref
        return {"loss_steps": [abs(a - b) / abs(b)
                               for a, b in zip(losses, r_losses)],
                "grad_top": judge.leaf_detail(grads, r_grads),
                "change_top": judge.leaf_detail(change, r_change),
                "one_leaf_unchanged": judge.one_leaf_unchanged(ref)}

    def control(self, half_batch=False):
        """The reference in the program's place with TF32 on (or, with
        ``half_batch``, in float32 with half of each batch left out),
        judged as the program is."""
        self.pool = inputs.make_pool(self.cfg, self.traffic, self.seed)
        if half_batch:
            judge.full_f32()
            self.checked = self._reference(half_batch=True)
        else:
            with judge.tf32():
                self.checked = self._reference()
        return self.check()
