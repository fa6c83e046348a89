"""SegNet training: the port's ``make_seg_train_step`` (per-pixel
cross-entropy, one Adam step, BatchNorm on the batch's statistics) on the
port's ``SegNet`` at the configuration's widths, over the state
``create_seg_train_state`` makes, as ``cli.train_seg`` runs them; its
steps issued back to back on a pool of full frames that lives on the
device.

Set-up loads the seed's weights into the state and takes its first
``checked_steps`` steps through the same step function on pool batches 0,
1, ...: the loss of each, each parameter's first gradient as Adam holds it
after step 1 (its first moment over 1 - b1), each parameter's change and
each BatchNorm running statistic after the last of them, read before the
window's first step moves them. The same state then runs the window,
timed and traced as the phase-1 driver (``drivers/train.py``) times and
traces its steps: a step counts when its completion event on the device
lies inside the window; the host adds no sync between steps and reads the
losses once the window has closed."""

from __future__ import annotations

import time

import torch

from perfbench import seg_inputs
from perfbench.drivers import train
from perfbench.reference import judge
from perfbench.reference import segnet as ref


class Driver(train.Driver):
    """``__init__`` (float32 with TF32 off only), ``window`` and ``traced``
    are the phase-1 driver's."""

    def setup(self):
        from densefusion_tpu_torch.models import SegNet
        from densefusion_tpu_torch.train.seg import (
            create_seg_train_state, make_seg_train_step,
        )

        cfg = self.cfg
        t = time.perf_counter()
        # the port's device policy and Adam, as cli.train_seg builds them;
        # its fresh weights are then replaced by the seed's
        self.state = create_seg_train_state(
            SegNet(cfg["num_classes"], cfg["enc_stages"], cfg["dec_stages"]),
            lr=cfg["lr"], device=self.device)
        dev = self.device = next(self.state.segnet.parameters()).device
        sd = seg_inputs.segnet_weights(cfg, self.seed, dev)
        self.state.segnet.load_state_dict(sd, strict=True)
        self.step = make_seg_train_step(self.state,
                                        fg_weight=cfg["fg_weight"])
        self.setup_phases = {"model": time.perf_counter() - t}
        t = time.perf_counter()
        self.pool = seg_inputs.make_pool(cfg, self.traffic, self.seed, dev)
        self.i = 0
        self.setup_phases["pool"] = time.perf_counter() - t
        t = time.perf_counter()
        self.checked = self._first_steps(sd)
        self.setup_phases["checked_steps"] = time.perf_counter() - t

    def _first_steps(self, start):
        """The checked steps -> (losses, first gradient norms, change
        norms, running statistics)."""
        net = self.state.segnet
        named = list(net.named_parameters())
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        losses, grads = [], None
        for _ in range(self.traffic["checked_steps"]):
            losses.append(self._issue()["loss"])
            if grads is None:   # a step that kept no moment moved nothing
                st = self.state.optimizer.state
                grads = torch.stack([
                    st[p]["exp_avg"].norm() / (1 - b1) if "exp_avg" in
                    st.get(p, {}) else p.new_zeros(()) for _, p in named])
        change = torch.stack([(p.detach() - start[n]).norm()
                              for n, p in named])
        names = [n for n, _ in named]
        return ([float(x) for x in torch.stack(losses).cpu()],
                dict(zip(names, grads.cpu().tolist())),
                dict(zip(names, change.cpu().tolist())),
                {n: b.detach().to("cpu", copy=True)
                 for n, b in net.named_buffers()})

    def _issue(self):
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        return {"loss": self.step(batch["rgb"], batch["label"])}

    def flops_per_unit(self):
        """The reference's FLOPs of one frame's training step at the
        configuration's widths and frame size."""
        return ref.train_flops(self.cfg)

    def release(self):
        del self.state, self.step

    def _reference(self, **kw):
        return ref.train_steps(self.cfg, self.seed, self.pool, self.device,
                               self.traffic["checked_steps"], **kw)

    def check(self):
        judge.full_f32()
        return ref.seg_gaps(self.checked, self._reference())

    def detail(self):
        """Per-step loss gaps, the parameters and statistics with the
        largest gaps, and the least that a step leaving one parameter
        unchanged would read in the change: what a calibration looks at."""
        judge.full_f32()
        (losses, grads, change, stats), r = self.checked, self._reference()
        top = sorted(ref.stats_gaps(stats, r[3]).items(),
                     key=lambda kv: -kv[1])[:3]
        return {"loss_steps": [abs(a - b) / abs(b)
                               for a, b in zip(losses, r[0])],
                "grad_top": judge.leaf_detail(grads, r[1]),
                "change_top": judge.leaf_detail(change, r[2]),
                "stats_top": [list(kv) for kv in top],
                "one_leaf_unchanged": judge.one_leaf_unchanged(r[:3])}

    def control(self, half_batch=False):
        """The reference in the program's place with TF32 on (or, with
        ``half_batch``, in float32 with half of each batch's frames left
        out of the loss), judged as the program is."""
        self.pool = seg_inputs.make_pool(self.cfg, self.traffic, self.seed,
                                         self.device)
        if half_batch:
            judge.full_f32()
            self.checked = self._reference(half_batch=True)
        else:
            with judge.tf32():
                self.checked = self._reference()
        return self.check()
