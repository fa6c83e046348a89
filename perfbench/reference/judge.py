"""The comparison that decides ``correct``: the plain reference run on the
same weights and inputs the program got, and the numbers that hold the
program's outputs against it.

Served poses. Each row's pose comes from the hypothesis of highest
confidence, and with random weights two of a thousand confidences can lie
closer together than float32 rounding, so which one wins is not a property
of the program. Every hypothesis whose reference confidence is within
``TIE_BAND`` of the row's best is a candidate; the reference refines each,
and a returned pose is judged against the candidate it is closest to. The
confidence the program returns is judged against the best confidence.

Training. The reference follows the program's first steps from the same
weights, batches and dropout draws (the same device generator seed and the
same ``torch.bernoulli`` calls in the same order): the first step's loss
(:func:`train_gaps` says why), the worst parameter's first gradient and
the worst parameter's change over the steps, each norm as the gap between
the two against the larger of the reference's norm and the median
parameter's. Parameters whose reference gradient is under a thousandth of
the median one's move under Adam by round-off alone and are left out of
the change.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import loss as ref_loss
from perfbench.reference import model as ref

# twice the cells' confidence limit: a program whose confidences are within
# the limit picks a hypothesis inside the band
TIE_BAND = 1.6e-5


@contextlib.contextmanager
def tf32():
    """Matmuls and cuDNN convolutions in TF32: the control's precision."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tensors(batch, device):
    """A pool batch (numpy) as the reference's tensors."""
    f = lambda k, dt=torch.float32: torch.as_tensor(batch[k], dtype=dt,
                                                    device=device)
    return {"img": f("img"), "points": f("points"),
            "choose": f("choose", torch.long), "obj": f("obj_idx", torch.long),
            "target": f("target"), "model": f("model_points"),
            "sym": f("sym", torch.bool)}


class Reference:
    """The reference networks with the run's weights, on ``device``."""

    def __init__(self, cfg, seed, device):
        full_f32()
        self.cfg, self.device = cfg, device
        sd_p, sd_r = inputs.model_weights(cfg, seed, device)
        self.posenet, self.refiner = ref.posenet(cfg), ref.refiner(cfg)
        for net, sd in ((self.posenet, sd_p), (self.refiner, sd_r)):
            net.load_state_dict(sd)
            net.to(device).eval()

    @torch.no_grad()
    def poses(self, batch):
        """The reference's own pipeline -> numpy (q0, t0, q, t, conf)."""
        x = tensors(batch, self.device)
        q_all, t_all, conf, emb = ref.hypotheses(
            self.posenet, x["img"], x["points"], x["choose"], x["obj"])
        best = conf.argmax(1)
        rows = torch.arange(len(best), device=best.device)
        q0, t0 = q_all[rows, best], t_all[rows, best]
        q, t = ref.refine(self.refiner, self.cfg["refine_iters"], q0, t0,
                          x["points"], emb, x["obj"])
        return tuple(v.cpu().numpy() for v in
                     (q0, t0, q, t, conf[rows, best]))

    @torch.no_grad()
    def candidates(self, batch, chunk=512):
        """Every row's candidate hypotheses (confidence within
        :data:`TIE_BAND` of the best), unrefined and refined (``chunk``
        candidates at a time), with the ADD(-S) distances of both poses, as
        numpy: ``rows`` (C,), ``q0`` / ``t0`` / ``q`` / ``t`` (C, 4 or 3),
        ``d0`` / ``d`` (C,), and the rows' best confidences ``best``
        (B,)."""
        x = tensors(batch, self.device)
        q_all, t_all, conf, emb = ref.hypotheses(
            self.posenet, x["img"], x["points"], x["choose"], x["obj"])
        best = conf.max(1).values
        rows, idx = (conf >= best[:, None] - TIE_BAND).nonzero(as_tuple=True)
        q0, t0 = q_all[rows, idx], t_all[rows, idx]
        parts = []
        for s in range(0, len(rows), chunk):
            r = rows[s:s + chunk]
            parts.append(ref.refine(self.refiner, self.cfg["refine_iters"],
                                    q0[s:s + chunk], t0[s:s + chunk],
                                    x["points"][r], emb[r], x["obj"][r]))
        q, t = (torch.cat([p[i] for p in parts]) for i in (0, 1))
        d0, d = (ref_loss.pose_distances(
            x["model"][rows], qq, tt, x["target"][rows], x["sym"][rows])
            for qq, tt in ((q0, t0), (q, t)))
        return {k: v.cpu().numpy() for k, v in
                (("rows", rows), ("q0", q0), ("t0", t0), ("q", q), ("t", t),
                 ("d0", d0), ("d", d), ("best", best))}

    def distances(self, batch, q, t):
        """ADD(-S) of the poses (numpy) on the batch's objects, from TF32
        operands while TF32 is switched on (the control)."""
        x = tensors(batch, self.device)
        d = ref_loss.pose_distances(
            x["model"], torch.as_tensor(q, device=self.device),
            torch.as_tensor(t, device=self.device), x["target"], x["sym"],
            tf32=torch.backends.cuda.matmul.allow_tf32)
        return d.cpu().numpy()


def _qgap(a, b):
    """Largest component gap of quaternions, sign-aligned (q and -q are
    one rotation)."""
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def pose_gaps(per_batch, outputs):
    """The largest gaps of the returned poses over every request.

    ``outputs`` holds (pool index, q, t, conf) per request, or (pool index,
    q0, t0, q, t, conf, d0, d) with the unrefined poses and the distances
    of both, which are held to the reference's distances of the candidate
    each row matched, relative to them. -> {"q_gap", "t_gap", "conf_gap"}
    (+ "q0_gap", "t0_gap", "dis_gap")."""
    gaps = {}

    def worst(name, value):
        gaps[name] = max(gaps.get(name, 0.0), float(value))

    for out in outputs:
        k = out[0]
        c = per_batch[k]
        rows = c["rows"]
        if len(out) == 4:
            q, t, conf = out[1:]
            err_q, err_t = _qgap(q[rows], c["q"]), \
                np.abs(t[rows] - c["t"]).max(-1)
            err = np.maximum(err_q, err_t)
        else:
            q0, t0, q, t, conf, d0, d = out[1:]
            e0q, e0t = _qgap(q0[rows], c["q0"]), \
                np.abs(t0[rows] - c["t0"]).max(-1)
            err_q, err_t = _qgap(q[rows], c["q"]), \
                np.abs(t[rows] - c["t"]).max(-1)
            err = np.maximum.reduce([e0q, e0t, err_q, err_t])
        # per row, the candidate the returned pose is closest to
        order = np.lexsort((err, rows))
        first = order[np.r_[True, rows[order][1:] != rows[order][:-1]]]
        if len(first) != len(conf):
            raise ValueError("a row has no candidate")
        worst("q_gap", err_q[first].max())
        worst("t_gap", err_t[first].max())
        worst("conf_gap", np.abs(conf - c["best"]).max())
        if len(out) > 4:
            worst("q0_gap", e0q[first].max())
            worst("t0_gap", e0t[first].max())
            for dp, dr in ((d0, c["d0"][first]), (d, c["d"][first])):
                worst("dis_gap", (np.abs(dp - dr) / dr).max())
    return gaps


# -- training ----------------------------------------------------------------

def train_steps(cfg, seed, pool, device, steps, half_batch=False):
    """The reference's first ``steps`` phase-1 steps on pool batches 0, 1,
    ... -> (losses, first gradient norms {name: norm}, change norms {name:
    norm}). ``half_batch`` is a planted fault: the loss of the first half
    of each batch only."""
    sd_p, _ = inputs.model_weights(cfg, seed, device)
    net = ref.posenet(cfg)
    net.load_state_dict(sd_p)
    net.to(device).train()
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in params]
    adam = ref_loss.Adam(params, cfg["lr"])
    gen = torch.Generator(device=device).manual_seed(
        inputs.stream(seed, inputs.DROPOUT))
    losses, grad_norms = [], None
    for s in range(steps):
        x = tensors(pool[s % len(pool)], device)
        pr, pt, logit, _ = net(x["img"], x["points"], x["choose"], x["obj"],
                               generator=gen)
        rows = slice(0, len(pr) // 2 if half_batch else len(pr))
        lo = ref_loss.pose_loss(pr[rows], pt[rows], logit[rows],
                                x["points"][rows], x["target"][rows],
                                x["model"][rows], x["sym"][rows], cfg["w"])
        grads = torch.autograd.grad(lo, params)
        if grad_norms is None:
            grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
        adam.step(grads)
        losses.append(float(lo.detach()))
    change = {n: float((p.detach() - p0).norm())
              for n, p, p0 in zip(names, params, start)}
    return losses, grad_norms, change


def norm_gaps(prog: dict, ref_norms: dict, keep=None) -> list:
    """Each parameter's gap between two norms, against the larger of the
    reference's norm and the median parameter's."""
    names = [n for n in ref_norms if keep is None or keep(n)]
    med = float(np.median([ref_norms[n] for n in names]))
    return [abs(prog[n] - ref_norms[n]) / max(ref_norms[n], med)
            for n in names]


def leaf_detail(prog, ref_norms, top=3):
    """The parameters with the largest gaps (name, gap, reference norm over
    the median's): what a calibration looks at."""
    med = float(np.median(list(ref_norms.values())))
    gaps = sorted(((abs(prog[n] - r) / max(r, med), n, r / med)
                   for n, r in ref_norms.items()), reverse=True)[:top]
    return [[n, g, rel] for g, n, rel in gaps]


def _moved(r_grads):
    """The rule that keeps a parameter in the change: a reference gradient
    of a thousandth of the median parameter's or more."""
    med = float(np.median(list(r_grads.values())))
    return lambda n: r_grads[n] >= 1e-3 * med


def train_gaps(prog, ref_result):
    """(losses, gradient norms, change norms) of the program against the
    reference's -> {"loss_gap", "grad_gap", "change_gap"}: the first
    step's loss, the worst parameter's first gradient and the worst
    parameter's change after the steps. The later losses carry the float32
    backward's run-to-run noise (cuDNN's sums have no fixed order), which
    Adam's normalised steps amplify: their gaps spread over two decades from
    seed to seed, while the first step's stay steady. The same noise puts
    the worst change near the TF32 control's, so the control is caught by
    the loss and the gradient, and the change catches a state left
    unchanged (1), one parameter left unchanged or moved double
    (:func:`one_leaf_unchanged` and more) and half of the batch left
    out."""
    losses, grads, change = prog
    r_losses, r_grads, r_change = ref_result
    return {"loss_gap": abs(losses[0] - r_losses[0]) / abs(r_losses[0]),
            "grad_gap": max(norm_gaps(grads, r_grads)),
            "change_gap": max(norm_gaps(change, r_change,
                                        _moved(r_grads)))}


def one_leaf_unchanged(ref_result, top=6):
    """What ``change_gap`` reads where a step leaves one parameter of the
    change unchanged (the reference's change against the larger of itself
    and the median parameter's), for the ``top`` parameters where it reads
    least: [name, reading] from the least up."""
    _, r_grads, r_change = ref_result
    zero = dict.fromkeys(r_change, 0.0)
    keep = _moved(r_grads)
    names = [n for n in r_change if keep(n)]
    gaps = norm_gaps(zero, r_change, keep)
    return sorted(([n, g] for n, g in zip(names, gaps)),
                  key=lambda x: x[1])[:top]
