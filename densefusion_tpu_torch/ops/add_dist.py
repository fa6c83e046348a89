"""Fused ADD / ADD-S mean distance per pose hypothesis, with its gradient.

Counterpart of ``densefusion_tpu/ops/add_dist.py``. For every hypothesis
``(R_n, t_n)`` of a sample, with ``q_m = R_n model_m + t_n``,

    dis[b, n] = mean_m sqrt(max(||q_m - tgt_m||^2, EPS))            (ADD)
    dis[b, n] = mean_m sqrt(max(||q_m - target_k*(m)||^2, EPS))     (ADD-S)

where ``k*(m)`` is ``q_m``'s nearest target point (ties to the lowest
index). Beside the value each row carries 12 gradient coefficients,
``A_cj = sum_m u_c model_j / M`` and ``s_c = sum_m u_c / M`` with
``u = (q - tgt) / d`` (zero where ``d^2 <= EPS``): the loss reads ``dis``
through per-hypothesis weights only, so ``d dis / d R_n = A`` and
``d dis / d t_n = s`` are the whole backward. The (B, N, M, 3) transformed
cloud is never kept.

The two TPU kernels, ``_paired_kernel``
(``densefusion_tpu/ops/add_dist.py:116``) and ``_min_kernel`` (``:221``),
become the hand-written Hopper kernels of ``csrc/add_dist.cu``; beside
their wrappers here are their plain PyTorch versions, which the CPU tests
use and which ``chip_smoke.py`` holds the kernels against on the card.
:class:`HypothesisMeanDist` launches the kernels for CUDA tensors and the
plain versions for CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from densefusion_tpu_torch.ops import build
from densefusion_tpu_torch.ops.knn import _nearest

EPS = 1e-12  # squared-distance floor: 1 um distance, zero gradient below

# Hypotheses per chunk of the plain versions are capped so one (B, chunk, M)
# block holds at most this many elements.
_CHUNK_ELEMS = 1 << 22
# Model points per chunk of the min kernel's partial sums (partial is (S, B,
# N, 13), S = ceil(M / chunk)): MIN_CHUNK in csrc/add_dist.cu.
MIN_CHUNK = 128


def _transform(R: torch.Tensor, t: torch.Tensor,
               model: torch.Tensor) -> torch.Tensor:
    """R (B, Nc, 3, 3), t (B, Nc, 3), model (B, M, 3) -> q (B, Nc, M, 3),
    ``q_c = ((R_c0 m_0 + R_c1 m_1) + R_c2 m_2) + t_c``, one rounded
    elementwise operation at a time, in the order the kernels round it."""
    mx, my, mz = (model[..., j][:, None, :] for j in range(3))
    return torch.stack([R[:, :, c, 0, None] * mx + R[:, :, c, 1, None] * my
                        + R[:, :, c, 2, None] * mz + t[:, :, c, None]
                        for c in range(3)], dim=-1)


def _dist_coef(diff: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """diff (B, Nc, M, 3), model (B, M, 3) -> (B, Nc, 13): the mean distance,
    then ``A_cj`` at ``1 + 3c + j`` and ``s_c`` at ``10 + c``."""
    dx, dy, dz = diff.unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    d2f = d2.clamp_min(EPS)
    inv_d = torch.where(d2 > EPS, torch.rsqrt(d2f), 0.0)
    u = diff * inv_d[..., None]
    a = torch.einsum("bnmc,bmj->bncj", u, model).flatten(2)
    return torch.cat([torch.sqrt(d2f).sum(-1, keepdim=True), a, u.sum(2)],
                     dim=-1) / diff.shape[2]


def _plain(R, t, model, target, act, nearest: bool):
    R, t, model, target = R.float(), t.float(), model.float(), target.float()
    b, n = R.shape[:2]
    m = model.shape[1]
    step = max(1, _CHUNK_ELEMS // max(1, b * m))
    rows = []
    for s in range(0, n, step):
        q = _transform(R[:, s:s + step], t[:, s:s + step], model)
        if nearest:
            _, idx = _nearest(q.reshape(b, -1, 3), target)
            tgt = torch.gather(target, 1, idx[..., None].expand(-1, -1, 3))
            tgt = tgt.reshape(q.shape)
        else:
            tgt = target[:, None]
        rows.append(_dist_coef(q - tgt, model))
    out = torch.cat(rows, dim=1) if rows else R.new_zeros((b, 0, 13))
    keep = act.to(device=R.device, dtype=torch.bool)
    out = torch.where(keep[:, None, None], out, 0.0)
    return out[..., 0], out[..., 1:]


def paired_plain(R, t, model, target, act):
    """Plain version of the paired (ADD) kernel: R (B, N, 3, 3), t (B, N, 3),
    model / target (B, M, 3), act (B,) -> (dis (B, N), coef (B, N, 12));
    rows with ``act == 0`` are zeros."""
    return _plain(R, t, model, target, act, nearest=False)


def min_plain(R, t, model, target, act):
    """Plain version of the min (ADD-S) kernel: as :func:`paired_plain`, the
    target of each transformed model point being its nearest target point.
    The search's scores are ``knn._scores``, rounded as the kernel rounds
    them, so both pick the same winner."""
    return _plain(R, t, model, target, act, nearest=True)


class AddDistKernel(build.Kernel):
    """ctypes wrapper of one kernel of ``csrc/add_dist.cu``. ``chunk`` is the
    model points per partial sum of a kernel that needs the scratch
    ``partial`` (the min kernel); None for one that writes ``out`` in one
    launch (the paired kernel)."""

    def __init__(self, name: str, symbol: str, chunk: int | None):
        scratch = chunk is not None
        super().__init__(name, "add_dist", symbol,
                         [ctypes.c_void_p] * (6 + scratch)
                         + [ctypes.c_int] * (3 + scratch))
        self.chunk = chunk

    def __call__(self, R, t, model, target, act):
        """R (B, N, 3, 3), t (B, N, 3), model / target (B, M, 3) float32 and
        act (B,) int32, contiguous CUDA tensors on one device ->
        (dis (B, N), coef (B, N, 12)) float32."""
        dev = build.cuda_device(self.name, R, t, model, target, act)
        bsz, n = R.shape[:2]
        m = model.shape[1] if model.dim() == 3 else 0
        want = {"R": (bsz, n, 3, 3), "t": (bsz, n, 3), "model": (bsz, m, 3),
                "target": (bsz, m, 3)}
        for name, x in (("R", R), ("t", t), ("model", model),
                        ("target", target)):
            if x.dtype != torch.float32 or not x.is_contiguous() \
                    or tuple(x.shape) != want[name]:
                raise ValueError(
                    f"{self.name} kernel: {name} must be a contiguous float32 "
                    f"{want[name]} tensor, got {x.dtype} {tuple(x.shape)}")
        if act.dtype != torch.int32 or tuple(act.shape) != (bsz,) \
                or not act.is_contiguous():
            raise ValueError(f"{self.name} kernel: act must be a contiguous "
                             f"int32 ({bsz},) tensor")
        if not 1 <= bsz <= 65535 or n > 65535 or m < 1:
            raise ValueError(f"{self.name} kernel: need 1 <= B <= 65535, "
                             f"N <= 65535 and M >= 1, got B={bsz} N={n} M={m}")
        out = torch.empty((bsz, n, 13), dtype=torch.float32, device=dev)
        if n == 0:
            return out[..., 0], out[..., 1:]
        ptrs = [x.data_ptr() for x in (R, t, model, target, act)]
        if self.chunk is None:
            self.launch(dev, *ptrs, out.data_ptr(), bsz, n, m)
        else:
            splits = -(-m // self.chunk)
            partial = torch.empty((splits, bsz, n, 13), dtype=torch.float32,
                                  device=dev)
            self.launch(dev, *ptrs, partial.data_ptr(), out.data_ptr(), bsz,
                        n, m, splits)
        return out[..., 0], out[..., 1:]


paired_kernel = AddDistKernel("add_dist_paired", "add_dist_paired_launch",
                              None)
min_kernel = AddDistKernel("add_dist_min", "add_dist_min_launch", MIN_CHUNK)


def paired_split(bsz: int, n: int) -> tuple[int, int]:
    """(threads per hypothesis, hypotheses per thread) that the paired
    kernel takes for B rows of n hypotheses (``nn_scan::paired_split``):
    above one thread, that many threads split each hypothesis's model points
    and merge their sums. Needs the card."""
    fn = build.load("add_dist").add_dist_paired_split
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    hyps = ctypes.c_int(0)
    threads = fn(bsz, n, ctypes.byref(hyps))
    return threads, hyps.value


def dist_and_coef(R, t, model, target, sym, use_adds: bool = True):
    """(dis (B, N), coef (B, N, 12)) of every hypothesis. Both kernels run
    over the whole batch, each gated per row (paired on ``~sym``, min on
    ``sym``), and the results combine as ``where(sym, min, paired)``; the
    host never reads ``sym``. CUDA tensors launch the kernels (which raise
    if they cannot build or launch), CPU tensors take the plain versions."""
    cuda = R.device.type == "cuda"
    paired, nearest = ((paired_kernel, min_kernel) if cuda
                       else (paired_plain, min_plain))
    R, t = R.float().contiguous(), t.float().contiguous()
    model, target = model.float().contiguous(), target.float().contiguous()
    sym_i = sym.to(device=R.device, dtype=torch.int32).contiguous()
    act = 1 - sym_i if use_adds else torch.ones_like(sym_i)
    dis, coef = paired(R, t, model, target, act)
    if use_adds:
        dis_s, coef_s = nearest(R, t, model, target, sym_i)
        keep = sym_i.bool()
        dis = torch.where(keep[:, None], dis_s, dis)
        coef = torch.where(keep[:, None, None], coef_s, coef)
    return dis, coef


class HypothesisMeanDist(torch.autograd.Function):
    """Mean ADD(-S) distance per hypothesis, differentiable in (R, t). The
    forward keeps the 12 coefficients; the backward is ``g * coef``
    (``_fused_bwd``, ``densefusion_tpu/ops/add_dist.py:421``). model,
    target and sym are data and get no gradient."""

    @staticmethod
    def forward(ctx, R, t, model, target, sym, use_adds):
        dis, coef = dist_and_coef(R, t, model, target, sym, use_adds)
        ctx.save_for_backward(coef)
        return dis

    @staticmethod
    def backward(ctx, g):
        (coef,) = ctx.saved_tensors
        gc = g[..., None] * coef
        b, n = gc.shape[:2]
        return gc[..., :9].reshape(b, n, 3, 3), gc[..., 9:], None, None, \
            None, None


def hypothesis_mean_dist(R: torch.Tensor, t: torch.Tensor,
                         model: torch.Tensor, target: torch.Tensor,
                         sym: torch.Tensor, *,
                         use_adds: bool = True) -> torch.Tensor:
    """Mean ADD(-S) distance of every hypothesis, differentiable in (R, t).

    R (B, N, 3, 3) rotations, t (B, N, 3) absolute translations, model
    (B, M, 3) canonical points, target (B, M, 3) ground-truth-posed points,
    sym (B,) bool rows where ADD-S applies (ignored when ``use_adds`` is
    False) -> (B, N). The float32 casts sit outside the autograd Function,
    so a lower-precision input gets its gradient back in its own type."""
    return HypothesisMeanDist.apply(R.float(), t.float(), model.float(),
                                    target.float(), sym, use_adds)
