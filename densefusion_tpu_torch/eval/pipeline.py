"""Estimate + iterative-refine inference (counterpart of
``densefusion_tpu/eval/pipeline.py``).

PoseNet forward, argmax-confidence hypothesis selection, then K refiner
iterations composed as quaternions on the device. The JAX package's
``lax.scan`` over iterations is a Python loop here.
"""

from __future__ import annotations

import torch

from densefusion_tpu_torch.device import resolve_device
from densefusion_tpu_torch.geometry import (
    quat_normalize, quat_to_matrix, quat_multiply, quat_rotate,
)
from densefusion_tpu_torch.utils.profiling import span


class InferencePipeline:
    """Batched pose inference with a PoseNet and an optional PoseRefineNet
    (their weights loaded by the caller).

    Usage::

        pipe = InferencePipeline(posenet, refiner, refine_iters=2)
        quat, trans, conf = pipe(img, points, choose, obj)

    ``return_unrefined=True`` returns ``(q0, t0, q, t, conf)``: the
    argmax-confidence hypothesis before refinement beside the refined pose.
    The modules are moved to ``device`` (``None`` means CUDA; see
    :func:`densefusion_tpu_torch.device.resolve_device`) and set to eval mode.
    """

    def __init__(self, posenet, refiner=None, refine_iters: int = 0,
                 return_unrefined: bool = False, device=None):
        if refine_iters > 0 and refiner is None:
            raise ValueError("refine_iters > 0 requires a refiner")
        self.device = resolve_device(device)
        self.posenet = posenet.to(self.device).eval()
        self.refiner = (None if refiner is None
                        else refiner.to(self.device).eval())
        self.refine_iters = refine_iters
        self.return_unrefined = return_unrefined

    @torch.no_grad()
    def __call__(self, img, points, choose, obj):
        """img (B, H, W, 3), points (B, N, 3), choose (B, N), obj (B,):
        numpy arrays or tensors, moved to the pipeline's device."""
        with span("pipeline.run", units=len(obj)):
            with span("pipeline.inputs"):
                inputs = pipeline_inputs(img, points, choose, obj,
                                         self.device)
            return self._infer(*inputs)

    def _infer(self, img, points, choose, obj):
        """The pure program on tensors already on the pipeline's device (the
        counterpart of ``densefusion_tpu/eval/pipeline.py:47-83``):
        ``densefusion_tpu_torch.export`` traces it with the K iterations
        unrolled."""
        out = self.posenet(img, points, choose, obj)
        q_all = quat_normalize(out["pred_r"])                # (B, N, 4)
        t_all = points + out["pred_t"]                       # (B, N, 3)
        conf = out["pred_c"]                                 # (B, N)
        best = conf.argmax(dim=1)
        rows = torch.arange(conf.shape[0], device=conf.device)
        q0, t0, best_conf = q_all[rows, best], t_all[rows, best], \
            conf[rows, best]

        q, t = q0, t0
        for _ in range(self.refine_iters):
            with span("pipeline.refine"):
                # canonicalize the cloud into the current pose frame:
                # p' = (p - t) @ R == R^T (p - t)
                new_points = (points - t[:, None, :]) @ quat_to_matrix(q)
                res = self.refiner(new_points, out["emb"], obj)
                q2 = quat_normalize(res["pred_r"])
                # pose composition T <- T @ T2
                q, t = quat_multiply(q, q2), \
                    quat_rotate(q, res["pred_t"]) + t
        if self.return_unrefined:
            return q0, t0, q, t, best_conf
        return q, t, best_conf


def pipeline_inputs(img, points, choose, obj, device) -> tuple:
    """The pipeline's four inputs (numpy arrays or tensors) as the tensors
    its program takes, on ``device``: img and points float32, choose and
    obj int64."""
    return (torch.as_tensor(img, dtype=torch.float32, device=device),
            torch.as_tensor(points, dtype=torch.float32, device=device),
            torch.as_tensor(choose, device=device).long(),
            torch.as_tensor(obj, device=device).long())
