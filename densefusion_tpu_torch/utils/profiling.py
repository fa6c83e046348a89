"""Profiling hooks: per-step wall-clock timing and ``torch.profiler``
traces (counterpart of ``densefusion_tpu/utils/profiling.py``).

:class:`StepTimer` is the JAX package's, host clock only: it does not
synchronise the card, so a step that returns before its work is done must
end with a sync (or a read of its result) inside the timed region.
:func:`trace_context` captures any region, CPU and (where there is a card)
CUDA activity, as a TensorBoard trace.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class StepTimer:
    """Tracks step wall-clock times; report median/p90 & throughput."""

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self, skip_warmup: int = 1) -> dict:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        med = float(np.median(t))
        return {
            "steps": len(t),
            "median_s": med,
            "p90_s": float(np.percentile(t, 90)),
            "items_per_s": self.items_per_step / med if med > 0 else 0.0,
        }


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """A ``torch.profiler`` trace of the region (CPU activity, and CUDA's
    where this build has it), written into ``log_dir`` as
    ``<worker>.<time>.pt.trace.json``, which TensorBoard's profiler plugin
    and ``chrome://tracing`` read; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, supported_activities,
        tensorboard_trace_handler,
    )

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
