"""Shape-bucketed eval dispatch for native (ladder-shape) crops (counterpart
of ``densefusion_tpu/eval/bucketed.py``).

The reference feeds the network variable-size crops snapped to a 40-px
ladder; for imported reference weights that input geometry is part of the
contract. Samples of differing shapes cannot share a batch, so this
dispatcher groups them by crop shape and runs full batches per shape.
Results are scattered back to caller-supplied keys, so the caller keeps
frame order whatever the dispatch order.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

from densefusion_tpu_torch.data.schema import PoseSample, collate


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class ShapeBucketedDispatcher:
    """Buffers (key, sample) pairs per crop shape; runs ``run_fn`` on a full
    batch of one shape (a short remainder is padded by repeating its first
    sample, whose extra results are dropped).

    ``run_fn(batch: PoseSample) -> tuple`` of arrays or tensors with the
    batch as leading dimension. ``add`` / ``flush_all`` return completed
    ``(key, per_sample_outputs)`` pairs, numpy.
    """

    def __init__(self, run_fn: Callable[[PoseSample], Sequence[Any]],
                 batch_size: int = 8):
        self.run_fn = run_fn
        self.batch_size = batch_size
        self.pending: dict[tuple[int, int], list] = {}
        self.shapes_dispatched: set[tuple[int, int]] = set()

    def add(self, key: Hashable, sample: PoseSample):
        shape = tuple(sample.img.shape[:2])
        buf = self.pending.setdefault(shape, [])
        buf.append((key, sample))
        if len(buf) >= self.batch_size:
            return self._flush(shape)
        return []

    def _flush(self, shape):
        buf = self.pending.pop(shape, [])
        if not buf:
            return []
        self.shapes_dispatched.add(shape)
        samples = [s for _, s in buf]
        samples += [samples[0]] * (self.batch_size - len(samples))
        outs = [_to_numpy(o) for o in self.run_fn(collate(samples))]
        return [(buf[i][0], tuple(o[i] for o in outs))
                for i in range(len(buf))]

    def flush_all(self):
        done = []
        for shape in sorted(self.pending):
            done += self._flush(shape)
        return done
