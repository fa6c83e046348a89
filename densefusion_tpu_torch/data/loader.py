"""Host-side batch loading with threaded prefetch (counterpart of
``densefusion_tpu/data/loader.py``).

A true-batch loader: samples are assembled by a thread pool or by fork
workers writing into a shared-memory slot ring, collated into (B, ...)
numpy arrays, and prefetched a few batches ahead so device steps do not
wait on the host. Batches stay numpy; the consumer moves them to the card
(:func:`densefusion_tpu_torch.data.to_device`), so workers never touch
CUDA.

Determinism: the order is a pure function of (seed, epoch), and each
sample's draws of (seed, epoch, index); with a batch cursor this makes a
mid-epoch restart exact.
"""

from __future__ import annotations

import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from densefusion_tpu_torch import native
from densefusion_tpu_torch.data.schema import PoseSample, collate


class _SlotLayout:
    """Byte layout of one fixed-shape PoseSample inside a shared slab.

    Every field of the sample schema has a static shape and dtype for a
    given dataset configuration, so a sample serializes to a fixed slot
    with per-field offsets, with no pickling.
    """

    def __init__(self, template: PoseSample):
        self.fields: list[tuple[str, tuple, np.dtype, int, int]] = []
        off = 0
        for name, arr in zip(template._fields, template):
            a = np.asarray(arr)
            self.fields.append((name, a.shape, a.dtype, off, a.nbytes))
            off += (a.nbytes + 63) & ~63   # 64B-align fields
        self.slot_bytes = off

    def views(self, raw, n_slots: int) -> list[PoseSample]:
        """Per-slot PoseSamples whose fields are numpy views into the slab
        (build once per process; reads/writes are plain numpy copies)."""
        out = []
        for s in range(n_slots):
            base = s * self.slot_bytes
            vals = []
            for _, shape, dtype, off, nb in self.fields:
                count = int(np.prod(shape, dtype=np.int64)) if shape else 1
                flat = np.frombuffer(raw, dtype=dtype, count=count,
                                     offset=base + off)
                vals.append(flat.reshape(shape))
            out.append(PoseSample(*vals))
        return out


class _ProcessPool:
    """Persistent fork-worker pool streaming samples through a shared-memory
    slot ring.

    Fork workers sidestep the GIL that caps a thread pool's per-sample
    Python glue, and the ring avoids pickling ~0.5 MB samples through pipes:
    a slab write is a plain copy. Workers inherit the dataset (and its warm
    decoded-frame cache) copy-on-write at fork time. They run numpy only:
    a worker forked from a process with CUDA up must not touch CUDA.
    """

    def __init__(self, dataset, template: PoseSample, num_workers: int,
                 n_slots: int):
        import multiprocessing as mp

        self._ctx = mp.get_context("fork")
        self.layout = _SlotLayout(template)
        self.n_slots = n_slots
        self._raw = self._ctx.RawArray("b", n_slots * self.layout.slot_bytes)
        self.slots = self.layout.views(self._raw, n_slots)
        self._task_q = self._ctx.Queue()
        self._result_q = self._ctx.Queue()
        self._procs = []
        raw, layout, task_q, result_q = (self._raw, self.layout,
                                         self._task_q, self._result_q)

        def worker_main():
            # fork-inherited: dataset, raw slab, queues; numpy only
            views = layout.views(raw, n_slots)
            cur_epoch = None
            while True:
                task = task_q.get()
                if task is None:
                    return
                slot, epoch, index, tag = task
                try:
                    if epoch != cur_epoch and hasattr(dataset, "set_epoch"):
                        dataset.set_epoch(epoch)
                        cur_epoch = epoch
                    sample = dataset[index]
                    dst = views[slot]
                    for d, s in zip(dst, sample):
                        np.copyto(d, s, casting="same_kind")
                    result_q.put((slot, tag, None))
                except BaseException as e:   # surface in the parent
                    import traceback
                    result_q.put((slot, tag, traceback.format_exc() or str(e)))

        for _ in range(num_workers):
            p = self._ctx.Process(target=worker_main, daemon=True)
            p.start()
            self._procs.append(p)

    def submit(self, slot: int, epoch: int, index: int, tag) -> None:
        self._task_q.put((slot, epoch, index, tag))

    def result(self, timeout: float = 120.0):
        """(slot, tag) of one completed sample; raises on worker errors or
        a dead pool."""
        while True:
            try:
                slot, tag, err = self._result_q.get(timeout=timeout)
            except queue.Empty:
                if not any(p.is_alive() for p in self._procs):
                    raise RuntimeError("loader worker processes died")
                raise
            if err is not None:
                raise RuntimeError(f"loader worker failed:\n{err}")
            return slot, tag

    def close(self) -> None:
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._procs = []


class BatchLoader:
    """``worker_mode``: "thread" assembles samples on a GIL-sharing thread
    pool (safe everywhere, scales to ~1.3x on CPython); "process" uses
    persistent fork workers + a shared-memory sample ring (near-linear
    scaling, linux fork only — falls back to threads elsewhere). Sample
    content is identical in every mode: per-sample RNG is derived from
    (seed, epoch, index), never from worker identity.

    ``shard=(rank, ranks)`` loads one data-parallel rank's rows of each
    global batch of ``batch_size`` (the batches and their order are the
    unsharded loader's): the rank's ``ceil(len / ranks)`` consecutive rows,
    the same samples bit for bit. A batch that the ranks do not divide
    (the last one when ``drop_last=False``) is padded at its end with
    invalid samples (``PoseSample.invalid`` at the dataset's shapes)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 collate_fn: Callable = collate, drop_last: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 worker_mode: str = "thread",
                 shard: tuple[int, int] | None = None):
        if shard is not None and not 0 <= shard[0] < shard[1]:
            raise ValueError(f"shard {shard} is not (rank, ranks)")
        self.shard = shard
        self._pad_sample = None
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        if worker_mode == "process" and not sys.platform.startswith("linux"):
            worker_mode = "thread"
        self.worker_mode = worker_mode
        self._pool: _ProcessPool | None = None

    def close(self) -> None:
        """Shut down process workers (no-op for thread mode)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _ensure_pool(self) -> _ProcessPool:
        if self._pool is None:
            # the host library is built and loaded here, so the workers
            # inherit it; the template probes the dataset's static shapes;
            # fork AFTER the probe so workers inherit a consistent state
            native.available()
            template = self.dataset[0]
            n_slots = 2 * self.batch_size + 4 * self.num_workers
            self._pool = _ProcessPool(self.dataset, template,
                                      self.num_workers, n_slots)
        return self._pool

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batch_indices(self, epoch: int = 0) -> list[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        n_full = len(order) // self.batch_size
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_full)]
        rem = order[n_full * self.batch_size:]
        if rem.size and not self.drop_last:
            batches.append(rem)
        return batches

    def _rank_rows(self, idx: np.ndarray) -> tuple[np.ndarray, int]:
        """This rank's dataset indices of one global batch, and the
        invalid rows that pad them to the rank's share."""
        rank, ranks = self.shard
        per = -(-len(idx) // ranks)
        mine = idx[rank * per:(rank + 1) * per]
        return mine, per - len(mine)

    def _collate(self, samples: list, pad: int):
        if pad:
            if self._pad_sample is None:
                s = self.dataset[0]
                self._pad_sample = PoseSample.invalid(
                    s.points.shape[0], s.target.shape[0], s.img.shape[0])
            samples = samples + [self._pad_sample] * pad
        return self.collate_fn(samples)

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator:
        """Iterate batches of one epoch, optionally resuming mid-epoch."""
        if hasattr(self.dataset, "set_epoch"):
            # per-sample RNG derives from (seed, epoch, index): thread-safe
            # and bit-reproducible regardless of worker scheduling
            self.dataset.set_epoch(epoch)
        batches = self.batch_indices(epoch)[start_batch:]
        pads = [0] * len(batches)
        if self.shard is not None:
            batches, pads = zip(*map(self._rank_rows, batches)) \
                if batches else ((), ())
        if self.num_workers <= 1:
            for idx, pad in zip(batches, pads):
                yield self._collate([self.dataset[int(i)] for i in idx], pad)
            return
        if self.worker_mode == "process":
            yield from self._epoch_process(batches, pads, epoch)
            return
        # sliding-window submission: the next batches' samples assemble in
        # the pool WHILE the current batch is collated/consumed — a per-batch
        # pool.map barrier serialized collate against assembly and capped
        # throughput well below the pool's sample rate
        ahead = 2
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: list[list] = []
            next_batch = 0

            def submit(idx):
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in idx]

            while next_batch < len(batches) and len(pending) <= ahead:
                pending.append(submit(batches[next_batch]))
                next_batch += 1
            for pad in pads:
                futs = pending.pop(0)
                if next_batch < len(batches):
                    pending.append(submit(batches[next_batch]))
                    next_batch += 1
                yield self._collate([f.result() for f in futs], pad)

    def _epoch_process(self, batches: list[np.ndarray], pads: list[int],
                       epoch: int) -> Iterator:
        """Stream one epoch through the fork-worker sample ring: tasks are
        issued in order as slots free up; batches are yielded strictly in
        order once all their samples have landed in the slab."""
        pool = self._ensure_pool()
        tasks = [(b, j, int(i)) for b, idx in enumerate(batches)
                 for j, i in enumerate(idx)]
        free = list(range(pool.n_slots))
        landed: dict[int, dict[int, int]] = {}   # batch -> {pos: slot}
        next_task = 0
        next_yield = 0
        in_flight = 0
        try:
            while next_yield < len(batches):
                while free and next_task < len(tasks):
                    b, j, i = tasks[next_task]
                    pool.submit(free.pop(), epoch, i, (b, j))
                    next_task += 1
                    in_flight += 1
                if in_flight:   # none when the next batches are padding
                    slot, (b, j) = pool.result()
                    in_flight -= 1
                    landed.setdefault(b, {})[j] = slot
                while (next_yield < len(batches)
                       and len(landed.get(next_yield, ())) ==
                       len(batches[next_yield])):
                    got = landed.pop(next_yield, {})
                    slots = [got[j] for j in range(len(got))]
                    # collate copies out of the slab (np.stack), so the
                    # slots can be recycled as soon as the batch is built
                    batch = self._collate([pool.slots[s] for s in slots],
                                          pads[next_yield])
                    free.extend(slots)
                    next_yield += 1
                    yield batch
        finally:
            # abandoned mid-epoch (consumer break / exception): drain the
            # in-flight results so the ring is clean for the next epoch
            for _ in range(in_flight):
                try:
                    pool.result()
                except RuntimeError:
                    break

    def __iter__(self):
        return self.epoch(0)


class PrefetchIterator:
    """Run an iterator in a background thread, keeping `depth` items ready."""

    _END = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                self._q.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
