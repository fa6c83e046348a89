"""Port parity: the batch loader (``densefusion_tpu_torch.data.loader``)
against ``densefusion_tpu.data.loader``: the same batch order for the same
(seed, epoch), identical batches from every worker mode (and from the JAX
loader over the JAX reader, both native libraries on, and both off),
mid-epoch resume, errors raised in the consumer, and the decoded-frame
cache under threads."""

import sys
import threading

import numpy as np
import pytest

import densefusion_tpu.native as jnative
import densefusion_tpu_torch.native as tnative
from densefusion_tpu.data import loader as jloader
from densefusion_tpu.data import ycb as jycb

from densefusion_tpu_torch.data import (
    BatchLoader, PoseSample, PrefetchIterator, YCBDataset,
    generate_ycb_style_dataset,
)
from densefusion_tpu_torch.data import loader as loader_mod
from densefusion_tpu_torch.data.cache import ImageCache
from densefusion_tpu_torch.data.loader import _SlotLayout

KW = dict(num_points=128, crop_size=48)


@pytest.fixture(scope="module")
def ycb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ycb_loader"))
    generate_ycb_style_dataset(root, n_classes=3, n_real=5, n_syn=6,
                               n_test=1, seed=1)
    return root


@pytest.fixture(scope="module")
def ycb_ds(ycb_root):
    return YCBDataset(ycb_root, "train", cache_frames=64, **KW)


def _epoch(loader, epoch, start=0):
    return list(loader.epoch(epoch, start_batch=start))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f, x, y in zip(a._fields, a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("seed,epoch,shuffle,drop_last", [
    (0, 0, True, True), (0, 1, True, False), (3, 7, True, True),
    (11, 2, False, False), (5, 123, True, False)])
def test_batch_order_matches_jax(seed, epoch, shuffle, drop_last):
    ds = _Sized(23)
    ours = BatchLoader(ds, 4, shuffle=shuffle, drop_last=drop_last,
                       seed=seed)
    theirs = jloader.BatchLoader(ds, 4, shuffle=shuffle, drop_last=drop_last,
                                 seed=seed)
    got, want = ours.batch_indices(epoch), theirs.batch_indices(epoch)
    assert len(got) == len(want) == len(ours) == len(theirs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    order = np.arange(23)
    if shuffle:   # the order is default_rng((seed, epoch)).shuffle
        np.random.default_rng((seed, epoch)).shuffle(order)
    np.testing.assert_array_equal(np.concatenate(got),
                                  order[:20] if drop_last else order)


def _worker_modes_match_jax(ycb_root, ycb_ds):
    """One worker, a thread pool and fork workers give the same batches,
    and so does the JAX loader over the JAX reader."""
    mk = lambda **kw: BatchLoader(ycb_ds, 4, drop_last=False, seed=2, **kw)
    want = _epoch(mk(num_workers=1), 1)
    _assert_batches_equal(_epoch(mk(num_workers=3), 1), want)
    proc = mk(num_workers=3, worker_mode="process")
    assert proc.worker_mode == "process"
    try:
        _assert_batches_equal(_epoch(proc, 1), want)
        _assert_batches_equal(_epoch(proc, 1), want)   # the pool again
    finally:
        proc.close()
    jds = jycb.YCBDataset(ycb_root, "train", **KW)
    _assert_batches_equal(
        _epoch(jloader.BatchLoader(jds, 4, drop_last=False, seed=2,
                                   num_workers=1), 1), want)
    assert all(b.valid.any() for b in want)


def test_worker_modes_give_identical_batches(ycb_root, ycb_ds):
    """Both native libraries on (each package's default): every worker
    mode's batches, and the JAX loader's, exactly equal."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    _worker_modes_match_jax(ycb_root, ycb_ds)


def test_worker_modes_give_identical_batches_without_library(
        ycb_root, ycb_ds, monkeypatch):
    """Both libraries off (the fork workers inherit the patch): the numpy
    paths' batches, every worker mode and the JAX loader's, equal."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    _worker_modes_match_jax(ycb_root, ycb_ds)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_start_batch_resumes_the_epoch(ycb_ds, mode):
    loader = BatchLoader(ycb_ds, 3, num_workers=2, seed=4, worker_mode=mode)
    try:
        full = _epoch(loader, 1)
        _assert_batches_equal(_epoch(loader, 1, start=1), full[1:])
        assert _epoch(loader, 1, start=len(full)) == []
    finally:
        loader.close()


def test_abandoned_epoch_leaves_the_ring_clean(ycb_ds):
    proc = BatchLoader(ycb_ds, 4, num_workers=2, seed=1,
                       worker_mode="process")
    try:
        it = proc.epoch(0)
        next(it)
        it.close()            # the consumer stops mid-epoch
        _assert_batches_equal(
            _epoch(proc, 1),
            _epoch(BatchLoader(ycb_ds, 4, num_workers=1, seed=1), 1))
    finally:
        proc.close()


class _Broken:
    """Samples 0-3 are real, 4 on raise."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i >= 4:
            raise ValueError(f"boom at {i}")
        return self.ds[0]


@pytest.mark.parametrize("mode,workers", [("thread", 1), ("thread", 2),
                                          ("process", 2)])
def test_worker_exception_reaches_the_consumer(ycb_ds, mode, workers):
    loader = BatchLoader(_Broken(ycb_ds), 4, shuffle=False,
                         num_workers=workers, worker_mode=mode)
    try:
        if mode == "process":
            # the ring runs ahead, so the failure may come before batch 0;
            # the worker's traceback is raised in the parent
            with pytest.raises(RuntimeError, match="ValueError: boom at"):
                _epoch(loader, 0)
        else:
            it = loader.epoch(0)
            assert next(it).valid.shape == (4,)
            with pytest.raises(ValueError, match="boom at 4"):
                next(it)
    finally:
        loader.close()


def test_prefetch_iterator_keeps_order_and_reraises():
    assert list(PrefetchIterator(iter(range(10)), depth=2)) == list(range(10))

    def failing():
        yield 1
        yield 2
        raise KeyError("from the producer")

    it = PrefetchIterator(failing(), depth=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="from the producer"):
        next(it)


def test_process_mode_falls_back_to_threads_off_linux(ycb_ds, monkeypatch):
    monkeypatch.setattr(loader_mod.sys, "platform", "darwin")
    assert BatchLoader(ycb_ds, 4, worker_mode="process").worker_mode == \
        "thread"
    with pytest.raises(ValueError, match="worker_mode"):
        BatchLoader(ycb_ds, 4, worker_mode="fibers")


def test_slot_layout_round_trip(rng):
    template = PoseSample.invalid(17, 23, 8)
    layout = _SlotLayout(template)
    assert layout.slot_bytes % 64 == 0
    import multiprocessing as mp
    views = layout.views(mp.get_context("fork").RawArray(
        "b", 3 * layout.slot_bytes), 3)
    sample = PoseSample(
        points=rng.standard_normal((17, 3)).astype(np.float32),
        choose=rng.integers(0, 64, 17).astype(np.int32),
        img=rng.standard_normal((8, 8, 3)).astype(np.float32),
        target=rng.standard_normal((23, 3)).astype(np.float32),
        model_points=rng.standard_normal((23, 3)).astype(np.float32),
        obj_idx=np.asarray(5, np.int32), sym=np.asarray(True),
        valid=np.asarray(True))
    for d, s in zip(views[1], sample):
        np.copyto(d, s)
    for f, d, s in zip(sample._fields, views[1], sample):
        np.testing.assert_array_equal(d, s, err_msg=f)
        assert d.dtype == s.dtype
    assert not np.any(views[0].img) and not np.any(views[2].img)


def test_image_cache_under_threads(tmp_path):
    """Eight threads load four frames through a two-entry cache with a
    short switch interval: every load returns the decoded frame, every load
    counts once as a hit or a miss, and the cache stays within capacity."""
    from PIL import Image

    frames = {}
    for k in range(4):
        path = str(tmp_path / f"{k}.png")
        arr = np.full((6, 5, 3), 40 * k, np.uint8)
        Image.fromarray(arr).save(path)
        frames[path] = arr
    cache = ImageCache(2)
    errors, loads = [], 8 * 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(seed):
            r = np.random.default_rng(seed)
            for p in r.choice(sorted(frames), 200):
                if not np.array_equal(cache.load(p), frames[p]):
                    errors.append(p)
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert cache.hits + cache.misses == loads and len(cache._store) <= 2
    with pytest.raises(ValueError):
        cache.load(sorted(frames)[0])[0, 0, 0] = 1   # entries are frozen
