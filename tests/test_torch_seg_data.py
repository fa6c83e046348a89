"""Port parity: the segmentation datasets (``data/seg.py``).

One root per format (the generators are held equal in
``tests/test_torch_data.py``): a 4-class YCB-format set at 480x640 with 3
real and 3 synthetic training frames, and a LineMOD set of objects 1 and
10. With both packages' native libraries on (each one's default: the
color jitter in the library's fused pass) and with both off (the numpy
jitter), every field of every sample is equal, over several (epoch,
index), in train mode (jitter, background composite, the two flips) and
test mode, and a thread-worker ``BatchLoader`` epoch gives JAX's batches.
"""

import numpy as np
import pytest
import torch

import densefusion_tpu.native as jnative
import densefusion_tpu_torch.native as tnative
from densefusion_tpu.data import seg as jseg
from densefusion_tpu.data.loader import BatchLoader as JBatchLoader
from densefusion_tpu_torch.data import (
    BatchLoader, LinemodSegDataset, SegDataset, SegSample, collate_seg,
    generate_linemod_style_dataset, generate_ycb_style_dataset,
    seg_to_device,
)

LM_OBJS = (1, 10)


@pytest.fixture
def no_library(monkeypatch):
    """Both packages' numpy paths: neither native library is found."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)


@pytest.fixture
def with_library():
    """Both packages' default paths, through their native libraries."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    assert tnative.available()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    ycb = str(tmp_path_factory.mktemp("seg_ycb"))
    generate_ycb_style_dataset(ycb, n_classes=4, n_real=3, n_syn=3,
                               n_test=2, seed=4)
    lm = str(tmp_path_factory.mktemp("seg_lm"))
    generate_linemod_style_dataset(lm, objlist=LM_OBJS, n_train=3,
                                   n_test=10, seed=4)
    return {"ycb": ycb, "linemod": lm}


def _pair(roots, which, mode, seed=7):
    if which == "ycb":
        return (SegDataset(roots["ycb"], mode, seed=seed),
                jseg.SegDataset(roots["ycb"], mode, seed=seed))
    return (LinemodSegDataset(roots["linemod"], mode, objlist=LM_OBJS,
                              seed=seed),
            jseg.LinemodSegDataset(roots["linemod"], mode, objlist=LM_OBJS,
                                   seed=seed))


def assert_seg_equal(got, want, where=""):
    for name in SegSample._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, (where, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")


def _samples_match_jax(roots, which, mode):
    ds, jds = _pair(roots, which, mode)
    assert len(ds) == len(jds) > 0
    for epoch in (0, 1, 3):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for index in range(len(ds)):
            got, want = ds[index], jds[index]
            assert_seg_equal(got, want, f"epoch {epoch} index {index}")
            assert got.rgb.dtype == np.float32
            assert got.label.dtype == np.int32
    if which == "ycb":
        assert int(max(ds[i].label.max() for i in range(len(ds)))) > 0
        if mode == "train":   # the synthetic frames exist, and composite
            assert len(ds.real) < len(ds)
    else:
        assert ds.num_classes == jds.num_classes == max(LM_OBJS) + 1
        assert set(np.unique(ds[0].label)) <= {0, ds.items[0][0]}


@pytest.mark.parametrize("which", ["ycb", "linemod"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_samples_match_jax(roots, which, mode, no_library):
    _samples_match_jax(roots, which, mode)


@pytest.mark.parametrize("which", ["ycb", "linemod"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_samples_match_jax_with_library(roots, which, mode, with_library):
    _samples_match_jax(roots, which, mode)


def test_train_mode_augments(roots, no_library):
    """Train mode changes the pixels (jitter, flips), test mode does not;
    the sample of one (seed, epoch, index) is the same on every read."""
    train, _ = _pair(roots, "ycb", "train")
    test, _ = _pair(roots, "ycb", "test")
    train.set_epoch(2)
    a, b = train[1], train[1]
    assert_seg_equal(a, b)
    plain = SegDataset(roots["ycb"], "train", seed=7, use_noise=False)
    assert not np.array_equal(plain[1].rgb, a.rgb)
    assert test.use_noise is False


def _loader_batches_match_jax(roots):
    ds, jds = _pair(roots, "linemod", "train")
    got = list(BatchLoader(ds, 2, collate_fn=collate_seg, num_workers=2,
                           seed=5).epoch(2))
    want = list(JBatchLoader(jds, 2, collate_fn=jseg.collate_seg,
                             num_workers=2, seed=5).epoch(2))
    assert len(got) == len(want) == len(ds) // 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert_seg_equal(g, w, f"batch {i}")


def test_loader_batches_match_jax(roots, no_library):
    """Thread workers and ``collate_seg``: epoch 2's batches equal the JAX
    loader's (order from ``default_rng((seed, epoch))``)."""
    _loader_batches_match_jax(roots)


def test_loader_batches_match_jax_with_library(roots, with_library):
    """The same with both libraries on."""
    _loader_batches_match_jax(roots)


def test_seg_to_device_layout(roots):
    ds, _ = _pair(roots, "linemod", "test")
    batch = collate_seg([ds[0], ds[1]])
    rgb, label = seg_to_device(batch, "cpu")
    assert rgb.shape == (2, 3, 480, 640) and rgb.dtype == torch.float32
    assert label.shape == (2, 480, 640) and label.dtype == torch.int64
    np.testing.assert_array_equal(rgb.permute(0, 2, 3, 1).numpy(), batch.rgb)
    np.testing.assert_array_equal(label.numpy(), batch.label)
