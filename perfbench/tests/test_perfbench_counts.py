"""The benchmark's counts: kernel 6's operations, the kernels' bounds and
the model's FLOPs, and that no share computed from them can pass 100% at
the times the port's kernels were measured at."""

import json
from pathlib import Path

import pytest

from perfbench import counts

CONFIGS = Path(__file__).resolve().parent.parent / "configs"

# device ms of kernel 6 at the decoder's three shapes (up1, up2, up3) by
# batch, and of kernels 1 and 2 at phase 1 (B=32, N=1000, M=500, 8 rows
# symmetric): the port's kernel table, NVIDIA H100 80GB HBM3 at 700 W
KERNEL6_MS = {64: (8.258, 2.113, 2.427), 32: (4.134, 1.100, 1.235),
              16: (2.075, 0.573, 0.640), 8: (1.245, 0.342, 0.330),
              1: (0.4185, 0.1133, 0.0726)}
PAIRED_MS, MIN_MS = 0.0252, 0.7012


def cfg(name="densefusion-ycb"):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("shape", [(64, 24, 24, 1024, 1024),
                                   (1, 5, 7, 3, 9), (3, 48, 48, 256, 256)])
def test_kernel6_ops_count_each_product_once(shape):
    b, h, w, cin, cout = shape
    assert counts.conv3x3_ops(b, h, w, cin, cout) \
        == 2 * 9 * b * h * w * cin * cout


def test_decoder_launch_shapes():
    assert counts.decoder_convs(192, 64) == [(64, 24, 24, 1024, 1024),
                                             (64, 48, 48, 256, 256),
                                             (64, 96, 96, 64, 256)]


@pytest.mark.parametrize("batch", sorted(KERNEL6_MS))
def test_kernel6_share_stays_under_100_at_measured_times(batch):
    for shape, ms in zip(counts.decoder_convs(192, batch),
                         KERNEL6_MS[batch]):
        share = counts.conv3x3_bound_s(*shape) / (ms / 1e3)
        assert 0 < share <= 1.0, (shape, share)


def test_loss_kernel_bounds_match_the_kernel_table():
    paired = counts.add_dist_bound_s(32, 1000, 500, 24, nearest=False)
    mins = counts.add_dist_bound_s(32, 1000, 500, 8, nearest=True)
    assert mins * 1e3 == pytest.approx(0.2424, rel=1e-3)
    assert paired * 1e3 < PAIRED_MS and mins * 1e3 < MIN_MS
    share = (paired + mins) / ((PAIRED_MS + MIN_MS) / 1e3)
    assert 0 < share <= 1.0


def test_search_bounds_are_positive_and_grow_with_work():
    assert counts.remap_bound_s(64, 500, 500, 64) \
        > counts.remap_bound_s(64, 500, 500, 32) > 0
    assert counts.nn_bound_s(1, 250_000, 500) * 1e3 \
        == pytest.approx(0.01495, rel=1e-2)


@pytest.mark.parametrize("name", ["densefusion-ycb", "densefusion-linemod"])
def test_model_flops_cover_the_decoder_and_grow_with_training(name):
    c = cfg(name)
    serve = counts.inference_flops(c, 2, c["refine_iters"])
    train = counts.pose_train_flops(c, 2)
    decoder = sum(counts.conv3x3_ops(*s) for s in
                  counts.decoder_convs(c["crop_size"], 1))
    assert 30e9 < serve < 70e9
    assert serve > decoder
    assert 2 * serve < train < 4 * serve


def test_the_refiner_iterations_are_counted():
    c = cfg()
    assert counts.inference_flops(c, 2, 4) > counts.inference_flops(c, 2, 2)


@pytest.mark.parametrize("key,value", [("decoder_widths", [1024, 128, 64,
                                                           64]),
                                       ("head_widths", [640, 128, 128]),
                                       ("fusion_widths", [64, 128, 256,
                                                          1024])])
def test_the_count_follows_the_configurations_widths(key, value):
    c = cfg()
    assert counts.inference_flops(dict(c, **{key: value}), 2, 2) \
        < counts.inference_flops(c, 2, 2)


def test_mfu_at_the_recorded_serving_rate_is_a_share():
    # 1007 poses/s, the fastest f32 serving the port recorded (PR 15)
    share = counts.inference_flops(cfg(), 2, 2) * 1007 \
        / cfg()["peak_flops"]
    assert 0 < share < 1.0
