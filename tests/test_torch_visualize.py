"""The port's ``cli.visualize`` against the JAX package's on the CPU:
``_project`` and ``_paint`` equal the JAX helpers exactly on the same
poses; the parser has the JAX options plus ``--device``; on a JAX-written
checkpoint and a synthetic YCB or LineMOD root the CLI writes the JAX CLI's
PNG names, images that agree with the JAX ones on all but a few pixels
(poses within float32 rounding can round a projected point to the next
pixel), with the overlays painted."""

import os

import numpy as np
import pytest
from PIL import Image

from densefusion_tpu.cli import visualize as j_visualize
from densefusion_tpu.utils.config import RunConfig as JRunConfig
from densefusion_tpu_torch.cli import visualize
from densefusion_tpu_torch.data import (
    generate_linemod_style_dataset, generate_ycb_style_dataset,
)
from densefusion_tpu_torch.geometry.camera import LINEMOD_CAM, YCB_CAM_1

from tests.torch_port_util import save_jax_checkpoint

N, CROP = 64, 64


def test_parser_matches_jax():
    def spec(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices, a.nargs, a.required)
                for a in parser._actions if a.dest != "help"}
    got = spec(visualize.build_parser())
    assert got.pop("device")[1] is None
    assert got == spec(j_visualize.build_parser())


@pytest.mark.parametrize("cam", [YCB_CAM_1, LINEMOD_CAM])
def test_project_and_paint_match_jax(rng, cam):
    shape = (480, 640, 3)
    cloud = (0.08 * rng.standard_normal((2000, 3))
             + np.array([0.0, 0.0, 0.5]))
    cloud[:50, 2] = -0.1                      # behind the camera
    cloud[50:60] *= 20.0                      # out of the frame
    got, want = visualize._project(cloud, cam, shape), \
        j_visualize._project(cloud, cam, shape)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert 0 < got[0].size < len(cloud)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    ours, theirs = img.copy(), img.copy()
    visualize._paint(ours, *got, (0, 220, 60))
    j_visualize._paint(theirs, *want, (0, 220, 60))
    np.testing.assert_array_equal(ours, theirs)
    assert (ours != img).any()


@pytest.mark.parametrize("dataset", ["ycb", "linemod"])
def test_cli_writes_the_jax_images(dataset, tmp_path):
    root = str(tmp_path / "root")
    if dataset == "ycb":
        num_obj, extra = 3, []
        generate_ycb_style_dataset(root, n_classes=num_obj, n_real=1,
                                   n_syn=0, n_test=3, seed=7)
        cfg = JRunConfig.preset("ycb", num_objects=num_obj, refine_iters=2,
                                num_points=N, crop_size=CROP)
    else:
        num_obj, extra = 2, ["--objlist", "1", "10"]
        generate_linemod_style_dataset(root, objlist=(1, 10), n_train=2,
                                       n_test=20, seed=7)
        cfg = JRunConfig.preset("linemod", num_objects=num_obj,
                                objlist=(1, 10), refine_iters=2)
    ck = str(tmp_path / "checkpoint_best_refine")
    save_jax_checkpoint(ck, np.random.default_rng(17), num_obj, N, CROP, cfg)
    args = ["--dataset", dataset, "--dataset_root", root, "--checkpoint", ck,
            "--frames", "3", "--crop_size", str(CROP), "--num_points",
            str(N), *extra]
    written = visualize.main([*args, "--output_dir", str(tmp_path / "o"),
                              "--device", "cpu"])
    j_visualize.main([*args, "--output_dir", str(tmp_path / "j")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "o")) == names
    assert sorted(os.path.basename(p) for p in written) == names
    assert len(names) >= 2 and all(n.startswith("vis_") for n in names)
    for name in names:
        got, want = (np.array(Image.open(tmp_path / d / name))
                     for d in ("o", "j"))
        assert got.shape == want.shape and got.dtype == np.uint8
        assert (got == want).all(-1).mean() > 0.999, name
        # the gt overlay (blue) is painted
        assert ((got == (60, 90, 255)).all(-1)).any(), name


def test_entry_point_needs_cuda_or_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        visualize.main(["--dataset_root", str(tmp_path), "--checkpoint",
                        str(tmp_path), "--output_dir", str(tmp_path / "o")])
