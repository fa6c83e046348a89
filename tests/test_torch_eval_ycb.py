"""The port's YCB evaluation CLIs against the JAX package's, on the CPU:

* ``cli.eval_ycb`` and ``cli.score_ycb`` parsers have the JAX parsers'
  options and defaults (plus ``--device`` on ``eval_ycb``);
* ``cli.eval_ycb`` on a JAX-written checkpoint (weights from a numpy seed)
  and a synthetic 3-class YCB root with fake PoseCNN results, through its
  three routes (``--dispatch frame``, ``--dispatch detection``; the third,
  ``--native_crops on``, in ``test_torch_eval_ycb_native.py``), against the
  JAX CLI on the same checkpoint and
  root: the ``.mat`` poses within 1e-4; the scored distances within 1e-5,
  so ``metrics.json``'s AUCs (percent, over 0.1 m) within 1e-2 and its
  counts equal; each CLI's ``metrics.json`` table equal to the JAX scorer's
  on that CLI's own poses, exactly;
* ``cli.score_ycb`` against the JAX one on the same result directories,
  exactly;
* the repairs the port's ``eval_ycb`` carries beyond the JAX one: every
  ``.mat`` written atomically, a warning when ``--skip_done`` meets a route
  that ignores it, and a run stamp that ``--skip_done`` must match;
* ``cli.benchmark``'s ``inference`` and ``latency`` give the JAX keys plus
  the dtype and device.
"""

import json
import os

import numpy as np
import pytest
import scipy.io as scio

from densefusion_tpu.cli import eval_ycb as j_eval_ycb
from densefusion_tpu.cli import score_ycb as j_score_ycb
from densefusion_tpu.eval import ycb_toolbox as jtb
from densefusion_tpu.utils.config import RunConfig as JRunConfig
from densefusion_tpu_torch.cli import eval_ycb, score_ycb
from densefusion_tpu_torch.data import generate_ycb_style_dataset

from tests.torch_port_util import save_jax_checkpoint

N, CROP, NUM_OBJ, KEYFRAMES = 64, 64, 3, 3
METHODS = ("Densefusion_wo_refine_result", "Densefusion_iterative_result")
ROUTES = {"frame": ["--dispatch", "frame"],
          "detection": ["--dispatch", "detection"],
          "native": ["--native_crops", "on"]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The root (3 test keyframes of 3 objects each, PoseCNN results) and a
    JAX phase-2 checkpoint with refine depth 2."""
    tmp = tmp_path_factory.mktemp("ycb_eval")
    root, posecnn = str(tmp / "root"), str(tmp / "posecnn")
    generate_ycb_style_dataset(root, n_classes=NUM_OBJ, n_real=1, n_syn=0,
                               n_test=KEYFRAMES, seed=5, posecnn_dir=posecnn,
                               objs_per_frame=3)
    ck = str(tmp / "checkpoint_best_refine")
    save_jax_checkpoint(ck, np.random.default_rng(13), NUM_OBJ, N, CROP,
                        JRunConfig.preset("ycb", num_objects=NUM_OBJ,
                                          refine_iters=2, num_points=N,
                                          crop_size=CROP))
    return {"root": root, "posecnn": posecnn, "ck": ck, "tmp": tmp}


def _args(data, out, *extra):
    return ["--dataset_root", data["root"], "--posecnn_results",
            data["posecnn"], "--checkpoint", data["ck"], "--num_points",
            str(N), "--crop_size", str(CROP), "--num_keyframes",
            str(KEYFRAMES), "--output_dir", out, *extra]


@pytest.fixture(scope="module")
def runs(data):
    """route -> (port output dir, port summary, JAX output dir, JAX
    summary), each route run once per module."""
    done = {}

    def get(route):
        if route not in done:
            ours = str(data["tmp"] / f"ours_{route}")
            theirs = str(data["tmp"] / f"jax_{route}")
            s = eval_ycb.main(_args(data, ours, *ROUTES[route], "--device",
                                    "cpu"))
            js = j_eval_ycb.main(_args(data, theirs, *ROUTES[route]))
            done[route] = (ours, s, theirs, js)
        return done[route]
    return get


def _poses(out, method, frame):
    return np.asarray(scio.loadmat(os.path.join(
        out, method, f"{frame:04d}.mat"))["poses"], np.float64)


def _parser_spec(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.required)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["eval_ycb", "score_ycb"])
def test_parsers_match_jax(name):
    port, jax_cli = {"eval_ycb": (eval_ycb, j_eval_ycb),
                     "score_ycb": (score_ycb, j_score_ycb)}[name]
    got = _parser_spec(port.build_parser())
    want = _parser_spec(jax_cli.build_parser())
    if name == "eval_ycb":
        assert got.pop("device")[1] is None
    assert got == want


def check_route(data, runs, route):
    """The port's ``route`` against the JAX CLI's (see the module
    docstring)."""
    ours, s, theirs, js = runs(route)
    n_rois = 0
    for method in METHODS:
        for f in range(KEYFRAMES):
            got, want = _poses(ours, method, f), _poses(theirs, method, f)
            assert got.shape == want.shape and got.shape[1] == 7
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=f"{route} {method} {f}")
            n_rois += len(got)
    assert n_rois >= 2 * 2 * KEYFRAMES
    # refinement moved the poses: the two methods differ
    assert not np.allclose(_poses(ours, METHODS[0], 0),
                           _poses(ours, METHODS[1], 0))
    # the scored distances follow the poses
    got_t, want_t = (scio.loadmat(os.path.join(d, "results_keyframe.mat"))
                     for d in (ours, theirs))
    for k in ("distances_sys", "distances_non"):
        np.testing.assert_allclose(got_t[k], want_t[k], rtol=0, atol=1e-5)
    for k in ("results_cls_id", "results_frame_id"):
        np.testing.assert_array_equal(got_t[k], want_t[k])
    with open(os.path.join(ours, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics == json.loads(json.dumps(s))
    assert set(metrics) == set(js) == {
        "adds_auc", "add_auc", "adds_under_2cm", "refine_iterations",
        "refiner_trained", "native_crops", "methods"}
    for k in ("refine_iterations", "refiner_trained", "native_crops"):
        assert metrics[k] == js[k]
    assert metrics["native_crops"] == (route == "native")
    for method, rows in js["methods"].items():
        for group, row in rows.items():
            ours_row = metrics["methods"][method][group]
            assert set(ours_row) == set(row)
            for k, v in row.items():
                if k in ("detected", "total"):
                    assert ours_row[k] == v
                elif v is not None:
                    assert abs(ours_row[k] - v) <= 1e-2, (method, group, k)
    # stage 2 on the CLI's own poses is the JAX scorer's table
    dirs = {"per-pixel": os.path.join(ours, METHODS[0]),
            "iterative": os.path.join(ours, METHODS[1])}
    table = jtb.summarize(jtb.score_keyframes(
        data["root"], data["posecnn"], dirs, num_keyframes=KEYFRAMES),
        [f"{i:03d}_synth_obj" for i in range(1, NUM_OBJ + 1)])
    assert metrics["methods"] == json.loads(json.dumps(table))


@pytest.mark.parametrize("route", ["frame", "detection"])
def test_routes_match_jax(data, runs, route):
    check_route(data, runs, route)


def test_frame_and_detection_routes_agree(runs):
    """The padded frame batches and the batch-1 loop give the same poses."""
    frame, detection = runs("frame")[0], runs("detection")[0]
    for method in METHODS:
        for f in range(KEYFRAMES):
            np.testing.assert_allclose(_poses(frame, method, f),
                                       _poses(detection, method, f),
                                       rtol=0, atol=1e-4)


def test_skip_done_rerun_recomputes_nothing(data, runs, monkeypatch):
    """A ``--skip_done`` rerun of the frame route into its own directory
    runs no pipeline and writes the same ``metrics.json``."""
    from densefusion_tpu_torch.eval import pipeline

    out = runs("frame")[0]
    with open(os.path.join(out, "metrics.json")) as f:
        before = f.read()

    def refuse(self, *args):
        raise AssertionError("a skipped keyframe reached the pipeline")

    monkeypatch.setattr(pipeline.InferencePipeline, "__call__", refuse)
    eval_ycb.main(_args(data, out, "--skip_done", "--device", "cpu"))
    with open(os.path.join(out, "metrics.json")) as f:
        assert f.read() == before


def test_skip_done_refuses_another_run(data, runs, tmp_path):
    """The stamp holds the run's checkpoint, iterations, points and crop:
    ``--skip_done`` with another of them, or on results without a stamp,
    refuses before any work."""
    out = runs("frame")[0]
    with open(os.path.join(out, "run_stamp.json")) as f:
        stamp = json.load(f)
    assert stamp == {"checkpoint": os.path.abspath(data["ck"]),
                     "iterations": 2, "num_points": N, "crop_size": CROP,
                     "native_crops": False}
    with pytest.raises(SystemExit, match="another run"):
        eval_ycb.main(_args(data, out, "--skip_done", "--iterations", "1",
                            "--device", "cpu"))
    bare = tmp_path / "bare"
    (bare / METHODS[0]).mkdir(parents=True)
    (bare / METHODS[0] / "0000.mat").write_bytes(b"")
    with pytest.raises(SystemExit, match="without a run_stamp"):
        eval_ycb.main(_args(data, str(bare), "--skip_done", "--device",
                            "cpu"))


def test_resume_never_scores_an_earlier_runs_results(data, runs, tmp_path,
                                                     monkeypatch):
    """A finished run A, then a run B of another checkpoint cut short after
    its first keyframe, then B resumed with ``--skip_done``: B's fresh
    start deleted A's results, so the resume recomputes the rest and no
    pose of A is scored. ``timings`` receives every stage's seconds."""
    import shutil

    out = tmp_path / "out"
    shutil.copytree(runs("frame")[0], out)
    sentinel = np.full((3, 7), 9.0)   # A's poses, told apart from B's
    for method in METHODS:
        for f in range(KEYFRAMES):
            scio.savemat(str(out / method / f"{f:04d}.mat"),
                         {"poses": sentinel})
    ck_b = str(tmp_path / "checkpoint_b")
    shutil.copytree(data["ck"], ck_b)
    args_b = [*_args(data, str(out), "--device", "cpu"), "--checkpoint",
              ck_b]

    calls = []

    def cut(f, mdict):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return real(f, mdict)

    real = scio.savemat
    monkeypatch.setattr(scio, "savemat", cut)
    with pytest.raises(KeyboardInterrupt):
        eval_ycb.main(args_b)
    monkeypatch.undo()
    for method in METHODS:
        assert sorted(os.listdir(out / method)) == ["0000.mat"]
    timings = {}
    eval_ycb.main([*args_b, "--skip_done"], timings=timings)
    # keyframe 0 is B's first run's; the resumed ones draw their samples
    # after it, as the eval reader's one generator does, so they are held
    # to be B's own, not to a whole run's
    for method in METHODS:
        np.testing.assert_array_equal(_poses(str(out), method, 0),
                                      _poses(runs("frame")[0], method, 0))
        for f in range(KEYFRAMES):
            poses = _poses(str(out), method, f)
            assert poses.shape == (3, 7) and np.isfinite(poses).all()
            assert not (poses == 9.0).any(), (method, f)
    assert set(timings) == {"keyframes", "setup_s", "infer_s", "models_s",
                            "score_s"}
    assert timings["keyframes"] == KEYFRAMES
    assert all(timings[k] >= 0 for k in timings)


def test_skip_done_warns_on_a_route_that_ignores_it(data, tmp_path):
    out = str(tmp_path / "det")
    eval_ycb.main(_args(data, out, "--dispatch", "detection", "--skip_done",
                        "--num_keyframes", "1", "--iterations", "0",
                        "--device", "cpu"))
    with open(os.path.join(out, "eval_log.txt")) as f:
        log = f.read()
    assert "--skip_done is ignored by the detection route" in log
    # --iterations 0 publishes the unrefined poses as the refined ones
    np.testing.assert_array_equal(_poses(out, METHODS[0], 0),
                                  _poses(out, METHODS[1], 0))


def test_interrupted_write_leaves_no_mat(data, tmp_path, monkeypatch):
    """A write cut short (here: the second ``.mat`` of keyframe 0) leaves
    no result file behind, so a ``--skip_done`` resume recomputes the
    keyframe."""
    calls = []

    def flaky(f, mdict):
        calls.append(1)
        if len(calls) == 2:
            f.write(b"MATLAB 5.0 MAT-file, truncated")
            raise KeyboardInterrupt
        return real(f, mdict)

    real = scio.savemat
    monkeypatch.setattr(scio, "savemat", flaky)
    out = tmp_path / "cut"
    with pytest.raises(KeyboardInterrupt):
        eval_ycb.main(_args(data, str(out), "--device", "cpu"))
    monkeypatch.undo()
    assert sorted(os.listdir(out / METHODS[0])) == ["0000.mat"]
    assert os.listdir(out / METHODS[1]) == []
    eval_ycb.main(_args(data, str(out), "--skip_done", "--device", "cpu"))
    assert sorted(os.listdir(out / METHODS[1])) == \
        [f"{i:04d}.mat" for i in range(KEYFRAMES)]


def test_score_ycb_matches_jax(data, runs, tmp_path, capsys):
    ours_out = runs("frame")[0]
    spec = ["--results", f"per-pixel={ours_out}/{METHODS[0]}",
            "--results", f"iterative={ours_out}/{METHODS[1]}"]
    common = ["--dataset_root", data["root"], "--posecnn_results",
              data["posecnn"], *spec]
    table = score_ycb.main([*common, "--output_dir", str(tmp_path / "o")])
    jtable = j_score_ycb.main([*common, "--output_dir", str(tmp_path / "j")])
    assert table == jtable
    with open(tmp_path / "o" / "scores.json") as f, \
            open(tmp_path / "j" / "scores.json") as g:
        assert f.read() == g.read()
    got, want = (scio.loadmat(str(tmp_path / d / "results_keyframe.mat"))
                 for d in ("o", "j"))
    for k in want:
        if not k.startswith("__"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(SystemExit, match="NAME=DIR"):
        score_ycb.main(["--dataset_root", data["root"], "--posecnn_results",
                        data["posecnn"], "--results", ours_out])


@pytest.mark.parametrize("what", ["inference", "latency"])
def test_bench_inference_on_cpu(what):
    """The inference benchmarks run on the CPU at B=1 and give the JAX
    benchmark's keys, plus the device and dtype (float32)."""
    from densefusion_tpu_torch.cli.benchmark import (
        bench_inference, bench_latency,
    )
    if what == "inference":
        out = bench_inference(batch=1, repeats=1, device="cpu")
        keys = {"inference_batch", "inference_ms_per_batch", "inference_fps"}
    else:
        out = bench_latency(repeats=2, device="cpu")
        keys = {"latency_refine_iters", "latency_ms_median",
                "latency_ms_p90", "latency_vs_paper_frame"}
    assert set(out) == keys | {"dtype", "device"}
    assert out["device"] == "cpu" and out["dtype"] == "float32"
    assert all(np.isfinite(out[k]) and out[k] > 0 for k in keys)


def test_entry_points_need_cuda_or_cpu(data, tmp_path):
    import torch

    from densefusion_tpu_torch.cli.benchmark import (
        bench_inference, bench_latency,
    )
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: eval_ycb.main(_args(data, str(tmp_path / "e"))),
                 bench_inference, bench_latency):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
