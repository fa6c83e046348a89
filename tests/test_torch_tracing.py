"""The port's spans (``densefusion_tpu_torch/utils/profiling.py`` ``span``,
``spans``, ``clear_spans``) on the CPU.

* with no profiler session a span is a shared no-op: nothing is recorded
  and no ``record_function`` range is opened;
* under a session, spans record their name, parent and request (per
  thread), ``units`` and the error their body raised, as context managers
  and as decorators; the buffer keeps the latest ``SPAN_CAPACITY``;
* each span's host interval is within 100 µs of the profiler event its
  ``record_function`` range emitted (the shared clock);
* one ``estimate_batch``, one ``InferencePipeline`` call, one phase-1
  step and one SegNet step record exactly their trees of spans;
* ``export_inference`` under a session records no span and its graph
  holds no profiler op.
"""

import io
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from densefusion_tpu_torch import export
from densefusion_tpu_torch.data import PoseSample, to_device
from densefusion_tpu_torch.models import PoseNet, PoseRefineNet, SegNet
from densefusion_tpu_torch.serve import PoseEstimator
from densefusion_tpu_torch.train.seg import (
    create_seg_train_state, make_seg_train_step,
)
from densefusion_tpu_torch.train.state import TrainState, make_optimizer
from densefusion_tpu_torch.train.steps import make_pose_train_step
from densefusion_tpu_torch.utils import profiling
from densefusion_tpu_torch.utils.profiling import clear_spans, span, spans
from tests.torch_port_util import NUM_OBJ, save_jax_checkpoint

B, CROP, N, M, K = 2, 32, 40, 30, 2


@pytest.fixture(autouse=True)
def empty_buffer():
    clear_spans()
    yield
    clear_spans()


def cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def tree(records) -> list:
    """Each span as (name, its parent's name, units), sorted."""
    by_id = {r["id"]: r for r in records}
    return sorted((r["name"], by_id[r["parent"]]["name"]
                   if r["parent"] is not None else None, r["units"])
                  for r in records)


def test_without_a_session_a_span_is_a_shared_no_op(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("a") is span("a")
    with span("a"):
        with span("b", units=4):
            x = torch.ones(3) + 1
    assert x.sum() == 6 and spans() == []


def test_nested_spans_name_their_parent_and_request():
    with cpu_session():
        with span("root", units=8):
            with span("child"):
                with span("leaf"):
                    pass
            with span("child"):
                pass
        with span("next"):
            pass
    recs = spans()
    assert [r["name"] for r in recs] == ["leaf", "child", "child", "root",
                                        "next"]
    leaf, child, child2, root, nxt = recs
    assert root["parent"] is None and root["request"] == root["id"]
    assert child["parent"] == child2["parent"] == root["id"]
    assert leaf["parent"] == child["id"]
    assert {r["request"] for r in (leaf, child, child2)} == {root["id"]}
    assert nxt["parent"] is None and nxt["request"] == nxt["id"]
    assert len({r["id"] for r in recs}) == 5
    assert all(r["t0_ns"] <= r["t1_ns"] and r["device_ms"] is None
               for r in recs)
    assert root["t0_ns"] <= leaf["t0_ns"] and leaf["t1_ns"] <= root["t1_ns"]


def test_threads_keep_separate_stacks():
    inside = threading.Barrier(2, timeout=30)

    def work(tag):
        with span(f"{tag}.root"):
            inside.wait()     # both roots open at once
            with span(f"{tag}.child"):
                inside.wait()

    with cpu_session():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by_name = {r["name"]: r for r in spans()}
    assert len(by_name) == 4
    for tag in "ab":
        root, child = by_name[f"{tag}.root"], by_name[f"{tag}.child"]
        assert root["parent"] is None
        assert child["parent"] == root["id"] == child["request"]


def test_units_and_error_are_recorded():
    with cpu_session():
        with span("ok", units=64):
            pass
        with pytest.raises(ValueError, match="bad input"):
            with span("outer"):
                with span("fails", units=3):
                    raise ValueError("bad input")
    ok, fails, outer = spans()
    assert (ok["units"], ok["error"]) == (64, None)
    assert fails["units"] == 3 and "bad input" in fails["error"]
    assert "ValueError" in outer["error"]


def test_a_decorated_function_opens_a_span_at_each_call():
    @span("work")
    def work(x):
        return x + 1

    assert work(1) == 2 and spans() == []
    with cpu_session():
        assert work(2) == 3 and work(3) == 4
    assert [r["name"] for r in spans()] == ["work", "work"]
    assert work.__name__ == "work"


def test_the_buffer_keeps_the_latest_spans():
    with cpu_session():
        for i in range(profiling.SPAN_CAPACITY + 5):
            with span("s", units=i):
                pass
    recs = spans()
    assert len(recs) == profiling.SPAN_CAPACITY
    assert recs[0]["units"] == 5 and recs[-1]["units"] == \
        profiling.SPAN_CAPACITY + 4
    clear_spans()
    assert spans() == []


def test_spans_are_on_the_profilers_clock():
    # the first range of a process pays a one-time set-up inside
    # record_function; the clock is compared after it
    with torch.profiler.record_function("warm"):
        pass
    for attempt in range(3):     # a host that deschedules us gets another
        clear_spans()
        with cpu_session() as prof:
            for i in range(4):
                with span(f"outer{i}"):
                    with span(f"inner{i}"):
                        torch.ones(8) * 2
        events = {e.name(): e for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation()}
        recs = spans()
        assert len(recs) == 8 and all(r["name"] in events for r in recs)
        worst = max(max(abs(r["t0_ns"] - events[r["name"]].start_ns()),
                        abs(r["t1_ns"] - events[r["name"]].end_ns()))
                    for r in recs)
        if worst <= 100_000:
            break
    assert worst <= 100_000, f"{worst / 1e3:.1f} µs"


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(3)
    return PoseNet(NUM_OBJ), PoseRefineNet(NUM_OBJ)


def _samples(rng):
    return [PoseSample(
        points=(0.05 * rng.standard_normal((N, 3)) + [0, 0, 0.6])
        .astype(np.float32),
        choose=rng.choice(CROP * CROP, N, replace=False).astype(np.int32),
        img=rng.standard_normal((CROP, CROP, 3)).astype(np.float32),
        target=np.zeros((M, 3), np.float32),
        model_points=np.zeros((M, 3), np.float32),
        obj_idx=np.asarray(i % NUM_OBJ, np.int32), sym=np.asarray(False),
        valid=np.asarray(True)) for i in range(B)]


PIPELINE_TREE = [("pipeline.inputs", "pipeline.run", None),
                 ("posenet.cnn", "pipeline.run", None),
                 ("posenet.fusion", "pipeline.run", None)] \
    + [("pipeline.refine", "pipeline.run", None)] * K


@pytest.mark.parametrize("entry", ["estimate_batch", "pipeline"])
def test_a_request_records_its_tree(nets, entry):
    posenet, refiner = nets
    est = PoseEstimator(posenet, refiner, posenet.state_dict(),
                        refiner.state_dict(), num_points=N, crop_size=CROP,
                        refine_iters=K, device="cpu")
    samples = _samples(np.random.default_rng(0))
    with cpu_session():
        if entry == "estimate_batch":
            est.estimate_batch(samples)
        else:
            b = PoseSample(*(np.stack(f) for f in zip(*samples)))
            est.pipeline(b.img, b.points, b.choose, b.obj_idx)
    if entry == "estimate_batch":
        want = PIPELINE_TREE + [("pipeline.run", "serve.request", B),
                                ("serve.collate", "serve.request", None),
                                ("serve.request", None, B)]
    else:
        want = PIPELINE_TREE + [("pipeline.run", None, B)]
    recs = spans()
    assert tree(recs) == sorted(want)
    assert len({r["request"] for r in recs}) == 1


def test_a_phase1_step_records_its_tree(nets):
    posenet, refiner = nets
    rng = np.random.default_rng(1)
    state = TrainState(step=0, posenet=posenet, refiner=refiner,
                       optimizer=make_optimizer(posenet.parameters(), 1e-4),
                       generator=torch.Generator().manual_seed(0))
    step = make_pose_train_step(state, use_adds=True)
    s = _samples(rng)
    batch = PoseSample(*(np.stack(f) for f in zip(*s)))
    batch = batch._replace(
        target=rng.uniform(-0.05, 0.05, (B, M, 3)).astype(np.float32),
        model_points=rng.uniform(-0.05, 0.05, (B, M, 3)).astype(np.float32),
        sym=np.array([True, False]))
    with cpu_session():
        out = step(to_device(batch, "cpu"), 0.015)
    assert torch.isfinite(out["loss"])
    assert tree(spans()) == sorted([
        ("train.step", None, B), ("train.forward", "train.step", None),
        ("posenet.cnn", "train.forward", None),
        ("posenet.fusion", "train.forward", None),
        ("train.loss", "train.step", None),
        ("train.backward", "train.step", None),
        ("train.optimizer", "train.step", None)])


def test_a_seg_step_records_its_tree():
    enc = ((4, 4), (8, 8), (8, 8, 8), (8, 8, 8), (8, 8, 8))
    dec = ((8, 8, 8), (8, 8, 8), (8, 8, 8), (8, 4), (4,))
    state = create_seg_train_state(SegNet(5, enc, dec), device="cpu")
    step = make_seg_train_step(state)
    g = torch.Generator().manual_seed(0)
    rgb = torch.randn(B, 3, 32, 64, generator=g)
    label = torch.randint(0, 5, (B, 32, 64), generator=g)
    with cpu_session():
        loss = step(rgb, label)
    assert torch.isfinite(loss) and state.step == 1
    assert tree(spans()) == sorted([
        ("seg.step", None, B), ("seg.forward", "seg.step", None),
        ("segnet.encoder", "seg.forward", None),
        ("segnet.decoder", "seg.forward", None),
        ("seg.loss", "seg.step", None),
        ("seg.backward", "seg.step", None),
        ("seg.optimizer", "seg.step", None)])
    assert len({r["request"] for r in spans()}) == 1
    clear_spans()
    step(rgb, label)        # no session: nothing recorded
    assert spans() == []


def test_export_under_a_session_holds_no_profiler_op(tmp_path):
    from densefusion_tpu.utils.config import RunConfig as JRunConfig

    path = str(tmp_path / "checkpoint_best_refine")
    save_jax_checkpoint(path, np.random.default_rng(11), NUM_OBJ, N, CROP,
                        JRunConfig.preset("ycb", num_objects=NUM_OBJ,
                                          refine_iters=K, num_points=N,
                                          crop_size=CROP))
    with cpu_session():
        blob = export.export_inference(path, batch=B, device="cpu")
    assert export.read_meta(blob)["refine_iters"] == K
    assert spans() == []
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets and not any("profiler" in t for t in targets)
