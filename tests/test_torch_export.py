"""Port parity: kernel 6 as a registered op, and the ``torch.export``
inference artifact (``densefusion_tpu_torch/export.py``,
``cli/export_program.py``) against the JAX package's exported program
(``densefusion_tpu/export.py``).

* the op ``densefusion_tpu_torch::phase_conv3x3`` passes
  ``torch.library.opcheck`` on CPU tensors in float32 and bf16 (schema,
  autograd registration, fake implementation, AOT dispatch), and its fake
  implementation gives the CPU implementation's shape, type and strides,
  for a channels-last bf16 map too;
* one ``phase_upsample_conv3x3(..., conv_backend="kernel")`` exports on the
  CPU with the op as one node, and the exported module equals the JAX
  layer on its Pallas kernel in interpret mode at the decoder tests'
  tolerance (rtol 1e-4 / atol 1e-5);
* the artifact of a seeded JAX-written checkpoint (fused decoder, the
  confidence head widened so the argmax hypothesis has a clear margin, as
  in ``tests/test_torch_pipeline.py``) equals JAX's
  ``load_exported(export_inference(..., platforms=("cpu",)))`` at atol
  1e-4 (the whole network in float32, sums in another order);
* the artifact loads and runs in a process that imports only ``torch``
  and ``densefusion_tpu_torch.export`` (neither ``jax`` nor the port's
  ``models`` is imported), bit-equal to the live pipeline; the bf16
  artifact is bit-equal to the live bf16 pipeline; the CLI writes an
  artifact that does the same, and its parser is JAX's with ``--device``
  for ``--platforms``.

Sizes: 3 objects, 48 px crops, N=40, B=2. The network keeps its widths
(resnet18 PSPNet), so an artifact holds ~90 MB of weights.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch._subclasses.fake_tensor import FakeTensorMode

from densefusion_tpu import export as jexport
from densefusion_tpu.cli import export_stablehlo as j_export_cli
from densefusion_tpu.models import layers as jlayers
from densefusion_tpu.utils.config import RunConfig as JRunConfig
from densefusion_tpu_torch import export
from densefusion_tpu_torch.cli import export_program
from densefusion_tpu_torch.models import layers
from densefusion_tpu_torch.ops import phase_conv
from densefusion_tpu_torch.serve import PoseEstimator

from tests.torch_port_util import (
    NUM_OBJ, posenet_inputs, save_jax_checkpoint, to_np,
)

ROOT = Path(__file__).resolve().parent.parent
N, CROP, B = 40, 48, 2
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
OP = torch.ops.densefusion_tpu_torch.phase_conv3x3.default
BF16 = torch.bfloat16


def _parser_spec(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.required)
            for a in parser._actions if a.dest != "help"}


def _op_nodes(program) -> int:
    return sum(1 for n in program.graph.nodes if n.target == OP)


def _conv_operands(dtype, seed=0, b=2, h=5, w=7, cin=6, cout=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w))
                         .astype(np.float32)).to(dtype)
    pk = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.1)
                          .astype(np.float32)).to(dtype)
    return x, pk


# -- the op -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
def test_opcheck(dtype):
    """``torch.library.opcheck`` on CPU tensors: the NCHW map the float32
    route takes and, in bf16, the channels-last map the bf16 route takes
    (``replicate_pad``'s), with and without gradients."""
    x, pk = _conv_operands(dtype)
    maps = [phase_conv.replicate_pad(x, "library")]
    if dtype == BF16:
        maps.append(phase_conv.replicate_pad(x, "kernel"))
    for xp in maps:
        for grad in (False, True):
            report = torch.library.opcheck(
                OP, (xp.clone().requires_grad_(grad),
                     pk.clone().requires_grad_(grad)))
            assert set(report.values()) == {"SUCCESS"}, report


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
def test_fake_matches_cpu_implementation(dtype):
    """The fake implementation's output has the CPU implementation's shape,
    type and strides (contiguous NCHW), and the bf16 kernel's channels-last
    map keeps its strides under fake tensors: the pad ``torch.export``
    traces is the pad the card runs."""
    x, pk = _conv_operands(dtype, h=6, w=9, cin=5, cout=12)
    for backend in ("library", "kernel"):
        xp = phase_conv.replicate_pad(x, backend)
        real = OP(xp, pk)
        with FakeTensorMode() as mode:
            fxp = phase_conv.replicate_pad(mode.from_tensor(x), backend)
            fake = OP(fxp, mode.from_tensor(pk))
        assert fxp.stride() == xp.stride()
        assert (fake.shape, fake.dtype, fake.stride()) == \
            (real.shape, real.dtype, real.stride())
        assert real.is_contiguous()
    assert phase_conv.replicate_pad(x.to(BF16), "kernel").is_contiguous(
        memory_format=torch.channels_last)


def test_op_refuses_mixed_types_under_fake_tensors():
    """The fake implementation checks types as the CPU and CUDA ones do, so
    an export with mixed operands fails at trace time."""
    x, pk = _conv_operands(torch.float32)
    xp = phase_conv.replicate_pad(x, "library").to(BF16)
    with FakeTensorMode() as mode:
        with pytest.raises(ValueError, match="both"):
            OP(mode.from_tensor(xp), mode.from_tensor(pk))


class _Stage(torch.nn.Module):
    def __init__(self, weight, bias):
        super().__init__()
        self.weight = torch.nn.Parameter(weight)
        self.bias = torch.nn.Parameter(bias)

    def forward(self, x):
        return layers.phase_upsample_conv3x3(x, self.weight, self.bias,
                                             border="zero",
                                             conv_backend="kernel")


def test_exported_decoder_stage_holds_the_op():
    """One zero-border decoder stage on the kernel route, exported on the
    CPU: the op is one node of the graph, and the exported module equals
    the JAX layer on its Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 6, 5)) / 6).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    stage = _Stage(torch.from_numpy(np.ascontiguousarray(
        k.transpose(3, 2, 0, 1))), torch.from_numpy(bias))
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    program = torch.export.export(stage, (tx,))
    assert _op_nodes(program) == 1
    got = program.module()(tx)
    with pltpu.force_tpu_interpret_mode():
        want = jlayers.phase_upsample_conv3x3(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
            border="zero", conv_backend="pallas")
    np.testing.assert_allclose(to_np(got).transpose(0, 2, 3, 1),
                               np.asarray(want), **LAYER_TOL)
    assert torch.equal(got, stage(tx))


# -- the artifact -----------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A seeded JAX-written phase-2 checkpoint (fused decoder, refine depth
    2) and one batch of inputs whose argmax hypothesis has a margin."""
    path = str(tmp_path_factory.mktemp("export") / "checkpoint_best_refine")
    save_jax_checkpoint(path, np.random.default_rng(11), NUM_OBJ, N, CROP,
                        JRunConfig.preset("ycb", num_objects=NUM_OBJ,
                                          refine_iters=2, num_points=N,
                                          crop_size=CROP))
    return path


@pytest.fixture(scope="module")
def inputs():
    return posenet_inputs(np.random.default_rng(5), B, CROP, N)


@pytest.fixture(scope="module")
def blob(ckpt):
    return export.export_inference(ckpt, batch=B, device="cpu")


def _live(ckpt, bf16=False):
    return PoseEstimator.from_checkpoint(
        ckpt, num_obj=NUM_OBJ, num_points=N, crop_size=CROP, bf16=bf16,
        device="cpu").pipeline


def test_artifact_matches_the_jax_artifact(ckpt, inputs, blob):
    live = _live(ckpt)
    out = live.posenet(*live_inputs(live, inputs))
    conf = np.sort(to_np(out["pred_c"]), axis=1)
    assert (conf[:, -1] - conf[:, -2]).min() > 1e-4
    jfn = jexport.load_exported(jexport.export_inference(
        ckpt, batch=B, platforms=("cpu",)))
    want = jfn(*(jnp.asarray(a) for a in inputs))
    got = export.load_exported(blob, device="cpu")(*inputs)
    assert export.read_meta(blob) == {
        "device": "cpu", "batch": B, "crop_size": CROP, "num_points": N,
        "num_objects": NUM_OBJ, "refine_iters": 2, "bf16": False,
        "decoder": "fused"}
    for name, g, w in zip(("quat", "trans", "conf"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-4,
                                   err_msg=name)


def live_inputs(pipe, inputs):
    from densefusion_tpu_torch.eval.pipeline import pipeline_inputs
    return pipeline_inputs(*inputs, pipe.device)


CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from densefusion_tpu_torch.export import load_exported
    art, arrays, out, threads = sys.argv[1:5]
    torch.set_num_threads(int(threads))
    fn = load_exported(open(art, "rb").read(), device="cpu")
    got = fn(*np.load(arrays).values())
    np.savez(out, *(t.numpy() for t in got))
    print(json.dumps({"modules": sorted(sys.modules)}))
""")


def test_artifact_loads_in_a_fresh_process(ckpt, inputs, blob, tmp_path):
    """Saved to disk, loaded by a process that imports only ``torch`` and
    ``densefusion_tpu_torch.export``: the poses equal the live pipeline's
    bit for bit (on as many CPU threads, which set how the CPU's sums are
    split), and neither ``jax`` nor ``densefusion_tpu_torch.models`` was
    imported."""
    art = tmp_path / "posenet_b2.pt2"
    art.write_bytes(blob)
    np.savez(tmp_path / "in.npz", *inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    run = subprocess.run(
        [sys.executable, "-c", CHILD, str(art), str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz"), str(torch.get_num_threads())],
        cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    modules = json.loads(run.stdout.strip().splitlines()[-1])["modules"]
    assert "jax" not in modules and "densefusion_tpu" not in modules
    assert not [m for m in modules
                if m.startswith("densefusion_tpu_torch.models")]
    got = np.load(tmp_path / "out.npz")
    want = _live(ckpt)(*inputs)
    for g, w in zip(got.values(), want):
        np.testing.assert_array_equal(g, to_np(w))


def test_bf16_artifact_equals_the_live_bf16_pipeline(ckpt, inputs):
    blob16 = export.export_inference(ckpt, batch=B, bf16=True, device="cpu")
    assert export.read_meta(blob16)["bf16"] is True
    got = export.load_exported(blob16, device="cpu")(*inputs)
    want = _live(ckpt, bf16=True)(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def test_artifact_refuses_another_device_and_batch(blob, inputs,
                                                   monkeypatch):
    """The artifact is for one device and one batch: loading it for another
    device type (here a card, as if one were present), or calling it at
    another batch, raises."""
    with monkeypatch.context() as m:
        m.setattr(export, "resolve_device", lambda d: torch.device("cuda"))
        with pytest.raises(ValueError, match="exported for cpu"):
            export.load_exported(blob)
    fn = export.load_exported(blob, device="cpu")
    with pytest.raises(Exception):
        fn(*(a[:1] for a in inputs))


def test_export_program_cli(ckpt, inputs, tmp_path, capsys):
    out = tmp_path / "posenet.pt2"
    export_program.main(["--checkpoint", ckpt, "--out", str(out), "--batch",
                         str(B), "--iterations", "1", "--device", "cpu"])
    msg = capsys.readouterr().out
    assert msg.startswith(f"exported -> {out} (") \
        and msg.rstrip().endswith(f"MiB, batch={B}, iterations=1)")
    blob1 = out.read_bytes()
    assert export.read_meta(blob1)["refine_iters"] == 1
    got = export.load_exported(blob1, device="cpu")(*inputs)
    est = PoseEstimator.from_checkpoint(ckpt, num_obj=NUM_OBJ, num_points=N,
                                        crop_size=CROP, refine_iters=1,
                                        device="cpu")
    for g, w in zip(got, est.pipeline(*inputs)):
        assert torch.equal(g, w)
    with pytest.raises(SystemExit, match="checkpoint directory not found"):
        export_program.main(["--checkpoint", str(tmp_path / "nope"),
                             "--out", str(out)])


def test_export_program_parser_matches_jax():
    got = _parser_spec(export_program.build_parser())
    want = _parser_spec(j_export_cli.build_parser())
    assert got.pop("device")[1] is None
    assert want.pop("platforms")[1] is None
    assert got == want
