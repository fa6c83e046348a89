"""Port parity: the run config (``densefusion_tpu_torch.utils.config``)
against ``densefusion_tpu.utils.config`` (same fields, defaults, presets,
decoder flags and JSON), the options the port refuses, and the logging
helpers."""

import dataclasses
import json
import logging

import pytest

from densefusion_tpu.utils import config as jconfig
from densefusion_tpu_torch.utils import (
    DATASET_PRESETS, MetricsWriter, RunConfig, check_ported, setup_logger,
)


def test_fields_and_defaults_match_jax():
    jfields = [(f.name, f.type) for f in dataclasses.fields(jconfig.RunConfig)]
    assert [(f.name, f.type) for f in dataclasses.fields(RunConfig)] == \
        jfields
    assert dataclasses.asdict(RunConfig()) == \
        dataclasses.asdict(jconfig.RunConfig())


@pytest.mark.parametrize("dataset", ["ycb", "linemod", "cad"])
def test_presets_match_jax(dataset):
    assert DATASET_PRESETS[dataset] == jconfig.DATASET_PRESETS[dataset]
    over = dict(num_points=64, crop_size=32, objlist=(1, 10))
    assert dataclasses.asdict(RunConfig.preset(dataset, **over)) == \
        dataclasses.asdict(jconfig.RunConfig.preset(dataset, **over))
    assert set(DATASET_PRESETS) == set(jconfig.DATASET_PRESETS)


@pytest.mark.parametrize("decoder", ["fused", "dense", "torch", "nope"])
def test_decoder_flags_match_jax(decoder):
    ours, theirs = RunConfig(decoder=decoder), jconfig.RunConfig(
        decoder=decoder)
    if decoder == "nope":
        for cfg in (ours, theirs):
            with pytest.raises(ValueError, match="decoder"):
                cfg.decoder_flags()
    else:
        assert ours.decoder_flags() == theirs.decoder_flags()


def test_jax_config_json_loads_and_round_trips():
    """A JAX run's config JSON (tuples written as lists, plus a key a newer
    version might add) loads here; written back, it is the JAX JSON."""
    jcfg = jconfig.RunConfig.preset(
        "ycb", batch_size=32, lr=3e-4, objlist=(2, 4), decoder="dense",
        worker_mode="thread", rss_restart_gb=48.0)
    text = jcfg.to_json()
    extra = json.loads(text) | {"added_by_a_newer_version": 1}
    cfg = RunConfig.from_json(json.dumps(extra))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.sym_list == (12, 15, 18, 19, 20) and cfg.objlist == (2, 4)
    assert cfg.to_json() == text
    back = jconfig.RunConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("field,value,section", [
    ("knn_backend", "xla", "Rules of the port"),
])
def test_unported_options_raise(field, value, section):
    check_ported(RunConfig.preset("ycb"))
    with pytest.raises(NotImplementedError, match=section):
        check_ported(RunConfig(**{field: value}))


@pytest.mark.parametrize("field,value,section", [
    ("bf16_compute", True, "§1 E"),
    ("remat_cnn", True, "§1 E"),
])
def test_precision_options_run(tmp_path, field, value, section):
    """The options of ROADMAP.md ``section`` (refused until it was
    ported) pass ``check_ported`` on both devices, and the ``Trainer``
    builds its networks from them: bf16 compute in both networks, or the
    PoseNet's CNN recomputed in the backward pass; parameters stay
    float32."""
    import torch

    from densefusion_tpu_torch.train import Trainer

    cfg = RunConfig(**{field: value}, log_dir=str(tmp_path))
    check_ported(cfg, device="cpu")
    check_ported(cfg, device="cuda:0")
    tr = Trainer(cfg, device="cpu")
    bf16 = torch.bfloat16 if cfg.bf16_compute else None
    assert tr.posenet.feat.dtype == tr.refiner.feat.dtype == bf16
    assert tr.posenet.cnn.model.module.feats.dtype == bf16
    assert tr.posenet.remat_cnn == cfg.remat_cnn
    assert all(p.dtype == torch.float32 for p in tr.posenet.parameters())


def test_ported_options_pass():
    """``grad_accum`` runs (optax.MultiSteps' counterpart); every
    ``knn_backend`` runs the plain versions on the CPU, and the kernels'
    two on CUDA; an unknown backend is an error."""
    check_ported(RunConfig(grad_accum=4))
    for backend in ("auto", "pallas", "xla"):
        check_ported(RunConfig(knn_backend=backend), device="cpu")
    for backend in ("auto", "pallas"):
        check_ported(RunConfig(knn_backend=backend), device="cuda:0")
    with pytest.raises(ValueError, match="knn_backend"):
        check_ported(RunConfig(knn_backend="faiss"), device="cpu")


def test_logger_and_metrics_writer(tmp_path, capsys):
    log_file = tmp_path / "logs" / "epoch_1.log"
    logger = setup_logger("torch_port_test", str(log_file), logging.INFO)
    logger.info("avg_dis 0.0123")
    for h in logger.handlers:
        h.flush()
    assert "avg_dis 0.0123" in log_file.read_text()
    assert "avg_dis 0.0123" in capsys.readouterr().out
    writer = MetricsWriter(str(tmp_path / "m" / "metrics.jsonl"))
    writer.write(step=1, loss=0.5)
    writer.write(step=2, loss=0.25, ts=7.0)
    rows = [json.loads(ln) for ln in
            (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[1]["ts"] == 7.0 and "ts" in rows[0]
