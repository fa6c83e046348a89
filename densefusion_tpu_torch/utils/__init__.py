"""Utilities: the typed run config, logging, profiling."""

from densefusion_tpu_torch.utils.config import (
    RunConfig, DATASET_PRESETS, check_ported,
)
from densefusion_tpu_torch.utils.logging import setup_logger, MetricsWriter
from densefusion_tpu_torch.utils.profiling import trace_context

__all__ = ["RunConfig", "DATASET_PRESETS", "check_ported", "setup_logger",
           "MetricsWriter", "trace_context"]
