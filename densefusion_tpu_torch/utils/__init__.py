"""Utilities: the typed run config and logging."""

from densefusion_tpu_torch.utils.config import (
    RunConfig, DATASET_PRESETS, check_ported,
)
from densefusion_tpu_torch.utils.logging import setup_logger, MetricsWriter

__all__ = ["RunConfig", "DATASET_PRESETS", "check_ported", "setup_logger",
           "MetricsWriter"]
