"""Logging: per-epoch file loggers plus a JSONL metrics stream (counterpart
of ``densefusion_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time


def setup_logger(name: str, log_file: str | None = None,
                 level=logging.INFO) -> logging.Logger:
    """Named logger writing to a file and stdout."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(name)s %(message)s")
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """Append-only JSONL metrics stream (one record per event)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, **record) -> None:
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
