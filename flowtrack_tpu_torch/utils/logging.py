"""Logging to the console and a file, and a jsonl log of scalar metrics.

Port of ``flowtrack_tpu/utils/logging.py``: ``setup_logging`` (:19) with
the reference's format, and ``MetricsWriter`` (:30), which appends one json
line a step. The reference mirrors the scalars to TensorBoard through
TensorFlow when it imports; the port tries ``torch.utils.tensorboard``
instead and, when that import fails, writes the jsonl alone, as the
reference does without TensorFlow.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def setup_logging(log_file: Optional[str] = None, level=logging.INFO):
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=handlers, force=True)


class MetricsWriter:
    """Append-only jsonl scalar log; optional TensorBoard mirror."""

    def __init__(self, path: str, tensorboard_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                self._tb = None

    def write(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
