"""Logging + metrics (counterpart of ``gymrl_tpu/utils/logging.py``).

  * console logging with the reference's format (utils/runner.py:13-14);
  * TensorBoard metric streams under ``./exp/{algo}_{env}_{ts}``
    (utils/runner.py:100-101) via torch's SummaryWriter;
  * ``log_monitors`` — writes a metrics dict, skipping NaNs
    (utils/runner.py:46-49).
"""

from __future__ import annotations

import logging
import math
import sys
import time


_FORMAT = "%(asctime)s | %(levelname)-7s | %(message)s"


def get_logger(name: str = "gymrl") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricsWriter:
    """TensorBoard writer, made at first use; a no-op when disabled.

    An enabled writer on a machine without ``tensorboard`` raises
    ``ImportError`` at first use rather than dropping metrics.
    """

    def __init__(self, algo: str, env_name: str, enabled: bool = True, root: str = "./exp"):
        self._writer = None
        self._enabled = enabled
        self._dir = f"{root}/{algo}_{env_name}_{time.strftime('%Y%m%d-%H%M%S')}"

    @property
    def writer(self):
        if self._writer is None and self._enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "metrics logging needs the `tensorboard` package; install it "
                    "or construct the writer / TrainLoop with logging disabled "
                    "(log_metrics=False)"
                ) from e
            self._writer = SummaryWriter(self._dir)
        return self._writer

    def log(self, metrics: dict, step: int):
        log_monitors(self.writer, metrics, step)

    def close(self):
        if self._writer is not None:
            self._writer.close()


def log_monitors(writer, monitors: dict, step: int):
    """Write scalars, skipping NaNs (reference utils/runner.py:46-49)."""
    if writer is None:
        return
    for key, value in monitors.items():
        v = float(value)
        if not math.isnan(v):
            writer.add_scalar(key, v, step)
