"""Tracing / profiling hooks (counterpart of ``gymrl_tpu/utils/profiling.py``).

Two tools:
  * ``trace(logdir)`` — context manager around ``torch.profiler``: the host's
    ops and, on the card, every CUDA kernel and copy, written as a Chrome
    trace that Perfetto (ui.perfetto.dev) or ``chrome://tracing`` opens.
    It yields the profiler, whose ``events()`` a caller can read once the
    block has ended (``kernel_stats``).
  * ``Throughput`` — steps/s meter with exponential smoothing; the train
    loop feeds it env-step counts per iteration.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str = "./exp/trace", device: str | torch.device | None = None):
    """Capture a trace: ``with trace() as prof: ts, _ = trainer.train_iter(ts)``.

    CUDA activity is recorded when ``device`` is a CUDA device (default:
    whenever CUDA is available). The trace is ``logdir/trace.json``."""
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def kernel_stats(prof) -> dict[str, float]:
    """Device kernels of a finished ``trace``: their count, their summed
    time and the time the device was busy with at least one of them (the
    union of their intervals), in ms. Copies and memsets are not kernels
    and are not counted."""
    # the profiler's raw events: turning them into FunctionEvents (``events()``)
    # costs seconds per 100k kernels
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted(
        (ev.start_ns(), ev.end_ns()) for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == cuda and not _is_copy(ev.name()))
    busy, end = 0, -1
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernels": len(spans), "kernel_ms": sum(b - a for a, b in spans) / 1e6,
            "busy_ms": busy / 1e6}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Throughput:
    """Exponentially-smoothed env-steps/s meter."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.rate = None
        self._last_t = None
        self._last_steps = None

    def update(self, total_steps: int) -> float | None:
        now = time.perf_counter()
        if self._last_t is not None and total_steps > self._last_steps:
            inst = (total_steps - self._last_steps) / (now - self._last_t)
            self.rate = inst if self.rate is None else (
                self.alpha * inst + (1 - self.alpha) * self.rate
            )
        self._last_t = now
        self._last_steps = total_steps
        return self.rate
