"""Tracing / profiling hooks (counterpart of ``gymrl_tpu/utils/profiling.py``).

Three tools:
  * ``trace(logdir)`` — context manager around ``torch.profiler``: the host's
    ops and, on the card, every CUDA kernel and copy, written as a Chrome
    trace that Perfetto (ui.perfetto.dev) or ``chrome://tracing`` opens.
    It yields the profiler, whose ``events()`` a caller can read once the
    block has ended (``kernel_stats``, ``span_trace``).
  * ``span(name)`` — the program's spans at the boundaries of its layers
    (``train_iter``, ``rollout``, ``rollout.step``, ``policy``, ``env.step``,
    ``gae``, ``sgd`` and its routes, ``kernels.load``, ``trainer.init``; the
    mHC backbone's ``mhc`` and its Sinkhorn projection's ``mhc.sinkhorn``,
    the recurrent cells' ``rnn.unroll``, ppo_lstm's RND pair's ``rnd``). Off
    by default, when a span costs one flag check. ``enable()`` turns them on:
    each span is then kept in memory (``spans()``, ``clear()``), and while a
    ``torch.profiler`` session runs it is also a ``record_function`` range
    named ``PREFIX + name``, so a ``trace`` holds it beside the kernels on
    their clock.
  * ``span_trace(prof)`` — a finished trace read through those ranges: each
    kernel put down to the program span that launched it (by the CUDA
    correlation id of its host launch call), each launch call to the span it
    was made in, and the device's idle time by the span open at the time.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import re
import time
from collections import Counter
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile

PREFIX = "gymrl_tpu_torch."  # the program's spans among a profiler's ranges
ITERATION = "train_iter"  # the span that starts an iteration of a trainer
# A host call that launches device work: a kernel, or a CUDA graph's kernels.
LAUNCH_CALL = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch)")


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
    union of their intervals), in ms. Copies, memsets and the device's copy
    of a program span are not kernels and are not counted."""
    # the profiler's raw events: turning them into FunctionEvents (``events()``)
    # costs seconds per 100k kernels
    spans = sorted((ev.start_ns(), ev.end_ns())
                   for ev in prof.profiler.kineto_results.events() if _is_kernel(ev))
    busy, end = 0, -1
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernels": len(spans), "kernel_ms": sum(b - a for a, b in spans) / 1e6,
            "busy_ms": busy / 1e6}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _is_kernel(ev) -> bool:
    """A kernel on the card: not a copy, and not the device's copy of a host
    range (a program span, or a library's ``record_function`` such as
    ``torch.optim``'s ``Optimizer.step#Adam.step``, which the profiler marks
    as a user annotation)."""
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", None)
    return (ev.device_type() == torch.autograd.DeviceType.CUDA and not _is_copy(name)
            and not name.startswith(PREFIX) and not (annotation and annotation()))


# -- the program's spans --------------------------------------------------------
class Span(NamedTuple):
    """One recorded span: host clock (``time.perf_counter_ns``) at its start
    and end (``None`` while open), the index in ``spans()`` of the span that
    enclosed it (-1: none), the index of the ``train_iter`` that holds it
    (-1: none), and a note (``kernels.load``: the library, and whether it
    compiled or came from the cache)."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    iteration: int
    note: str


# The trainer's spans open and close on its one host thread.
_enabled = False
_records: list[list] = []  # the spans as lists in ``Span``'s order, appended as they open
_open: list[int] = []  # indices of the open spans, innermost last
_iterations = 0  # ``train_iter`` spans opened since the last ``clear``


class _Off:
    """What ``span`` returns while tracing is off: shared, and does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    note = property(lambda self: "", lambda self, value: None)


_OFF = _Off()


class _On:
    __slots__ = ("name", "index", "_note", "_range")

    def __init__(self, name: str, note: str):
        self.name, self._note, self.index, self._range = name, note, -1, None

    @property
    def note(self) -> str:
        return _records[self.index][5]

    @note.setter
    def note(self, value: str) -> None:
        _records[self.index][5] = value

    def __enter__(self):
        global _iterations
        parent = _open[-1] if _open else -1
        if self.name == ITERATION:
            iteration, _iterations = _iterations, _iterations + 1
        else:
            iteration = _records[parent][4] if parent >= 0 else -1
        self.index = len(_records)
        _records.append([self.name, 0, None, parent, iteration, self._note])
        _open.append(self.index)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name, self._note or None)
            self._range.__enter__()
        _records[self.index][1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        _records[self.index][2] = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open.pop()
        return False


def span(name: str, note: str = ""):
    """``with span("rollout"): ...``: a span of the program, recorded while
    tracing is on. The object it yields takes a ``note`` set inside the
    block."""
    if not _enabled:
        return _OFF
    return _On(name, note)


def enable() -> None:
    """Turn tracing on: spans opened from now on are recorded."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn tracing off; spans already open still close as recorded."""
    global _enabled
    _enabled = False


def spans() -> list[Span]:
    """The spans recorded since the last ``clear``, in the order they opened."""
    return [Span(*r) for r in _records]


def clear() -> None:
    """Forget the recorded spans; no span may be open."""
    global _iterations
    if _open:
        raise RuntimeError(f"clear() inside the open span {_records[_open[-1]][0]!r}")
    _records.clear()
    _iterations = 0


# -- a profiler's trace read through the program's spans ------------------------
def _merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class SpanTrace:
    """A trace's program spans, host launch calls and kernels. A span's
    ``path`` is the names from its outermost enclosing span down to its own;
    a call's or a kernel's is the path of the innermost span open at the
    launch call, ``()`` outside every span, ``None`` for a kernel whose
    launch call the trace does not hold."""

    spans: list[tuple[str, int, int, tuple]]  # name, start, end, path
    launches: list[tuple[str, int, tuple]]  # call, start, path
    kernels: list[tuple[str, int, int, tuple | None]]  # name, start, end, path
    _bounds: list[int]  # the innermost span from _bounds[i] to _bounds[i + 1] is _owner[i]
    _owner: list[int]

    def kernels_by_span(self) -> Counter:
        """Kernels by the innermost span of their launch: ``()`` outside
        every span, ``None`` with no launch call in the trace."""
        return Counter(p[-1] if p else p for *_, p in self.kernels)

    def idle_ns(self, start: int, end: int, inside: str | None = None) -> int:
        """Time from ``start`` to ``end`` in which no kernel ran, within the
        spans named ``inside`` if given."""
        idle = self._idle(start, end)
        if inside is None:
            return sum(b - a for a, b in idle)
        spans = _merged((a, b) for n, a, b, _ in self.spans if n == inside)
        return sum(max(0, min(b, d) - max(a, c)) for a, b in idle for c, d in spans)

    def idle_by_span(self, start: int, end: int) -> Counter:
        """Time from ``start`` to ``end`` in which no kernel ran, by the
        innermost span open (``"(none)"`` outside every span)."""
        edges, out = self._bounds, Counter()
        for a, b in self._idle(start, end):
            k = bisect.bisect_right(edges, a) - 1  # the edge at or before a; -1: none
            while a < b:
                cut = min(b, edges[k + 1]) if k + 1 < len(edges) else b
                if cut > a:
                    owner = self._owner[k] if k >= 0 else -1
                    out[self.spans[owner][0] if owner >= 0 else "(none)"] += cut - a
                a, k = max(a, cut), k + 1
        return out

    def _idle(self, start: int, end: int) -> list[tuple[int, int]]:
        busy = _merged((max(a, start), min(b, end)) for _, a, b, _ in self.kernels
                       if b > start and a < end)
        edges = [start] + [t for ab in busy for t in ab] + [end]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def span_trace(prof) -> SpanTrace:
    """The program's spans, launch calls and kernels of a finished ``trace``
    taken while tracing was on. Copies and memsets are neither kernels nor
    launches."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, calls, kerns = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            if _is_kernel(ev):
                kerns.append((name, ev.start_ns(), ev.end_ns(), ev.correlation_id()))
        elif name.startswith(PREFIX):
            ranges.append((name[len(PREFIX):], ev.start_ns(), ev.end_ns()))
        elif LAUNCH_CALL.match(name):
            calls.append((name, ev.start_ns(), ev.correlation_id()))
    # The ranges nest, as the ``with`` blocks that made them: a sweep in order of
    # start (outer first at a tie) with a stack of the open ones gives each its
    # path, and the innermost range between each two edges.
    ranges.sort(key=lambda r: (r[1], -r[2]))
    spans, bounds, owner, stack = [], [], [], []

    def close_until(t):
        while stack and spans[stack[-1]][2] <= t:
            end = spans[stack.pop()][2]
            bounds.append(end)
            owner.append(stack[-1] if stack else -1)

    for name, a, b in ranges:
        close_until(a)
        path = (spans[stack[-1]][3] if stack else ()) + (name,)
        stack.append(len(spans))
        spans.append((name, a, b, path))
        bounds.append(a)
        owner.append(stack[-1])
    close_until(float("inf"))

    def path_at(t):
        k = bisect.bisect_right(bounds, t) - 1
        return spans[owner[k]][3] if k >= 0 and owner[k] >= 0 else ()

    launches = [(name, t, path_at(t)) for name, t, _ in calls]
    path_of_call = {corr: path for (_, _, corr), (_, _, path) in zip(calls, launches)}
    kernels = [(name, a, b, path_of_call.get(corr)) for name, a, b, corr in kerns]
    return SpanTrace(spans, launches, kernels, bounds, owner)
