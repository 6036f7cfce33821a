"""One run of one cell: set-up, the measured window, the traced iterations,
the comparison with the reference, and the result's line.

``run`` takes the device it is given: ``run.py`` gives it the card after its
look for one; the tests give it the CPU at a tiny size.
"""

from __future__ import annotations

import gc
import re
import subprocess
import sys
import time

import torch

from benchlib import compare, files, program
from benchlib.stats import PEAKS, busy_ns, is_copy, merged, percentile

FORBIDDEN = ("jax", "jaxlib", "flax", "gymrl_tpu")
PROFILED_ITERS = 3  # the traced iterations after the window
HOST_SPAN = "portbench."


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards: a card held below
    700 W runs slower under load."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", "; ")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that no run may hold, compared whole
    (``gymrl_tpu_torch`` is not ``gymrl_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseEvents:
    """The ``train_iter`` timer: a CUDA event at the iteration's start and at
    each mark the trainer makes and, while ``spans`` is on, a host span per
    interval for the profiler's trace.

    ``phases`` are the marks the program side ``side`` declares (``PHASES``,
    in the order its trainer makes them; a mark may repeat within an
    iteration, as an off-policy trainer's ``"act"`` and ``"update"`` do at
    every env step); another mark is refused.
    An interval is named by the mark that ends it, the one after the last
    mark ``fetch``; a host span is numbered (``portbench.<n>``) and named
    once its interval ends (``label``)."""

    def __init__(self, device: torch.device, phases: tuple[str, ...], side: str):
        self.cuda = device.type == "cuda"
        self.phases, self.side = tuple(phases), side
        self.rows: list[list] = []  # an iteration's events: its start, then one a mark
        self.marks: list[list[str]] = []  # an iteration's marks, in order
        self.labels: list[str] = []  # host span n's interval name
        self.spans = False
        self._open = None

    def _enter(self) -> None:
        if self.spans:
            self._open = torch.profiler.record_function(f"{HOST_SPAN}{len(self.labels)}")
            self._open.__enter__()

    def _exit(self, label: str) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
            self.labels.append(label)

    def _event(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self) -> None:
        self.rows.append([self._event()])
        self.marks.append([])
        self._enter()

    def __call__(self, phase: str) -> None:
        if phase not in self.phases:
            raise ValueError(f"{self.side} marked {phase!r}, which its PHASES "
                             f"{self.phases} do not declare")
        self.rows[-1].append(self._event())
        self.marks[-1].append(phase)
        self._exit(phase)
        self._enter()

    def end(self) -> None:
        self._exit("fetch")

    def phase_ms(self) -> list[dict[str, float]]:
        """Each iteration's ms by mark: the sum of the intervals that end at it."""
        if not self.cuda:
            return []
        out = []
        for row, marks in zip(self.rows, self.marks):
            ms: dict[str, float] = {}
            for phase, a, b in zip(marks, row, row[1:]):
                ms[phase] = ms.get(phase, 0.0) + a.elapsed_time(b)
            out.append(ms)
        return out

    def label(self, span: str) -> str:
        """The interval name of this timer's host span ``span``."""
        return self.labels[int(span[len(HOST_SPAN):])]


def _window(trainer, ts, seconds: float, device, events: PhaseEvents | None):
    """Iterations until ``seconds`` have passed, fetch to fetch."""
    times = []
    _sync(device)
    t0 = prev = time.perf_counter()
    while True:
        if events is not None:
            events.start()
        ts, _, _, _ = program.iteration(trainer, ts, events)
        if events is not None:
            events.end()
        now = time.perf_counter()
        times.append(now - prev)
        prev = now
        if now - t0 >= seconds:
            return ts, times, now - t0


def _profiled(trainer, ts, device, events: PhaseEvents):
    """``PROFILED_ITERS`` iterations under the profiler, timed by ``events``
    with its host spans on: their kernels ``(name, start_ns, end_ns)``, the
    host's spans ``(interval name, start_ns, end_ns)``, their wall time and
    the program's kernels' launches as the program counted them."""
    events.spans = True
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = program.launches()
    _sync(device)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    for _ in range(PROFILED_ITERS):
        events.start()
        ts, _, _, _ = program.iteration(trainer, ts, events)
        events.end()
    _sync(device)
    wall = time.perf_counter() - t0
    prof.stop()
    launched = sum(n - before[k] for k, n in program.launches().items())
    kern, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            # a host range's shadow on the device's timeline (a span of ours, or a
            # library's record_function, a user annotation) is no kernel
            if not (is_copy(name) or name.startswith(HOST_SPAN) or ev.is_user_annotation()):
                kern.append((name, ev.start_ns(), ev.end_ns()))
        elif name.startswith(HOST_SPAN):
            host.append((events.label(name), ev.start_ns(), ev.end_ns()))
    del prof
    return ts, kern, host, wall, launched


def _breakdown(kern, host) -> dict:
    by_name: dict[str, int] = {}
    for name, a, b in kern:
        by_name[name] = by_name.get(name, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = merged([(a, b) for _, a, b in kern])
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        phase = next((n for n, s, e in host if s <= mid <= e), "between")
        gaps.append((phase, b - a))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:160], ns / 1e9] for n, ns in top],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps[:10]]}


class RunView:
    """What a metric's reader (``metrics/<name>.py``) reads: the run's
    settings (``cfg``), its configuration's file (``conf``: its env's sizes,
    its model's work count), the env steps of an iteration as the program
    side counts them from the settings (``steps_per_iter``), its set-up
    time, the window's iteration times (and, traced, their phase times by
    mark), and the profiled iterations' kernels and wall time."""

    def __init__(self, conf: dict, cfg: dict, setup_s: float, iter_s: list[float],
                 window_s: float, phases: list[dict] = (), kernels: list[tuple] = (),
                 wall_s: float = 0.0, bench_dir: str = files.BENCH_DIR):
        self.conf, self.bench_dir = conf, bench_dir
        self.cfg, self.setup_s, self.iter_s, self.window_s = cfg, setup_s, iter_s, window_s
        self.steps_per_iter = files.obj(conf["program"], bench_dir).env_steps(cfg)
        self.phases, self.kernels, self.wall_s = list(phases), list(kernels), wall_s
        self.busy_s = busy_ns([(a, b) for _, a, b in self.kernels]) / 1e9
        self.tf32 = torch.backends.cuda.matmul.allow_tf32
        self.peaks = PEAKS

    def work(self, name: str):
        return files.module("work", name, self.bench_dir)

    def kernel_ns(self, pattern: str) -> list[int]:
        """Device time of each traced launch whose name holds ``pattern``
        as a whole word."""
        rx = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(pattern)}(?![A-Za-z0-9_])")
        return [b - a for n, a, b in self.kernels if rx.search(n)]


def run(the_cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, bench_dir: str = files.BENCH_DIR, plant=None) -> dict:
    conf = files.config(the_cell["config"], bench_dir)
    cfg = files.run_config(the_cell, bench_dir)
    limits = files.limits(the_cell["name"], bench_dir)
    side = files.obj(conf["program"], bench_dir)
    if side.METRICS != files.obj(conf["reference"], bench_dir).METRICS:
        raise ValueError(f"{conf['program']} and {conf['reference']} name different metrics")

    stages = [("imports", time.perf_counter())]
    trainer, ts, prog = program.run_setup(conf, cfg, seed, device, plant, stages, bench_dir)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    marks = [t_start] + [t for _, t in stages]
    log(f"setup: {setup_s:.3f} s; by stage, s: " + ", ".join(
        f"{name} {b - a:.3f}" for (name, _), a, b in zip(stages, marks, marks[1:]))
        + f"; kernels compiled in this process, s: {program.build_seconds()}")

    phases = program.phases(side)
    events = PhaseEvents(device, phases, conf["program"]) if trace else None
    ts, times, window_s = _window(trainer, ts, seconds, device, events)
    result_device: dict = {}
    breakdown = None
    if trace:
        ts, kern, host, wall, launched = _profiled(trainer, ts, device,
                                                   PhaseEvents(device, phases, conf["program"]))
        view = RunView(conf, cfg, setup_s, times, window_s, events.phase_ms(), kern, wall,
                       bench_dir)
        own = sum(len(view.kernel_ns(k)) for k in side.KERNELS)
        log(f"trace: {len(kern)} kernels traced in {PROFILED_ITERS} iterations; the program's "
            f"own kernels: {own} traced, {launched} launched by its counter")
        result_device.update({"busy_s": view.busy_s, "window_s": wall})
        breakdown = _breakdown(kern, host)
    else:
        view = RunView(conf, cfg, setup_s, times, window_s, bench_dir=bench_dir)
    result_metrics: dict[str, dict] = {}
    for m in the_cell["per_layer" if trace else "end_to_end"]:
        value = files.module("metrics", m["name"], bench_dir).read(view)
        if value is not None:
            result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    thirds = [times[k * len(times) // 3:(k + 1) * len(times) // 3] for k in range(3)]
    log(f"window: {len(times)} iterations in {window_s:.3f} s, iteration ms min "
        f"{min(times) * 1e3:.3f} median {percentile(times, 50) * 1e3:.3f} max "
        f"{max(times) * 1e3:.3f}; env-steps/s by third of the window: "
        + ", ".join(f"{view.steps_per_iter * len(t) / sum(t):.1f}" for t in thirds if t))
    finite = all(bool(torch.isfinite(p).all()) for p in side.params_of(ts).values())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"memory: peak {peak} B allocated")
    del trainer, ts
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = compare.reference_summary(conf, cfg, seed, device, "ieee", bench_dir)
    nums = compare.numbers(prog, ref, conf, cfg, seed, device, bench_dir)
    correct, compared = compare.judge(nums, limits)
    correct = correct and finite
    log(f"reference: {time.perf_counter() - t_ref:.3f} s; leaves left out of the change: "
        f"{compare.moved_by_rounding(ref)}; all numbers: "
        + ", ".join(f"{k} {v:.6g}" for k, v in nums.items()))

    result = {
        "correct": correct,
        "attempted": len(times),
        "failed": 0 if finite else len(times),
        "metrics": result_metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
            **result_device,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result
