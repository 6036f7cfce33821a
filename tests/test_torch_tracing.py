"""The program's spans (``gymrl_tpu_torch/utils/profiling.py`` ``span``) and
the reading of a profiler's trace through them (``span_trace``), on the CPU.

  * (a) off, the default: ``span`` hands out one shared object, records
    nothing and never reaches ``record_function``, even under a running
    profiler;
  * (b) on: each ``PPOTrainer`` iteration holds one ``train_iter``, one
    ``rollout``, T ``rollout.step``, T ``policy``, T ``env.step``, one
    ``gae`` and one ``sgd``, each inside its parent and of its iteration;
    the ``timer`` still sees its three phases, each after its span closed;
  * (c) under ``torch.profiler`` the same spans are ranges of the trace,
    nested the same way;
  * (d) tracing changes no bit of the train state or the episode statistics;
  * (e) the sweep's routes and a kernel library's load are spans;
  * (f) ``span_trace`` on a stand-in trace: kernels put down to the span of
    their launch call by correlation id, a graph launch's kernels included;
    launch calls by span; idle time by span and inside a span.
"""

import subprocess
import time
from collections import Counter

import pytest
import torch

from gymrl_tpu_torch.algos import base
from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
from gymrl_tpu_torch.kernels import build
from gymrl_tpu_torch.kernels import lunarlander as kl
from gymrl_tpu_torch.utils import profiling
from gymrl_tpu_torch.utils.checkpoint import flat_state, state_tree

torch.set_num_threads(1)

T = 8
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


@pytest.fixture
def tracing():
    profiling.clear()
    profiling.enable()
    yield
    profiling.disable()
    profiling.clear()


def _trainer():
    cfg = PPOConfig(num_envs=4, rollout_steps=T, minibatch_size=16, num_epochs=2, hidden_dim=16)
    return PPOTrainer(cfg, device="cpu")


def _two_iterations(timer=None):
    trainer = _trainer()
    ts = trainer.init(5)
    outs = []
    for _ in range(2):
        ts, out = trainer.train_iter(ts, timer)
        outs.append(out)
    return ts, outs


# -- (a) off ------------------------------------------------------------------------------
def test_off_records_nothing_and_never_reaches_record_function(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function reached with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling._enabled
    assert profiling.span("rollout") is profiling.span("gae")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _two_iterations()
    assert profiling.spans() == []


# -- (b) on -------------------------------------------------------------------------------
def test_each_iteration_holds_its_spans_nested_and_the_timer_unchanged(tracing):
    marks = []
    _two_iterations(lambda phase: marks.append((phase, time.perf_counter_ns())))
    spans = profiling.spans()
    assert [p for p, _ in marks] == ["rollout", "gae", "sgd"] * 2
    per_iter = {i: Counter(s.name for s in spans if s.iteration == i) for i in (0, 1)}
    want = {"train_iter": 1, "rollout": 1, "rollout.step": T, "policy": T, "env.step": T,
            "gae": 1, "sgd": 1}
    assert per_iter[0] == per_iter[1] == want  # the CPU sweep is eager: no route span
    assert [s.name for s in spans if s.iteration == -1] == ["trainer.init"]
    parents = {"train_iter": None, "rollout": "train_iter", "rollout.step": "rollout",
               "policy": "rollout.step", "env.step": "rollout.step", "gae": "train_iter",
               "sgd": "train_iter", "trainer.init": None}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if parents[s.name] is None:
            assert s.parent == -1
            continue
        up = spans[s.parent]
        assert up.name == parents[s.name] and up.iteration == s.iteration
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    for i in (0, 1):  # each phase's span closes before its mark, the next opens after it
        one = {s.name: s for s in spans if s.iteration == i and s.name in want}
        (_, rollout), (_, gae), (_, sgd) = marks[3 * i:3 * i + 3]
        assert one["rollout"].end_ns <= rollout <= one["gae"].start_ns
        assert one["gae"].end_ns <= gae <= one["sgd"].start_ns
        assert one["sgd"].end_ns <= sgd <= one["train_iter"].end_ns


def test_clear_forgets_the_spans_and_refuses_inside_an_open_one(tracing):
    with profiling.span("train_iter"):
        with pytest.raises(RuntimeError, match="train_iter"):
            profiling.clear()
    assert [s.iteration for s in profiling.spans()] == [0]
    profiling.clear()
    with profiling.span("train_iter"), profiling.span("gae", "a note") as inner:
        inner.note = "another"
    assert [(s.name, s.parent, s.iteration, s.note) for s in profiling.spans()] == [
        ("train_iter", -1, 0, ""), ("gae", 0, 0, "another")]


# -- (c) under the profiler ----------------------------------------------------------------
def _path(spans, s):
    path = (s.name,)
    while s.parent >= 0:
        s = spans[s.parent]
        path = (s.name,) + path
    return path


def test_the_spans_are_ranges_of_a_profiler_trace_nested_the_same_way(tracing):
    trainer = _trainer()
    ts = trainer.init(5)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train_iter(ts)
    recorded = profiling.spans()
    got = profiling.span_trace(prof)
    assert sorted(p for *_, p in got.spans) == sorted(_path(recorded, s) for s in recorded)
    assert len(got.spans) == 4 + 3 * T and got.kernels == [] and got.launches == []
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(profiling.PREFIX)]
    assert events and all(ev.is_user_annotation() for ev in events)


# -- (d) no bit moves -----------------------------------------------------------------------
def test_tracing_changes_no_bit_of_the_state_or_the_episodes():
    runs = []
    for on in (False, True):
        profiling.clear()
        if on:
            profiling.enable()
        try:
            ts, outs = _two_iterations()
        finally:
            profiling.disable()
        runs.append((flat_state(state_tree(ts)), outs))
    profiling.clear()
    (a, outs_a), (b, outs_b) = runs
    assert a.keys() == b.keys() and any("exp_avg" in k for k in a)
    for k in a:
        same = torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
        assert same, k
    for x, y in zip(outs_a, outs_b):
        for field in ("ep_return", "ep_length", "ep_done"):
            assert torch.equal(getattr(x, field), getattr(y, field)), field


# -- (e) the sweep's routes and the kernels' load ---------------------------------------------
def test_the_sweeps_routes_are_spans(monkeypatch, tracing):
    holder = base.SweepGraph(torch.device("cpu"), 1)
    monkeypatch.setattr(holder, "_capture", lambda net, opt, body: setattr(holder, "graph", 1))
    monkeypatch.setattr(holder, "_replay", lambda net, opt: torch.zeros(1))
    net = torch.nn.Linear(2, 1)
    opt = base.adam(list(net.parameters()), 1e-3, 1e-5, foreach=False)
    for _ in range(3):
        holder.run(net, opt, lambda static: static["x"].sum(), {"x": torch.ones(2)})
    assert [s.name for s in profiling.spans()] == [
        "sgd.warmup", "sgd.capture", "sgd.replay", "sgd.replay"]


def test_a_librarys_load_is_a_span_that_says_whether_it_compiled(monkeypatch, tmp_path,
                                                                 tracing):
    def nvcc(cmd):
        if cmd[1:] == ["--version"]:
            return subprocess.CompletedProcess(cmd, 0, "release 12.8", "")
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("not a library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "fake-nvcc")
    monkeypatch.setattr(build, "_run", nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    for _ in range(2):  # the second process finds the file in the cache
        monkeypatch.setattr(build, "_LOADED", {})
        build.load("lunarlander", kl.SOURCE, kl.defines())
        build.load("lunarlander", kl.SOURCE, kl.defines())  # memoized: no load
    assert [(s.name, s.note) for s in profiling.spans()] == [
        ("kernels.load", "lunarlander compiled"), ("kernels.load", "lunarlander cached")]


# -- (f) a trace read through the spans ----------------------------------------------------
class Ev:
    def __init__(self, name, start, end, dev=CPU, corr=0):
        self._n, self._s, self._e, self._d, self._c = name, start, end, dev, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c


def _prof(events):
    class Results:
        def events(self):
            return events

    class Prof:
        class profiler:
            kineto_results = Results()

    return Prof()


def _span(name, a, b):
    return Ev(profiling.PREFIX + name, a, b)


# Host, 0-100: rollout 0-60 holding two env steps (10-25, 30-45) and, after it, sgd
# 60-100 holding a replay 70-90. Launch calls at 12 (1), 20 (2), 32 (3), 50 (4), 75
# (graph, 5), 95 (6) and one outside every span at 105 (7). The device: kernel 1
# 14-18, 2 22-28, 3 40-44, 4 52-54, the graph's three 76-80, 80-84, 84-88, the
# copy 89-90, 7 106-108; one kernel 8 at 110-112 whose launch call the trace lacks.
EVENTS = [
    _span("rollout", 0, 60), _span("env.step", 10, 25), _span("env.step", 30, 45),
    _span("sgd", 60, 100), _span("sgd.replay", 70, 90),
    Ev("aten::mm", 11, 13),
    Ev("cudaLaunchKernel", 12, 13, corr=1), Ev("cudaLaunchKernel", 20, 21, corr=2),
    Ev("cuLaunchKernelEx", 32, 33, corr=3), Ev("cudaLaunchKernelExC_v11060", 50, 51, corr=4),
    Ev("cudaGraphLaunch_v10000", 75, 76, corr=5), Ev("cudaLaunchKernel", 95, 96, corr=6),
    Ev("cudaLaunchKernel", 105, 106, corr=7), Ev("cudaMemcpyAsync", 88, 89, corr=9),
    Ev("lander_step", 14, 18, CUDA, 1), Ev("gemm", 22, 28, CUDA, 2),
    Ev("lander_reset", 40, 44, CUDA, 3), Ev("tanh", 52, 54, CUDA, 4),
    Ev("gemm", 76, 80, CUDA, 5), Ev("clip_adam", 80, 84, CUDA, 5), Ev("gemm", 84, 88, CUDA, 5),
    Ev("Memcpy DtoH", 89, 90, CUDA, 9), Ev(profiling.PREFIX + "sgd", 60, 100, CUDA),
    Ev("relu", 106, 108, CUDA, 7), Ev("lost", 110, 112, CUDA, 8),
]


def test_each_kernel_goes_to_the_span_of_its_launch_call():
    got = profiling.span_trace(_prof(EVENTS))
    assert [(n, p) for n, _, _, p in got.spans] == [
        ("rollout", ("rollout",)), ("env.step", ("rollout", "env.step")),
        ("env.step", ("rollout", "env.step")), ("sgd", ("sgd",)),
        ("sgd.replay", ("sgd", "sgd.replay"))]
    assert [p for *_, p in got.kernels] == [
        ("rollout", "env.step"), ("rollout", "env.step"), ("rollout", "env.step"), ("rollout",),
        ("sgd", "sgd.replay"), ("sgd", "sgd.replay"), ("sgd", "sgd.replay"), (), None]
    assert got.kernels_by_span() == {"env.step": 3, "rollout": 1, "sgd.replay": 3, (): 1,
                                     None: 1}
    assert [p[-1] if p else p for *_, p in got.launches] == [
        "env.step", "env.step", "env.step", "rollout", "sgd.replay", "sgd", ()]
    assert sum("rollout" in p for *_, p in got.launches) == 4
    assert sum(p is not None and "sgd" in p for *_, p in got.kernels) == 3
    assert profiling.kernel_stats(_prof(EVENTS))["kernels"] == 9  # no copy, no span


def test_idle_time_by_span_and_inside_a_span():
    got = profiling.span_trace(_prof(EVENTS))
    # busy 14-18, 22-28, 40-44, 52-54, 76-88 within 0-100: idle 14+4+12+8+22+12 = 72
    assert got.idle_ns(0, 100) == 72
    assert got.idle_ns(0, 100, inside="rollout") == 14 + 4 + 12 + 8 + 6
    assert got.idle_ns(0, 100, inside="env.step") == 4 + 4 + 10 + 1
    assert got.idle_by_span(0, 120) == {
        "rollout": 10 + 2 + 7 + 6, "env.step": 4 + 4 + 10 + 1, "sgd": 10 + 10,
        "sgd.replay": 6 + 2, "(none)": 6 + 2 + 8}
    assert sum(got.idle_by_span(0, 120).values()) == got.idle_ns(0, 120)
