"""The harness takes a trainer of any shape: its marks (``PHASES``) and its
env steps an iteration (``env_steps``) come from the program side.

An off-policy cell, added as new files alone: a toy trainer that marks
``"act"`` and ``"update"`` at every env step, counts its env steps under
``steps_per_iter`` and has no ``minibatch_size``, with its program side,
plain reference, fault, configuration, traffic, limits and a per-layer
metric on its own marks. Then the port's off-policy trainers and PPG,
each at a tiny size, through the window and the profiled iterations.

On the CPU no CUDA event times a phase, so where a test reads the phase
rows it times them with a stand-in event on the host's clock."""

import dataclasses
import hashlib
import json
import os
import shutil
import textwrap
import time

import pytest
import torch

from benchlib import files, harness, program

from conftest import BENCH_DIR

torch.set_num_threads(2)
CPU = torch.device("cpu")

TRAINER = '''
import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ToyOffPolicyConfig:
    num_envs: int = 4
    steps_per_iter: int = 4
    batch_size: int = 8
    updates_per_step: int = 2
    memory_capacity: int = 32
    lr: float = 1e-2


class State(NamedTuple):
    params: torch.nn.Module
    opt_state: torch.optim.Adam
    gen: torch.Generator
    w_true: torch.Tensor
    replay: torch.Tensor
    pos: int
    size: int


class Out(NamedTuple):
    ep_done: torch.Tensor
    ep_return: torch.Tensor
    metrics: dict


class ToyOffPolicyTrainer:
    """A replay of (x, x·w) rows; at every env step ``num_envs`` rows are
    pushed ("act") and ``updates_per_step`` Adam steps fit a linear model on
    ``batch_size`` rows drawn from the replay ("update")."""

    def __init__(self, cfg, device):
        self.cfg, self.device, self.half, self.last_rows = cfg, device, False, None

    def init(self, seed):
        gen = torch.Generator().manual_seed(seed)
        net = torch.nn.Linear(3, 1)
        with torch.no_grad():
            net.weight.copy_(torch.randn(1, 3, generator=gen))
            net.bias.zero_()
        w_true = torch.randn(3, generator=gen)
        replay = torch.zeros(self.cfg.memory_capacity, 4)
        return State(net, torch.optim.Adam(net.parameters(), lr=self.cfg.lr), gen, w_true,
                     replay, 0, 0)

    def train_iter(self, ts, timer=None):
        cfg, mark = self.cfg, timer or (lambda phase: None)
        pos, size, pushed, losses = ts.pos, ts.size, [], []
        for _ in range(cfg.steps_per_iter):
            x = torch.randn(cfg.num_envs, 3, generator=ts.gen)
            rows = torch.cat([x, (x @ ts.w_true)[:, None]], 1)
            ts.replay[(pos + torch.arange(cfg.num_envs)) % cfg.memory_capacity] = rows
            pos, size = pos + cfg.num_envs, min(size + cfg.num_envs, cfg.memory_capacity)
            pushed.append(rows)
            mark("act")
            if size >= cfg.batch_size:
                for _ in range(cfg.updates_per_step):
                    mb = ts.replay[torch.randint(size, (cfg.batch_size,), generator=ts.gen)]
                    if self.half:
                        mb = mb[: len(mb) // 2]
                    loss = torch.mean((ts.params(mb[:, :3]).squeeze(-1) - mb[:, 3]) ** 2)
                    ts.opt_state.zero_grad()
                    loss.backward()
                    ts.opt_state.step()
                    losses.append(loss.detach())
            mark("update")
        self.last_rows = torch.cat(pushed)
        mean = torch.stack(losses).mean()
        done = torch.ones(cfg.num_envs, dtype=torch.bool)
        out = Out(done, (-mean).expand(cfg.num_envs).clone(), {"loss": mean})
        return ts._replace(pos=pos, size=size), out
'''

PROGRAM_SIDE = '''
import numpy as np

from benchlib import program


class Program:
    METRICS = ("loss",)
    KERNELS = ()
    PHASES = ("act", "update")

    def __init__(self, trainer, ts):
        self.trainer, self.ts = trainer, ts

    @staticmethod
    def env_steps(cfg):
        return cfg["num_envs"] * cfg["steps_per_iter"]

    def iterate(self):
        self.ts, out, done, finals = program.iteration(self.trainer, self.ts)
        return {"metrics": [float(out.metrics["loss"])],
                "episodes": (int(done.sum()), float(np.sum(finals, dtype=np.float64))),
                "rows": self.trainer.last_rows}

    @staticmethod
    def params_of(ts):
        return dict(ts.params.named_parameters())

    def leaves(self):
        return self.params_of(self.ts)

    def moments(self):
        return {k: self.ts.opt_state.state[p]["exp_avg"] for k, p in self.leaves().items()}
'''

REFERENCE = '''
import torch


class Rows:
    def __init__(self, n, gen, w_true):
        self.n, self.gen, self.w_true = n, gen, w_true

    def draw(self):
        x = torch.randn(self.n, 3, generator=self.gen)
        return torch.cat([x, (x @ self.w_true)[:, None]], 1)


class Reference:
    METRICS = ("loss",)

    def __init__(self, cfg, seed, device, f32_matmul, env):
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter(torch.randn(1, 3, generator=gen))
        self.b = torch.nn.Parameter(torch.zeros(1))
        self.w_true = torch.randn(3, generator=gen)
        self.opt = torch.optim.Adam([self.w, self.b], lr=cfg["lr"])
        self.gen, self.env = gen, env(cfg["num_envs"], gen, self.w_true)
        self.replay, self.filled = torch.zeros(cfg["memory_capacity"], 4), 0

    def iterate(self):
        cfg, pushed, losses = self.cfg, [], []
        cap, k = cfg["memory_capacity"], cfg["num_envs"]
        for _ in range(cfg["steps_per_iter"]):
            rows = self.env.draw()
            pushed.append(rows)
            for j, row in enumerate(rows):  # a ring of cap slots, oldest overwritten
                self.replay[(self.filled + j) % cap] = row
            self.filled += k
            size = min(self.filled, cap)
            if size >= cfg["batch_size"]:
                for _ in range(cfg["updates_per_step"]):
                    pick = torch.randint(size, (cfg["batch_size"],), generator=self.gen)
                    mb = self.replay[pick]
                    loss = torch.mean(((mb[:, :3] @ self.w.T + self.b).squeeze(-1)
                                       - mb[:, 3]) ** 2)
                    self.opt.zero_grad()
                    loss.backward()
                    self.opt.step()
                    losses.append(loss.detach())
        mean = float(torch.stack(losses).mean())
        return {"metrics": [mean], "episodes": (k, -mean * k), "rows": torch.cat(pushed)}

    @staticmethod
    def loss(cfg, metrics):
        return metrics[0]

    def judge_rows(self, rows):
        return float((rows[:, 3] - rows[:, :3] @ self.w_true).abs().max())

    def leaves(self):
        return {"weight": self.w, "bias": self.b}

    def moments(self):
        return {k: self.opt.state[p]["exp_avg"] for k, p in self.leaves().items()}
'''

FAULTS = '''
def half_batch(trainer):
    trainer.half = True


PLANTS = {"half_batch": half_batch}
'''

ACT_MS = '''
def read(view):
    rows = [r["act"] for r in view.phases if "act" in r]
    return sum(rows) / len(rows) if rows else None
'''

CONFIG = {
    "source": "an off-policy least-squares learner written for this test",
    "trainer": "toy_offpolicy:ToyOffPolicyTrainer",
    "config_class": "toy_offpolicy:ToyOffPolicyConfig",
    "program": "programs.toy_offpolicy:Program", "reference": "reference.toy_offpolicy:Reference",
    "reference_env": "reference.toy_offpolicy:Rows", "faults": "faults.toy_offpolicy:PLANTS",
    "reduced": [], "assumed": {}, "lr": 0.01, "memory_capacity": 32, "updates_per_step": 2,
}
CELL = "toy_offpolicy_steps4x4"

# The program sides of the port's trainers that no cell runs yet: what the
# harness asks of them outside the comparison.
SIDES = '''
class OffPolicy:
    PHASES = ("act", "update")

    @staticmethod
    def env_steps(cfg):
        return cfg["num_envs"] * cfg["steps_per_iter"]


class PPG:
    PHASES = ("rollout", "gae", "sgd", "aux")

    @staticmethod
    def env_steps(cfg):
        return cfg["num_envs"] * cfg["rollout_steps"]
'''


class ClockEvent:
    """A stand-in for ``torch.cuda.Event`` on the host's clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Clocked(harness.PhaseEvents):
    """``PhaseEvents`` timed by ``ClockEvent``s, and every one made kept."""

    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cuda = True
        Clocked.made.append(self)

    def _event(self):
        return ClockEvent()


def _digest(folder: str) -> dict[str, str]:
    out = {}
    for base, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(base, name)
            out[os.path.relpath(path, folder)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def _copy(tmp_path) -> str:
    dst = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return str(dst)


@pytest.fixture
def offpolicy_bench(tmp_path, monkeypatch):
    """A copy of the benchmark's folder with the off-policy cell's files
    written in as new files only, and its trainer module on the path."""
    dst = _copy(tmp_path)
    before = _digest(dst)
    (tmp_path / "toy_offpolicy.py").write_text(textwrap.dedent(TRAINER))
    monkeypatch.syspath_prepend(str(tmp_path))
    new = {
        "programs/toy_offpolicy.py": PROGRAM_SIDE,
        "reference/toy_offpolicy.py": REFERENCE,
        "faults/toy_offpolicy.py": FAULTS,
        "metrics/toy_act_ms.py": ACT_MS,
        "configs/toy_offpolicy.json": json.dumps(CONFIG),
        "traffic/steps4x4.json": json.dumps({"schedule": {"num_envs": 4, "steps_per_iter": 4,
                                                          "batch_size": 8}}),
        "limits/toy_offpolicy_steps4x4.json": json.dumps(
            {"loss": 1e-6, "moment": 1e-6, "change": 1e-6, "returns": 1e-6, "rollout": 1e-6}),
    }
    for rel, text in new.items():
        path = os.path.join(dst, rel)
        assert not os.path.exists(path), rel
        with open(path, "w") as f:
            f.write(text)
    after = _digest(dst)
    assert {k: after[k] for k in before} == before  # no file of the benchmark was edited
    bench = json.loads(json.dumps(files.benchmark()))
    bench["workloads"].append({"name": CELL, "config": "toy_offpolicy", "traffic": "steps4x4",
                               "chips": 1, "why": "an off-policy trainer"})
    bench["per_layer"].append({"name": "toy_act_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "act",
                               "moves": "env_steps_per_s", "workloads": [CELL]})
    return files.cell(bench, CELL), dst


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_an_off_policy_cell_runs_from_new_files_alone(offpolicy_bench, monkeypatch, fault, trace):
    the_cell, bench_dir = offpolicy_bench
    monkeypatch.setattr(harness, "PhaseEvents", Clocked)
    monkeypatch.setattr(Clocked, "made", [])
    assert "minibatch_size" not in files.run_config(the_cell, bench_dir)
    plant = files.obj(CONFIG["faults"], bench_dir)[fault] if fault else None
    r = harness.run(the_cell, 2**31 + 7, 0.2, trace, CPU, time.perf_counter(),
                    bench_dir=bench_dir, plant=plant)
    assert set(r["compared"]) == set(files.limits(CELL, bench_dir))
    if fault is None:
        assert r["correct"] is True
        assert all(c["value"] == 0.0 for c in r["compared"].values())
    else:
        assert r["correct"] is False
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "env_steps_per_s", "iter_ms_p90"}
        assert Clocked.made == []
        return
    window, profiled = Clocked.made
    assert r["metrics"]["toy_act_ms"]["value"] > 0
    for events in (window, profiled):
        rows = events.phase_ms()
        assert rows and all(set(row) == {"act", "update"} for row in rows)
        assert all(marks == ["act", "update"] * 4 for marks in events.marks)
    assert profiled.labels == (["act", "update"] * 4 + ["fetch"]) * harness.PROFILED_ITERS


def _rainbow():
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, rainbow_config

    return DQNFamilyTrainer(rainbow_config(num_envs=2, steps_per_iter=3, batch_size=4,
                                           updates_per_step=1, hidden_dim=16,
                                           memory_capacity=64), device=CPU)


def _sac():
    from gymrl_tpu_torch.algos.continuous import SACTrainer, sac_config

    return SACTrainer(sac_config(num_envs=2, steps_per_iter=3, batch_size=4, updates_per_step=1,
                                 hidden_dim=16, memory_capacity=64), device=CPU)


def _ppg():
    from gymrl_tpu_torch.algos.ppg import PPGTrainer, ppg_rnn_lunarlander_config

    return PPGTrainer(ppg_rnn_lunarlander_config(aux_every=1, num_envs=2, rollout_steps=16,
                                                 feature_dim=16, seq_minibatch=4, num_epochs=1,
                                                 aux_epochs=1), device=CPU)


def _ppo():
    from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer

    return PPOTrainer(PPOConfig(env_name="LunarLander-v3", hidden_dim=16, num_envs=4,
                                rollout_steps=8, num_epochs=1, minibatch_size=16), device=CPU)


@pytest.mark.parametrize("make,side,marks", [
    (_rainbow, "programs.any_trainer:OffPolicy", ["act", "update"] * 3),
    (_sac, "programs.any_trainer:OffPolicy", ["act", "update"] * 3),
    (_ppg, "programs.any_trainer:PPG", ["rollout", "gae", "sgd", "aux"]),
    (_ppo, "programs.ppo:Program", ["rollout", "gae", "sgd"]),
], ids=["rainbow", "sac", "ppg", "ppo"])
def test_the_ports_trainers_run_through_the_window_and_the_profiler(tmp_path, monkeypatch, make,
                                                                   side, marks):
    """Each trainer's phase rows come under its own marks, its profiled
    host spans under those and ``fetch``, and ``RunView``'s env steps an
    iteration are what its train state counts."""
    monkeypatch.setattr(Clocked, "made", [])
    bench_dir = _copy(tmp_path)
    with open(os.path.join(bench_dir, "programs", "any_trainer.py"), "w") as f:
        f.write(SIDES)
    cls = files.obj(side, bench_dir)
    trainer = make()
    ts = trainer.init(5)
    window, profiled = (Clocked(CPU, program.phases(cls), side) for _ in range(2))
    start = int(ts.env_steps)
    ts, times, window_s = harness._window(trainer, ts, 0.0, CPU, window)
    stepped = int(ts.env_steps) - start
    ts, kern, host, wall, _ = harness._profiled(trainer, ts, CPU, profiled)
    for events in (window, profiled):
        assert events.marks == [marks] * len(events.rows)
        assert all(set(row) == set(marks) for row in events.phase_ms())
    assert kern == [] and wall > 0
    assert [label for label, _, _ in sorted(host, key=lambda h: h[1])] == \
        (marks + ["fetch"]) * harness.PROFILED_ITERS
    conf = {"program": side}
    view = harness.RunView(conf, dataclasses.asdict(trainer.cfg), 1.0, times, window_s,
                           window.phase_ms(), bench_dir=bench_dir)
    assert len(times) == 1 and view.steps_per_iter == stepped


def test_a_mark_the_program_side_does_not_declare_is_refused():
    """The PPO family's marks on an off-policy trainer: the first ``"act"``
    is refused, naming the side and the mark."""
    trainer = _sac()
    events = harness.PhaseEvents(CPU, program.phases(object), "programs.ppo:Program")
    events.start()
    with pytest.raises(ValueError, match=r"programs\.ppo:Program marked 'act'"):
        trainer.train_iter(trainer.init(1), events)
