"""A cell of a trainer the benchmark has never seen, added as new files alone:
the trainer (here a small least-squares learner standing in for the port's),
its program side, its plain reference and reference env, its faults, its
configuration, traffic mix and limits. The harness runs it from the names in
its configuration's file, with no file of the benchmark edited: sound, it
comes out correct; with its fault planted, not correct."""

import hashlib
import json
import os
import shutil
import textwrap
import time

import pytest
import torch

from benchlib import files, harness

from conftest import BENCH_DIR

TRAINER = '''
import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ToyConfig:
    num_envs: int = 4
    rollout_steps: int = 8
    num_epochs: int = 2
    minibatch_size: int = 8
    lr: float = 1e-2


class State(NamedTuple):
    params: torch.nn.Module
    opt_state: torch.optim.Adam
    gen: torch.Generator
    w_true: torch.Tensor


class Out(NamedTuple):
    ep_done: torch.Tensor
    ep_return: torch.Tensor
    metrics: dict


class ToyTrainer:
    def __init__(self, cfg, device):
        self.cfg, self.device, self.half, self.last_rows = cfg, device, False, None

    def init(self, seed):
        gen = torch.Generator().manual_seed(seed)
        net = torch.nn.Linear(3, 1)
        with torch.no_grad():
            net.weight.copy_(torch.randn(1, 3, generator=gen))
            net.bias.zero_()
        w_true = torch.randn(3, generator=gen)
        return State(net, torch.optim.Adam(net.parameters(), lr=self.cfg.lr), gen, w_true)

    def train_iter(self, ts, timer=None):
        n = self.cfg.num_envs * self.cfg.rollout_steps
        x = torch.randn(n, 3, generator=ts.gen)
        rows = torch.cat([x, (x @ ts.w_true)[:, None]], 1)
        losses = []
        for _ in range(self.cfg.num_epochs):
            perm = torch.randperm(n, generator=ts.gen)
            for mb in rows[perm].split(self.cfg.minibatch_size):
                if self.half:
                    mb = mb[: len(mb) // 2]
                loss = torch.mean((ts.params(mb[:, :3]).squeeze(-1) - mb[:, 3]) ** 2)
                ts.opt_state.zero_grad()
                loss.backward()
                ts.opt_state.step()
                losses.append(loss.detach())
        self.last_rows = rows
        mean = torch.stack(losses).mean()
        done = torch.ones(self.cfg.num_envs, dtype=torch.bool)
        return ts, Out(done, (-mean).expand(self.cfg.num_envs).clone(), {"loss": mean})
'''

PROGRAM_SIDE = '''
import numpy as np

from benchlib import program


class Program:
    METRICS = ("loss",)
    KERNELS = ()

    def __init__(self, trainer, ts):
        self.trainer, self.ts = trainer, ts

    def iterate(self):
        self.ts, out, done, finals = program.iteration(self.trainer, self.ts)
        return {"metrics": [float(out.metrics["loss"])],
                "episodes": (int(done.sum()), float(np.sum(finals, dtype=np.float64))),
                "rows": self.trainer.last_rows}

    @staticmethod
    def env_steps(cfg):
        return cfg["num_envs"] * cfg["rollout_steps"]

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
        self.gen, self.n = gen, cfg["num_envs"] * cfg["rollout_steps"]
        self.env = env(self.n, gen, self.w_true)

    def iterate(self):
        rows = self.env.draw()
        losses = []
        for _ in range(self.cfg["num_epochs"]):
            perm = torch.randperm(self.n, generator=self.gen)
            for mb in rows[perm].split(self.cfg["minibatch_size"]):
                pred = mb[:, :3] @ self.w.T + self.b
                loss = torch.mean((pred.squeeze(-1) - mb[:, 3]) ** 2)
                self.opt.zero_grad()
                loss.backward()
                self.opt.step()
                losses.append(loss.detach())
        mean = float(torch.stack(losses).mean())
        k = self.cfg["num_envs"]
        return {"metrics": [mean], "episodes": (k, -mean * k), "rows": rows}

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

CONFIG = {
    "source": "a least-squares learner written for this test",
    "trainer": "toy_trainer:ToyTrainer", "config_class": "toy_trainer:ToyConfig",
    "program": "programs.toy_lsq:Program", "reference": "reference.toy_lsq:Reference",
    "reference_env": "reference.toy_lsq:Rows", "faults": "faults.toy_lsq:PLANTS",
    "reduced": [], "assumed": {}, "lr": 0.01,
}


def _digest(folder: str) -> dict[str, str]:
    out = {}
    for base, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(base, name)
            out[os.path.relpath(path, folder)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


@pytest.fixture
def new_trainer_bench(tmp_path, monkeypatch):
    """A copy of the benchmark's folder and a trainer module on the path; the
    cell's files are written into the copy as new files only."""
    dst = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(str(dst))
    (tmp_path / "toy_trainer.py").write_text(textwrap.dedent(TRAINER))
    monkeypatch.syspath_prepend(str(tmp_path))
    new = {
        "programs/toy_lsq.py": PROGRAM_SIDE,
        "reference/toy_lsq.py": REFERENCE,
        "faults/toy_lsq.py": FAULTS,
        "configs/toy_lsq.json": json.dumps(CONFIG),
        "traffic/rows4x8.json": json.dumps({"schedule": {"num_envs": 4, "rollout_steps": 8,
                                                         "num_epochs": 2, "minibatch_size": 8}}),
        "limits/toy_lsq_rows4x8.json": json.dumps(
            {"loss": 1e-6, "moment": 1e-6, "change": 1e-6, "returns": 1e-6, "rollout": 1e-6}),
    }
    for rel, text in new.items():
        path = dst / rel
        assert not path.exists(), rel
        path.write_text(text)
    after = _digest(str(dst))
    assert {k: after[k] for k in before} == before  # no file of the benchmark was edited
    bench = json.loads(json.dumps(files.benchmark()))
    bench["workloads"].append({"name": "toy_lsq_rows4x8", "config": "toy_lsq",
                               "traffic": "rows4x8", "chips": 1, "why": "a new trainer"})
    return files.cell(bench, "toy_lsq_rows4x8"), str(dst)


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_a_new_trainers_cell_runs_from_new_files_alone(new_trainer_bench, fault):
    the_cell, bench_dir = new_trainer_bench
    conf = files.config("toy_lsq", bench_dir)
    plant = files.obj(conf["faults"], bench_dir)[fault] if fault else None
    r = harness.run(the_cell, 2**31 + 5, 0.2, False, torch.device("cpu"), time.perf_counter(),
                    bench_dir=bench_dir, plant=plant)
    assert set(r["metrics"]) == {"setup_s", "env_steps_per_s", "iter_ms_p90"}
    assert set(r["compared"]) == set(files.limits("toy_lsq_rows4x8", bench_dir))
    if fault is None:
        assert r["correct"] is True
        assert all(c["value"] == 0.0 for c in r["compared"].values())
    else:
        assert r["correct"] is False
