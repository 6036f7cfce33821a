"""The system under test, driven as its users' loop drives it.

The only module of the benchmark that imports the program
(``gymrl_tpu_torch``). ``iteration`` is one ``train_iter`` followed by the
host fetch of the episode statistics that ``run/loop.py`` ``TrainLoop.train``
makes after every iteration (:95-100): the sync users' loops pay. Eval,
checkpoints, logging and the solve stop are left out.

``run_setup`` builds the trainer and its state from the seed and drives it
through the comparison's first iterations (``compare.SETUP_ITERS``: the
eager sweep, the capture of the sweep's CUDA graph with its first replay, a
replay), the same object the window then drives, through the program side
that the configuration names (``programs/<name>.py``), which keeps what the
comparison reads of them.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch


# The marks of a trainer whose program side declares no ``PHASES``: the PPO
# family's three, each once an iteration.
PHASES = ("rollout", "gae", "sgd")


def phases(side) -> tuple[str, ...]:
    """The marks a program side's trainer makes, in order (its ``PHASES``)."""
    return tuple(getattr(side, "PHASES", PHASES))


class OnPolicy:
    """What the PPO family's program sides share: an iteration steps
    ``num_envs × rollout_steps`` env steps and updates on whole minibatches
    of ``minibatch_size`` of those rows; ``TINY``, the schedule the CPU tests
    run in seconds."""

    TINY = {"num_envs": 8, "rollout_steps": 8, "num_epochs": 2, "minibatch_size": 16}

    @staticmethod
    def env_steps(cfg: dict) -> int:
        return cfg["num_envs"] * cfg["rollout_steps"]

    @staticmethod
    def check(cfg: dict) -> None:
        """Refuses settings whose rollout is no whole number of minibatches."""
        if cfg["num_envs"] * cfg["rollout_steps"] % cfg["minibatch_size"]:
            raise ValueError(f"{cfg['num_envs']} envs x {cfg['rollout_steps']} steps is no "
                             f"whole number of {cfg['minibatch_size']}-row minibatches")


def trainer_class(spec: str):
    """``"package.module:Class"`` → the class."""
    mod, _, name = spec.partition(":")
    return getattr(importlib.import_module(mod), name)


def build(conf: dict, run_cfg: dict, device: torch.device):
    """The trainer of ``conf`` (a configuration's file) with ``run_cfg``."""
    cfg_cls = trainer_class(conf["config_class"])
    names = {f.name for f in dataclasses.fields(cfg_cls)}
    unknown = sorted(set(run_cfg) - names)
    if unknown:
        raise KeyError(f"{conf['config_class']} has no settings {unknown}")
    return trainer_class(conf["trainer"])(cfg_cls(**run_cfg), device=device)


def iteration(trainer, ts, timer=None):
    """One ``train_iter`` and the host fetch of its episode statistics."""
    ts, out = trainer.train_iter(ts, timer)
    done = out.ep_done.cpu().numpy()
    finals = out.ep_return.cpu().numpy()[done] if done.any() else np.zeros(0, np.float32)
    return ts, out, done, finals


def launches() -> dict[str, int]:
    """The program's own count of its hand-written kernels' launches."""
    from gymrl_tpu_torch import kernels

    return dict(kernels.LAUNCHES)


def build_seconds() -> dict[str, float]:
    """Seconds each kernel library took to compile in this process."""
    from gymrl_tpu_torch.kernels import build

    return dict(build.BUILD_SECONDS)


def run_setup(conf: dict, run_cfg: dict, seed: int, device: torch.device, plant=None,
              stages: list | None = None, bench_dir: str | None = None):
    """``(trainer, ts, summary)``: the trainer made from ``seed`` and
    driven through the comparison's iterations by its program side;
    ``plant(trainer)``, a test's fault, breaks the trainer before its first
    iteration. ``stages`` gets the host clock after each stage."""
    from benchlib import compare, files

    mark = (lambda name: stages.append((name, time.perf_counter()))) if stages is not None \
        else (lambda name: None)
    trainer = build(conf, run_cfg, device)
    mark("build")
    if plant is not None:
        plant(trainer)
    ts = trainer.init(seed)
    mark("init")
    side = files.obj(conf["program"], bench_dir or files.BENCH_DIR)(trainer, ts)
    summary = compare.summarize(side, lambda k: mark(f"iteration {k + 1}"))
    return trainer, side.ts, summary
