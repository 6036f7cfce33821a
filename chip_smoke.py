"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python chip_smoke.py

Drives ``gymrl_tpu_torch``'s main path, PPO on LunarLander, on the card and
checks what comes out. Every phase raises on failure; the script exits 0
only if all of them pass.

  0. Device: a CUDA device must be present; prints ``nvidia-smi``'s name
     and power limit for the card.
  1. Physics: B=8192 lander states, made by rolling the port on the CPU
     with random actions until about 40% of them touch the ground, are
     stepped once on the card and once on the CPU with the same actions
     and dispersion draws. Kinematics and rewards must agree to 1e-4; at
     most 8 of the 8192 envs may differ more, or in their contact and
     termination flags (a contact test that ties within float32 rounding
     on one side only).
  2. Bench config (``gymrl_tpu_torch.bench``: B=8192, T=64, 4 epochs of
     minibatch 16384, flat optimizer, bf16 SGD): one warm-up ``train_iter``
     and three timed ones. Prints env-steps/s, each phase's time from CUDA
     events (rollout; next-value forward plus GAE; SGD) and the peak device
     memory, and checks the step count, finite metrics, moved params and
     Adam's step count.
  3. Entry point: the CLI's ``ppo_lunarlander`` workload through
     ``TrainLoop`` for three iterations with its checkpoint in a temporary
     directory, then ``TrainLoop.test`` (five deterministic episodes), then
     a restore of the saved checkpoint into a fresh state.
  4. Kernels: the port has no hand-written kernel (the JAX package has no
     Pallas kernel to port), so the kernel list is empty.

The last line of output is one JSON object naming the device.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import torch

PHYS_ENVS = 8192
PHYS_WARM_STEPS = 90  # random-action steps until ~40% of landers touch the ground
PHYS_ATOL = 1e-4
PHYS_MAX_TIES = 8
BENCH_TIMED_ITERS = 3
ENTRY_ITERS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_physics(device: torch.device, num: int = PHYS_ENVS,
                  warm_steps: int = PHYS_WARM_STEPS) -> dict:
    """One lander step on ``device`` against the same step on the CPU."""
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.envs.rollout import VecEnv

    env = LunarLander()
    params = env.default_params()
    venv = VecEnv(env, params, num)
    noise = Noise("cpu", 0)
    actions_gen = torch.Generator().manual_seed(1)

    def random_actions():
        return torch.randint(0, env.n_actions, (num,), generator=actions_gen, dtype=torch.int32)

    vs = venv.reset(noise)
    for _ in range(warm_steps):
        vs, _ = venv.step(vs, random_actions(), noise)
    state, actions, disp = vs.env_state, random_actions(), env.step_draws(noise, num)

    cpu = env.step_from(params, state, actions, disp)
    on_dev = env.step_from(
        params, type(state)(*(x.to(device) for x in state)), actions.to(device), disp.to(device))
    if device.type == "cuda":
        torch.cuda.synchronize()

    err = torch.zeros(num, dtype=torch.float64)
    max_err = {}
    for name, got, want in (
        ("pos", on_dev.state.pos, cpu.state.pos), ("vel", on_dev.state.vel, cpu.state.vel),
        ("angle", on_dev.state.angle, cpu.state.angle), ("omega", on_dev.state.omega, cpu.state.omega),
        ("reward", on_dev.reward, cpu.reward),
    ):
        e = (got.cpu().double() - want.double()).abs().reshape(num, -1).amax(dim=1)
        max_err[name] = float(e.max())
        err = torch.maximum(err, e)
    flags_differ = torch.zeros(num, dtype=torch.bool)
    flag_counts = {}
    for name, got, want in (
        ("terminated", on_dev.terminated, cpu.terminated),
        ("leg_contact", on_dev.state.leg_contact, cpu.state.leg_contact),
    ):
        d = (got.cpu() != want).reshape(num, -1).any(dim=1)
        flag_counts[name] = int(d.sum())
        flags_differ |= d
    ties = flags_differ | (err > PHYS_ATOL)
    result = {
        "envs": num,
        "in_contact": int(cpu.state.leg_contact.any(dim=1).sum()),
        "terminated": int(cpu.terminated.sum()),
        "max_abs_err": max_err,
        "max_abs_err_outside_ties": float(err[~ties].max()),
        "flags_differ": flag_counts,
        "ties": int(ties.sum()),
    }
    log("phase 1 physics: " + json.dumps(result))
    if result["ties"] > PHYS_MAX_TIES:
        raise AssertionError(f"{result['ties']} envs disagree (allowed {PHYS_MAX_TIES})")
    if not result["max_abs_err_outside_ties"] < PHYS_ATOL:
        raise AssertionError(f"physics differs by {result['max_abs_err_outside_ties']}")
    return result


class PhaseClock:
    """Phase times of ``train_iter`` from CUDA events on a GPU (host clock
    on the CPU, for rehearsals); ``mark`` is the trainer's phase hook."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list[tuple[str, object]] = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [("start", self._now())]

    def mark(self, phase: str) -> None:
        self.marks.append((phase, self._now()))

    def phase_ms(self) -> dict[str, float]:
        """Milliseconds of each phase since the previous mark; call after a
        synchronize."""
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def phase_bench(device: torch.device, cfg=None, timed_iters: int = BENCH_TIMED_ITERS) -> dict:
    """The bench config's train_iter on ``device``: throughput and phases."""
    from gymrl_tpu_torch.algos.ppo import PPOTrainer
    from gymrl_tpu_torch.bench import BENCH_CONFIG

    cfg = cfg or BENCH_CONFIG
    cuda = device.type == "cuda"
    trainer = PPOTrainer(cfg, device=device)
    ts = trainer.init(0)
    initial = {k: v.detach().clone() for k, v in ts.params.state_dict().items()}

    ts, _ = trainer.train_iter(ts)  # warm-up
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    clock = PhaseClock(device)
    phases, walls = [], []
    for _ in range(timed_iters):
        t0 = time.perf_counter()
        clock.start()
        ts, out = trainer.train_iter(ts, timer=clock.mark)
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(clock.phase_ms())

    result = {
        "config": {k: getattr(cfg, k) for k in ("num_envs", "rollout_steps", "num_epochs",
                                                "minibatch_size", "flat_optimizer", "sgd_bf16")},
        "env_steps_per_s": timed_iters * cfg.batch_total / sum(walls),
        "iter_wall_ms": [w * 1e3 for w in walls],
        "phase_ms": {p: [ph[p] for ph in phases] for p in ("rollout", "gae", "sgd")},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "metrics": {k: float(v) for k, v in out.metrics.items()},
    }
    log("phase 2 bench config: " + json.dumps(result))

    iters = timed_iters + 1
    if ts.env_steps != iters * cfg.batch_total:
        raise AssertionError(f"env_steps {ts.env_steps} != {iters} x {cfg.batch_total}")
    if not all(math.isfinite(v) for v in result["metrics"].values()):
        raise AssertionError(f"non-finite metrics {result['metrics']}")
    state = ts.params.state_dict()
    if not all(v.device.type == device.type for v in state.values()):
        raise AssertionError("params left the device")
    if not all(not torch.equal(state[k], v) for k, v in initial.items()):
        raise AssertionError("some parameter did not move")
    steps = {int(s["step"]) for s in ts.opt_state.state.values()}
    if steps != {iters * cfg.num_epochs * cfg.num_minibatches}:
        raise AssertionError(f"Adam step counts {steps}")
    return result


def phase_entry(device: torch.device, iters: int = ENTRY_ITERS, episodes: int = 5) -> dict:
    """The CLI's ppo_lunarlander workload through TrainLoop, its test and a
    checkpoint restore."""
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint

    trainer, algo, solve = cli.WORKLOADS["ppo_lunarlander"](str(device))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the loop saves to ./checkpoints
        try:
            loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, save_every=10 ** 12)
        finally:
            os.chdir(cwd)
        t0 = time.perf_counter()
        ts, stats = loop.train(iters * trainer.cfg.batch_total, solve_threshold=solve)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mean_reward = loop.test(ts, episodes=episodes)
        test_s = time.perf_counter() - t0
        restored = restore_checkpoint(loop.ckpt_path, trainer.init(1))

    if stats["env_steps"] != iters * trainer.cfg.batch_total:
        raise AssertionError(f"trained {stats['env_steps']} env steps")
    if not math.isfinite(mean_reward):
        raise AssertionError(f"test reward {mean_reward}")
    want = ts.params.state_dict()
    got = restored.params.state_dict()
    if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("restored params differ from the trained ones")
    if restored.env_steps != ts.env_steps:
        raise AssertionError("restored env_steps differ")
    result = {"env_steps": stats["env_steps"], "train_s": train_s, "test_episodes": episodes,
              "test_mean_reward": mean_reward, "test_s": test_s, "checkpoint_restored": True}
    log("phase 3 entry point: " + json.dumps(result))
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import gymrl_tpu_torch  # noqa: F401 — fails here when run outside the repo
    from gymrl_tpu_torch.utils.device import gpu_name_and_power_limit, resolve_device

    device = resolve_device("cuda")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(gpu_name_and_power_limit())  # nvidia-smi's "name, power.limit" line

    phase_physics(device)
    phase_bench(device)
    phase_entry(device)
    log(json.dumps({"kernels": []}))
    log(f"total_s: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
