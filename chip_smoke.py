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
  4. Classic envs: B=8192 CartPole, Pendulum and continuous-lander states,
     made on the CPU from a fixed seed, stepped once on the card and once
     on the CPU with the same actions and draws. Each state field and the
     reward must agree to 1e-5 (1e-4 for the lander, as in phase 1); at
     most 8 envs may differ more, or in a flag.
  5. Off-policy updates: one update of DQN, DDPG, TD3, SAC and discrete SAC
     at the CLI configs' widths, on the card and on the CPU from the same
     params, the same sampled batch and the same draws (made on the CPU).
     Losses agree to rtol 1e-5 (the actor and α losses read the critic the
     same update stepped and tanh-saturated log-probs, so they get an atol
     of 1e-4 besides); params to 1e-5, except the entries whose step
     float32 agreement does not fix, held to 2·lr: a gradient below
     1e-6·max|g| of its tensor or below 1e-6 (Adam's eps 1e-8 turns its
     rounding into a sign), or a ReLU whose pre-activation for a sample
     lies within 1e-5 of zero (its row and column).
  6. Off-policy workloads: each of the CLI's dqn_cartpole, ppo_cartpole,
     sac_pendulum, sac_cartpole, td3_pendulum and ddpg_pendulum through
     ``TrainLoop`` for one warm-up iteration, then two timed iterations
     (env-steps/s, updates/s, per-phase CUDA-event times summed over the
     iteration, peak memory), ``TrainLoop.test`` (five episodes), and a
     checkpoint restore into a fresh state. Checks the env-step, replay and
     learn-step counts, finite metrics, that every online net moved and
     stayed on the card, each Adam step count against its cadence (TD3's
     actor on learn steps 0, 2, 4, ...; DQN's target syncs = episodes // 4)
     and that the restored state equals the trained one.
  7. Kernels: the port has no hand-written kernel (the JAX package has no
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
CLASSIC_ENVS = 8192
CLASSIC_WARM_STEPS = 40
CLASSIC_ATOL = 1e-5
UPDATE_RTOL = 1e-5
UPDATE_LOSS_ATOL = 1e-4  # actor and α losses (see the module docstring)
PARAM_ATOL = 1e-5
TINY_GRAD = 1e-6
RELU_TIE = 1e-5
WORKLOADS = ("dqn_cartpole", "ppo_cartpole", "sac_pendulum", "sac_cartpole", "td3_pendulum",
             "ddpg_pendulum")
WORKLOAD_TIMED_ITERS = 2


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
        """Milliseconds of each phase since the previous mark, summed over
        the marks that share a name; call after a synchronize."""
        out: dict[str, float] = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + (a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
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


# -- phase 4: classic envs, card vs CPU ------------------------------------------
def _random_actions(env, num: int, gen: torch.Generator) -> torch.Tensor:
    if env.discrete:
        return torch.randint(0, env.n_actions, (num,), generator=gen, dtype=torch.int32)
    # continuous: 1.5 × the bound, so the engine's own clip acts too
    return (torch.rand((num, env.act_dim), generator=gen) * 3.0 - 1.5) * env.action_bound


def compare_env_step(env, device: torch.device, num: int, warm_steps: int, atol: float,
                     max_ties: int = PHYS_MAX_TIES) -> dict:
    """One step of ``env`` on ``device`` against the same step on the CPU, from
    states reached by ``warm_steps`` random-action steps with autoreset."""
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.rollout import VecEnv

    params = env.default_params()
    venv = VecEnv(env, params, num)
    noise = Noise("cpu", 0)
    gen = torch.Generator().manual_seed(1)
    vs = venv.reset(noise)
    for _ in range(warm_steps):
        vs, _ = venv.step(vs, _random_actions(env, num, gen), noise)
    state, actions = vs.env_state, _random_actions(env, num, gen)
    draws = env.step_draws(noise, num)
    cpu = env.step_from(params, state, actions, draws)
    on_dev = env.step_from(params, type(state)(*(x.to(device) for x in state)), actions.to(device),
                           None if draws is None else draws.to(device))
    if device.type == "cuda":
        torch.cuda.synchronize()

    err = torch.zeros(num, dtype=torch.float64)
    flags_differ = torch.zeros(num, dtype=torch.bool)
    max_err, flag_counts = {}, {}
    fields = list(zip(state._fields, on_dev.state, cpu.state))
    fields += [("reward", on_dev.reward, cpu.reward), ("terminated", on_dev.terminated, cpu.terminated),
               ("truncated", on_dev.truncated, cpu.truncated)]
    for name, got, want in fields:
        got = got.cpu()
        if want.is_floating_point():
            e = (got.double() - want.double()).abs().reshape(num, -1).amax(dim=1)
            max_err[name] = float(e.max())
            err = torch.maximum(err, e)
        else:
            d = (got != want).reshape(num, -1).any(dim=1)
            flag_counts[name] = int(d.sum())
            flags_differ |= d
    ties = flags_differ | (err > atol)
    result = {
        "env": env.name + (" (continuous)" if getattr(env, "continuous", False) else ""),
        "envs": num, "atol": atol, "max_abs_err": max_err,
        "max_abs_err_outside_ties": float(err[~ties].max()),
        "flags_differ": flag_counts, "ties": int(ties.sum()),
    }
    if result["ties"] > max_ties:
        raise AssertionError(f"{result}: {result['ties']} envs disagree (allowed {max_ties})")
    if not result["max_abs_err_outside_ties"] <= atol:
        raise AssertionError(f"{result}: step differs by {result['max_abs_err_outside_ties']}")
    return result


def phase_classic(device: torch.device, num: int = CLASSIC_ENVS) -> list[dict]:
    from gymrl_tpu_torch.envs.cartpole import CartPole
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.envs.pendulum import Pendulum

    results = [
        compare_env_step(CartPole(), device, num, CLASSIC_WARM_STEPS, CLASSIC_ATOL),
        compare_env_step(Pendulum(), device, num, CLASSIC_WARM_STEPS, CLASSIC_ATOL),
        compare_env_step(LunarLander(continuous=True), device, num, PHYS_WARM_STEPS, PHYS_ATOL),
    ]
    for r in results:
        log("phase 4 classic envs: " + json.dumps(r))
    return results


# -- phase 5: off-policy updates, card vs CPU ---------------------------------------
class FixedDraws:
    """The draws of one update, made on the CPU and handed out on any device."""

    def __init__(self, device: torch.device, indices: torch.Tensor, normals: torch.Tensor):
        self.device = device
        self.indices, self.normals = indices, normals

    def replay_indices(self, batch_size, high):
        return self.indices[:batch_size].to(self.device)

    def target_noise(self, shape):
        return self.normals[0].reshape(shape).to(self.device)

    def sac_update_noise(self, shape):
        return self.normals[0].reshape(shape).to(self.device), self.normals[1].reshape(shape).to(self.device)


def _stepped(trainer, ts) -> list[tuple[str, object, float]]:
    """(name, module or bare parameter, lr) of each network an update steps."""
    cfg = trainer.cfg
    if hasattr(ts, "nets"):
        lrs = {"actor": cfg.lr_actor, "critic": cfg.lr_critic, "critic1": cfg.lr_critic,
               "critic2": cfg.lr_critic, "log_alpha": cfg.lr_alpha}
        return [(k, v, lrs[k]) for k, v in ts.nets.items()]
    return [("q", ts.params, cfg.lr)]


def _named_tensors(stepped) -> dict[str, torch.Tensor]:
    out = {}
    for name, net, _ in stepped:
        if isinstance(net, torch.nn.Module):
            out.update({f"{name}.{k}": v.detach() for k, v in net.named_parameters()})
        else:
            out[name] = net.detach()
    return out


def _watch_relu_ties(stepped) -> tuple[list, list]:
    """Forward hooks recording, in grad-enabled forwards, the outputs of each
    Linear layer that feeds a ReLU (one with a later sibling reading its
    width). Returns (records, hook handles)."""
    records, handles = [], []
    for name, net, _ in stepped:
        if not isinstance(net, torch.nn.Module):
            continue
        for parent_name, parent in net.named_modules():
            layers = [(n, m) for n, m in parent.named_children() if isinstance(m, torch.nn.Linear)]
            for i, (lname, layer) in enumerate(layers):
                consumers = [f"{name}.{parent_name}.{n}".replace("..", ".") for n, m in layers[i + 1:]
                             if m.in_features == layer.out_features]
                if not consumers:
                    continue
                full = f"{name}.{parent_name}.{lname}".replace("..", ".")

                def hook(mod, args, out, full=full, consumers=consumers):
                    if torch.is_grad_enabled() and mod.weight.requires_grad:
                        records.append((full, consumers, out.detach().reshape(-1, out.shape[-1])))

                handles.append(layer.register_forward_hook(hook))
    return records, handles


def _exempt(stepped, records) -> dict[str, torch.Tensor]:
    """Entries whose step float32 agreement does not fix (module docstring)."""
    masks = {}
    for name, net, _ in stepped:
        params = (list(net.named_parameters()) if isinstance(net, torch.nn.Module) else [("", net)])
        for k, p in params:
            a = p.grad.abs()
            masks[f"{name}.{k}".rstrip(".")] = a < torch.clamp(TINY_GRAD * a.max(), min=TINY_GRAD)
    for layer, consumers, out in records:
        units = (out.abs() < RELU_TIE).any(dim=0)
        masks[f"{layer}.weight"] |= units[:, None]
        masks[f"{layer}.bias"] |= units
        for c in consumers:
            masks[f"{c}.weight"] |= units[None, :]
    return masks


def _update_case(name: str, device: torch.device):
    """A trainer at the CLI config of ``name`` on ``device`` and its fresh state."""
    from gymrl_tpu_torch.run import cli

    trainer, _, _ = cli.WORKLOADS[name](str(device))
    return trainer, trainer.init(0)


def _one_update(trainer, ts, batch_cpu, draws):
    """One update on ``trainer``'s device; returns the losses by name."""
    from gymrl_tpu_torch.replay.uniform import replay_init, replay_push_batch

    dev = trainer.device
    batch = type(batch_cpu)(*(x.to(dev) for x in batch_cpu))
    if hasattr(ts, "nets"):  # the off-policy update takes its sampled batch
        idx = draws.replay_indices(trainer.cfg.batch_size, batch[0].shape[0])
        batch = type(batch)(*(x[idx] for x in batch))
        return dict(zip(trainer.metric_names, trainer._update(ts, batch, 0, draws)))
    replay = replay_push_batch(replay_init(type(batch)(*(x[0] for x in batch)), batch[0].shape[0], dev),
                               batch)
    loss = trainer._update(ts.params, ts.target_params, ts.opt_state, list(ts.params.parameters()),
                           replay, draws)
    return {"loss": loss}


def _random_batch(trainer, n: int, gen: torch.Generator):
    obs_dim = trainer.venv.env.obs_dim
    env = trainer.venv.env
    obs = torch.randn((n, obs_dim), generator=gen)
    if env.discrete:
        action = torch.randint(0, env.n_actions, (n,), generator=gen, dtype=torch.int32)
    else:
        action = (torch.rand((n, env.act_dim), generator=gen) * 2 - 1) * env.action_bound
    reward = -torch.rand(n, generator=gen) * (16.0 if not env.discrete else 1.0)
    next_obs = obs + 0.1 * torch.randn((n, obs_dim), generator=gen)
    done = (torch.rand(n, generator=gen) < 0.1).float()
    return sys.modules[type(trainer).__module__].Transition(obs, action, reward, next_obs, done)


def phase_updates(device: torch.device) -> list[dict]:
    cases = (("dqn", "dqn_cartpole"), ("ddpg", "ddpg_pendulum"), ("td3", "td3_pendulum"),
             ("sac", "sac_pendulum"), ("sacd", "sac_cartpole"))
    results = []
    for algo, workload in cases:
        cpu_tr, cpu_ts = _update_case(workload, torch.device("cpu"))
        dev_tr, dev_ts = _update_case(workload, device)
        gen = torch.Generator().manual_seed(7)
        n = 4 * cpu_tr.cfg.batch_size
        batch = _random_batch(cpu_tr, n, gen)
        draws_shape = (2, cpu_tr.cfg.batch_size) + tuple(batch.action.shape[1:])
        indices = torch.randint(0, n, (cpu_tr.cfg.batch_size,), generator=gen)
        normals = torch.randn(draws_shape, generator=gen)
        cpu_stepped, dev_stepped = _stepped(cpu_tr, cpu_ts), _stepped(dev_tr, dev_ts)
        records, handles = _watch_relu_ties(cpu_stepped)
        cpu_losses = _one_update(cpu_tr, cpu_ts, batch, FixedDraws(torch.device("cpu"), indices, normals))
        for h in handles:
            h.remove()
        dev_losses = _one_update(dev_tr, dev_ts, batch, FixedDraws(device, indices, normals))
        if device.type == "cuda":
            torch.cuda.synchronize()

        exempt = _exempt(cpu_stepped, records)
        want, got = _named_tensors(cpu_stepped), _named_tensors(dev_stepped)
        lr_of = {}
        for name, net, lr in cpu_stepped:
            for k in want:
                if k == name or k.startswith(name + "."):
                    lr_of[k] = lr
        worst, worst_exempt, n_exempt = 0.0, 0.0, 0
        for k, w in want.items():
            e = (got[k].cpu().double() - w.double()).abs()
            ok = (e <= PARAM_ATOL) | (exempt[k] & (e <= 2.0 * lr_of[k]))
            if not bool(ok.all()):
                raise AssertionError(f"{algo}: {k} differs by {float(e.max())} on the card")
            worst = max(worst, float(e[~exempt[k]].max()) if bool((~exempt[k]).any()) else 0.0)
            worst_exempt = max(worst_exempt, float(e[exempt[k]].max()) if bool(exempt[k].any()) else 0.0)
            n_exempt += int(exempt[k].sum())
        loss_err = {}
        for k, w in cpu_losses.items():
            g, w = float(dev_losses[k]), float(w)
            atol = UPDATE_LOSS_ATOL if k in ("actor_loss", "alpha_loss") else 0.0
            loss_err[k] = abs(g - w)
            if abs(g - w) > UPDATE_RTOL * abs(w) + atol:
                raise AssertionError(f"{algo}: {k} {g} on the card, {w} on the CPU")
        result = {"algo": algo, "config": workload, "batch": cpu_tr.cfg.batch_size,
                  "losses_cpu": {k: float(v) for k, v in cpu_losses.items()},
                  "loss_abs_err": loss_err, "param_max_abs_err": worst,
                  "exempt_entries": n_exempt, "exempt_max_abs_err": worst_exempt}
        log("phase 5 update: " + json.dumps(result))
        results.append(result)
    return results


# -- phase 6: off-policy workloads on the card -----------------------------------------
def _expected_updates(cfg, iters: int) -> int:
    """Updates of ``iters`` off-policy iterations from a fresh state: n_updates
    per env step once the replay holds a batch."""
    per_step = cfg.n_updates
    total = 0
    for t in range(iters * cfg.steps_per_iter):
        if min((t + 1) * cfg.num_envs, cfg.memory_capacity) >= cfg.batch_size:
            total += per_step
    return total


def _state_tensors(ts) -> dict[str, torch.Tensor]:
    """Every tensor of a train state that training moves, by path."""
    from gymrl_tpu_torch.utils.checkpoint import _to_tree

    out = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")

    walk(_to_tree(ts), "ts")
    return out


def _nets(ts) -> dict[str, torch.nn.Module]:
    if hasattr(ts, "nets"):
        return {k: v for k, v in ts.nets.items() if isinstance(v, torch.nn.Module)}
    return {"params": ts.params}


def _adam_counts(opt) -> set[int]:
    return {int(s["step"]) for s in opt.state.values()}


def phase_workloads(device: torch.device, names=WORKLOADS,
                    timed_iters: int = WORKLOAD_TIMED_ITERS, episodes: int = 5) -> list[dict]:
    from gymrl_tpu_torch.run import cli
    from gymrl_tpu_torch.run.loop import TrainLoop
    from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cuda = device.type == "cuda"
    results = []
    for name in names:
        trainer, algo, solve = cli.WORKLOADS[name](str(device))
        cfg = trainer.cfg
        ppo = not hasattr(cfg, "steps_per_iter")
        per_iter = cfg.batch_total if ppo else cfg.steps_per_iter * cfg.num_envs
        ts0 = trainer.init(0)
        initial = {k: {n: v.detach().clone() for n, v in m.state_dict().items()}
                   for k, m in _nets(ts0).items()}
        if hasattr(ts0, "targets"):
            initial_targets = {k: {n: v.clone() for n, v in m.state_dict().items()}
                               for k, m in ts0.targets.items()}
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)  # the loop saves to ./checkpoints
            try:
                loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, save_every=10 ** 12)
            finally:
                os.chdir(cwd)
            t0 = time.perf_counter()
            ts, _ = loop.train(per_iter, solve_threshold=solve, ts=ts0)  # warm-up iteration
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            warm_s = time.perf_counter() - t0
            learn0 = ts.learn_steps if hasattr(ts, "learn_steps") else None
            clock = PhaseClock(device)
            walls, phases = [], []
            for _ in range(timed_iters):
                t0 = time.perf_counter()
                clock.start()
                ts, out = trainer.train_iter(ts, timer=clock.mark)
                if cuda:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                phases.append(clock.phase_ms())
            peak = torch.cuda.max_memory_allocated(device) if cuda else None
            t0 = time.perf_counter()
            mean_reward = loop.test(ts, episodes=episodes)
            test_s = time.perf_counter() - t0
            path = save_checkpoint(loop.ckpt_path, ts)
            restored = restore_checkpoint(path, trainer.init(1))

        iters = timed_iters + 1
        if ppo:
            timed_updates = timed_iters * cfg.num_epochs * cfg.num_minibatches
        elif hasattr(ts, "learn_steps"):
            timed_updates = ts.learn_steps - learn0
        else:
            timed_updates = timed_iters * cfg.steps_per_iter * cfg.n_updates
        metrics = {k: float(v) for k, v in out.metrics.items()}
        result = {
            "workload": name, "env_steps": ts.env_steps, "warmup_iter_s": warm_s,
            "env_steps_per_s": timed_iters * per_iter / sum(walls),
            "updates_per_s": timed_updates / sum(walls),
            "iter_wall_ms": [w * 1e3 for w in walls],
            "phase_ms": {p: [ph[p] for ph in phases] for p in phases[0]},
            "peak_memory_bytes": peak, "metrics": metrics,
            "test_episodes": episodes, "test_mean_reward": mean_reward, "test_s": test_s,
        }

        # counts
        if ts.env_steps != iters * per_iter:
            raise AssertionError(f"{name}: env_steps {ts.env_steps} != {iters} x {per_iter}")
        if not all(math.isfinite(v) for v in metrics.values()) or not math.isfinite(mean_reward):
            raise AssertionError(f"{name}: non-finite metrics {metrics} / test {mean_reward}")
        for k, m in _nets(ts).items():
            state = m.state_dict()
            if not all(v.device.type == device.type for v in state.values()):
                raise AssertionError(f"{name}: {k} left the device")
            if not all(not torch.equal(state[n], v) for n, v in initial[k].items()):
                raise AssertionError(f"{name}: some parameter of {k} did not move")
        if ppo:
            want = iters * cfg.num_epochs * cfg.num_minibatches
            if _adam_counts(ts.opt_state) != {want}:
                raise AssertionError(f"{name}: Adam counts {_adam_counts(ts.opt_state)} != {want}")
        else:
            updates = _expected_updates(cfg, iters)
            if ts.replay.size != min(iters * per_iter, cfg.memory_capacity):
                raise AssertionError(f"{name}: replay size {ts.replay.size}")
            result["replay_size"] = ts.replay.size
            if hasattr(ts, "learn_steps"):
                if ts.learn_steps != updates:
                    raise AssertionError(f"{name}: learn_steps {ts.learn_steps} != {updates}")
                result["learn_steps"] = ts.learn_steps
                for k, opt in ts.opts.items():
                    want = (updates + 1) // 2 if (name == "td3_pendulum" and k == "actor") else updates
                    if _adam_counts(opt) != {want}:
                        raise AssertionError(f"{name}: {k} Adam counts {_adam_counts(opt)} != {want}")
                for k, m in ts.targets.items():
                    if all(torch.equal(m.state_dict()[n], v) for n, v in initial_targets[k].items()):
                        raise AssertionError(f"{name}: target {k} did not move")
            else:  # DQN
                if _adam_counts(ts.opt_state) != {updates}:
                    raise AssertionError(f"{name}: Adam counts {_adam_counts(ts.opt_state)} != {updates}")
                episodes_done, syncs = int(ts.episodes), int(ts.target_syncs)
                if syncs != episodes_done // cfg.target_update_freq:
                    raise AssertionError(f"{name}: {syncs} target syncs after {episodes_done} episodes")
                result.update(episodes=episodes_done, target_syncs=syncs, updates=updates)
        got, want = _state_tensors(restored), _state_tensors(ts)
        if set(got) != set(want) or not all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want):
            raise AssertionError(f"{name}: the restored state differs from the trained one")
        if restored.env_steps != ts.env_steps:
            raise AssertionError(f"{name}: restored env_steps differ")
        result["checkpoint_restored"] = True
        log("phase 6 workload: " + json.dumps(result))
        results.append(result)
    return results


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
    phase_classic(device)
    phase_updates(device)
    phase_workloads(device)
    log(json.dumps({"kernels": []}))
    log(f"total_s: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
