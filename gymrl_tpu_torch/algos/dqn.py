"""DQN on vectorized CartPole (counterpart of ``gymrl_tpu/algos/dqn.py``).

Algorithm parity with reference algorithms/dqn_cartpole.py, unchanged from
the JAX trainer:
  * 3-layer MLP(256), orthogonal init gain √2, head gain 0.01
  * ε-greedy with exponential decay ε_end + (ε_start−ε_end)·e^(−t/800), t in
    single-env steps
  * uniform replay 100k, batch 64, MSE TD loss on a target net, bootstrap
    cut by (1 − done) where done = terminated | truncated
  * per-parameter gradient clamp ±1, Adam(lr, eps=1e-8)
  * hard target sync every 4 completed *episodes*

One ``train_iter`` is ``steps_per_iter`` env steps, each: batched ε-greedy
act → ``VecEnv.step`` → ring push → (once the replay holds a batch)
``n_updates`` minibatch updates → target sync. The episode count and the
sync count stay on the device and the sync is a ``torch.where`` per tensor,
so the loop never waits for the device; only ``size >= batch_size`` (a
Python int) branches on the host. Every draw comes from ``ts.noise`` in the
reference's order.

Under a ``mesh`` each data rank acts for its share of the envs; each env
step's transitions are gathered, so every rank pushes the whole batch and
holds the same replay. Sampled indices are shared draws, so every rank
samples the same minibatch and takes its share of it; gradients and the
loss are averaged over ``data`` before the clamp and the step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from gymrl_tpu_torch.algos.base import (
    IterOut, PhaseTimer, Trainer, adam, clip_grads_by_value_, frozen_copy, mesh_mean, set_grads,
)
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.core.schedules import exp_epsilon_decay
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.layers import Dense
from gymrl_tpu_torch.replay.uniform import (
    ReplayState, replay_init, replay_push_batch, replay_sample,
)


@dataclass(frozen=True)
class DQNConfig:
    env_name: str = "CartPole-v1"
    num_envs: int = 16
    steps_per_iter: int = 32  # vector env steps per train_iter
    batch_size: int = 64
    gamma: float = 0.99
    lr: float = 1e-3
    epsilon_start: float = 0.95
    epsilon_end: float = 0.01
    epsilon_decay: float = 800.0  # in units of single-env steps (ref cadence)
    target_update_freq: int = 4  # episodes between hard target syncs
    memory_capacity: int = 100_000
    hidden_dim: int = 256
    # updates per vector step; None ⇒ num_envs (preserves ref 1-update/env-step)
    updates_per_step: int | None = None
    max_train_steps: int = 2_000_000  # total env steps budget
    solve_threshold: float = 495.0

    @property
    def n_updates(self) -> int:
        return self.num_envs if self.updates_per_step is None else self.updates_per_step


class QNetwork(nn.Module):
    """fc1 → relu → fc2 → relu → head (flax names, so weights map by name)."""

    def __init__(self, obs_dim: int, n_actions: int, hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        ortho = gl_init.orthogonal()
        self.fc1 = Dense(obs_dim, hidden_dim, ortho, generator=generator)
        self.fc2 = Dense(hidden_dim, hidden_dim, ortho, generator=generator)
        self.head = Dense(hidden_dim, n_actions, gl_init.orthogonal(0.01), generator=generator)

    def forward(self, x):
        return self.head(torch.relu(self.fc2(torch.relu(self.fc1(x)))))


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor  # i32
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor  # f32 — the reference cuts bootstrap on done (incl. trunc)


class DQNTrainState(NamedTuple):
    params: QNetwork
    target_params: QNetwork  # no grads; synced in place
    opt_state: torch.optim.Adam
    replay: ReplayState
    vec_state: VecState
    noise: Noise  # the reference's `key`
    env_steps: int  # total single-env steps
    episodes: torch.Tensor  # i32[] on the device — completed episodes
    target_syncs: torch.Tensor  # i32[] on the device — hard syncs performed


class DQNTrainer(Trainer):
    def __init__(self, cfg: DQNConfig, device: str | torch.device = "cuda", mesh=None):
        super().__init__(cfg, device, mesh)
        self._check_split(cfg.batch_size, "batch_size")
        self.venv = make_vec(cfg.env_name, self.local_envs)
        self.obs_dim = self.venv.env.obs_dim
        self.n_actions = self.venv.env.n_actions

    # -- API ------------------------------------------------------------------
    def init(self, seed: int = 0) -> DQNTrainState:
        """Fresh state. Params come from a CPU generator seeded ``seed`` (the
        same weights on every device); env and training noise from a
        generator on the trainer's device."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(seed)
        net = QNetwork(self.obs_dim, self.n_actions, cfg.hidden_dim, generator=gen).to(self.device)
        noise = self._noise(seed)
        example = Transition(
            obs=torch.zeros(self.obs_dim),
            action=torch.zeros((), dtype=torch.int32),
            reward=torch.zeros(()),
            next_obs=torch.zeros(self.obs_dim),
            done=torch.zeros(()),
        )
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return DQNTrainState(
            params=net,
            target_params=frozen_copy(net),
            opt_state=adam(list(net.parameters()), cfg.lr, 1e-8, foreach=True),
            replay=replay_init(example, cfg.memory_capacity, self.device),
            vec_state=self.venv.reset(noise),
            noise=noise,
            env_steps=0,
            episodes=zero,
            target_syncs=zero.clone(),
        )

    @torch.no_grad()
    def policy(self, ts: DQNTrainState, obs, noise, deterministic: bool = True):
        return torch.argmax(ts.params(obs), dim=-1).to(torch.int32)

    def train_iter(self, ts: DQNTrainState,
                   timer: PhaseTimer | None = None) -> tuple[DQNTrainState, IterOut]:
        """One iteration; updates the nets and optimizer held by ``ts`` in place.

        ``timer``, if given, is called with "act" (ε-greedy act, env step and
        push) and "update" (the updates and the target sync) as each phase of
        each env step ends.
        """
        cfg = self.cfg
        mark = timer or (lambda phase: None)
        net, target, opt, noise = ts.params, ts.target_params, ts.opt_state, ts.noise
        online_params, target_params = list(net.parameters()), list(target.parameters())
        replay, vec_state = ts.replay, ts.vec_state
        env_steps, episodes, target_syncs = ts.env_steps, ts.episodes, ts.target_syncs
        zero = torch.zeros((), device=self.device)
        stats, losses, eps = [], [], None
        for _ in range(cfg.steps_per_iter):
            # ε-greedy batched action selection (ref dqn_cartpole.py:124-133)
            eps = exp_epsilon_decay(env_steps, cfg.epsilon_start, cfg.epsilon_end,
                                    cfg.epsilon_decay)
            with torch.no_grad():
                greedy = torch.argmax(net(vec_state.obs), dim=-1).to(torch.int32)
            u, randoms = noise.explore(self.local_envs, self.n_actions)
            action = torch.where(u < float(eps), randoms, greedy)

            vec_state, tr = self.venv.step(vec_state, action, noise)
            # every rank's envs, in rank order: every rank pushes the whole batch
            tr = self._gather(tr)
            replay = replay_push_batch(replay, Transition(
                obs=tr.obs, action=tr.action, reward=tr.reward,
                next_obs=tr.next_obs, done=tr.done.float(),
            ))
            mark("act")

            # k gradient updates per vector step (update:data ratio parity)
            if replay.size >= cfg.batch_size:
                loss = torch.stack([
                    self._update(net, target, opt, online_params, replay, noise)
                    for _ in range(cfg.n_updates)
                ]).mean()
            else:
                loss = zero

            # hard target sync every target_update_freq completed episodes
            episodes = episodes + tr.done.sum(dtype=torch.int32)
            due = episodes // cfg.target_update_freq
            sync = due > target_syncs
            with torch.no_grad():
                for t, o in zip(target_params, online_params):
                    torch.where(sync, o, t, out=t)
            target_syncs = torch.where(sync, due, target_syncs)
            mark("update")

            env_steps += cfg.num_envs
            losses.append(loss)
            stats.append((tr.final_return, tr.final_length, tr.done))

        stats = [torch.stack(f) for f in zip(*stats)]
        new_ts = ts._replace(replay=replay, vec_state=vec_state, env_steps=env_steps,
                             episodes=episodes, target_syncs=target_syncs)
        return new_ts, self._iter_out(stats, {"loss": torch.stack(losses).mean(),
                                              "epsilon": eps.to(self.device)})

    # -- internals ------------------------------------------------------------
    def _loss(self, net, target, batch: Transition) -> torch.Tensor:
        q = net(batch.obs)
        q_sa = q.gather(-1, batch.action.long()[:, None]).squeeze(-1)
        with torch.no_grad():
            next_q = target(batch.next_obs).max(dim=-1).values
            y = batch.reward + self.cfg.gamma * next_q * (1.0 - batch.done)
        return torch.square(q_sa - y).mean()

    def _update(self, net, target, opt, params, replay: ReplayState, noise) -> torch.Tensor:
        """One sampled minibatch step; returns the loss before the step."""
        batch = self._share(replay_sample(replay, noise, self.cfg.batch_size))
        loss = self._loss(net, target, batch)
        set_grads(params, loss, self.mesh)
        clip_grads_by_value_([p.grad for p in params], 1.0)
        opt.step()
        return mesh_mean([loss], self.mesh)[0]
