"""Tabular Q-learning and the rule-based MountainCar baseline (counterpart
of ``gymrl_tpu/algos/tabular.py``).

  * FrozenLake Q-learning (reference algorithms/qlearning_frozenlake.py): a
    [16, 4] Q-table, lr 0.1, γ 0.9, ε decaying exponentially per action
    selection (0.95 → 0.01, decay 200), TD(0) cut on done, and the
    reference's reward shaping on the next cell (hole −10, goal +100, no
    move −5, step −1).
  * CliffWalking Q-learning (qlearning_cliffwalking.py): the same update,
    decay 300, no shaping.
  * MountainCar rule policy (mountaincar_baseline.py): push right inside
    the phase-space band lb < v < ub, else push left.

One vector step of ``B`` envs: ε from ``sample_count`` (one value for the
step; the count grows by ``B``) → ε-greedy on the table, the greedy action
the first maximal index → ``VecEnv.step`` → ``B`` TD updates applied as a
segment mean: duplicate (s, a) pairs of the step average their TDs
(two accumulating scatters, into the TD sums and the counts), so the
effective lr per pair stays ``lr``. Draws per step, in the reference's
order: the ε-greedy pair (``Noise.explore``), then the env step's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from gymrl_tpu_torch.algos.base import IterOut, PhaseTimer, Trainer
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.core.schedules import exp_epsilon_decay
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState, VecTransition


@dataclass(frozen=True)
class QLearningConfig:
    env_name: str = "FrozenLake-v1"
    num_envs: int = 16
    steps_per_iter: int = 64
    lr: float = 0.1
    gamma: float = 0.9
    epsilon_start: float = 0.95
    epsilon_end: float = 0.01
    epsilon_decay: float = 200.0
    use_reward_shaping: bool = True  # FrozenLake only
    max_train_steps: int = 200_000
    solve_threshold: float | None = None


# FrozenLake 4x4 shaping constants (qlearning_frozenlake.py:63-79)
_FL_HOLES = (5, 7, 11, 12)
_FL_GOAL = 15


def _shape_frozenlake(state: torch.Tensor, next_state: torch.Tensor,
                      reward: torch.Tensor) -> torch.Tensor:
    is_hole = torch.isin(next_state, torch.tensor(_FL_HOLES, device=next_state.device))
    is_goal = next_state == _FL_GOAL
    no_move = state == next_state
    return torch.where(is_hole, -10.0,
                       torch.where(is_goal, 100.0, torch.where(no_move, -5.0, -1.0)))


class QLearningTrainState(NamedTuple):
    q_table: torch.Tensor  # f32[n_states, n_actions]
    vec_state: VecState
    noise: Noise  # the reference's `key`
    env_steps: int
    sample_count: int  # drives the ε decay (per action selection)


class QLearningTrainer(Trainer):
    def __init__(self, cfg: QLearningConfig, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        self.venv = make_vec(cfg.env_name, cfg.num_envs)
        self.n_states = self.venv.env.n_states
        self.n_actions = self.venv.env.n_actions
        self.shaped = cfg.use_reward_shaping and cfg.env_name.startswith("FrozenLake")

    def init(self, seed: int = 0) -> QLearningTrainState:
        noise = Noise(self.device, seed)
        return QLearningTrainState(
            q_table=torch.zeros(self.n_states, self.n_actions, device=self.device),
            vec_state=self.venv.reset(noise),
            noise=noise,
            env_steps=0,
            sample_count=0,
        )

    @torch.no_grad()
    def policy(self, ts: QLearningTrainState, obs, noise, deterministic: bool = True):
        return torch.argmax(ts.q_table[obs], dim=-1).to(torch.int32)

    @torch.no_grad()
    def vector_step(self, q_table: torch.Tensor, vec_state: VecState, noise,
                    sample_count: int, mark: PhaseTimer = lambda phase: None
                    ) -> tuple[torch.Tensor, VecState, VecTransition, torch.Tensor]:
        """One act → step → update of every env; returns (the new table,
        the new env batch, the transition, ε). ``mark`` is called with
        "act", "env" and "update" as each part ends."""
        cfg = self.cfg
        obs = vec_state.obs  # i32[B] cell indices
        eps = float(exp_epsilon_decay(sample_count, cfg.epsilon_start, cfg.epsilon_end,
                                      cfg.epsilon_decay))
        greedy = torch.argmax(q_table[obs], dim=-1).to(torch.int32)
        u, randoms = noise.explore(cfg.num_envs, self.n_actions)
        action = torch.where(u < eps, randoms, greedy)
        mark("act")

        vec_state, tr = self.venv.step(vec_state, action, noise)
        mark("env")

        next_obs = tr.next_obs  # the true successor (the terminal cell at done)
        reward = _shape_frozenlake(obs, next_obs, tr.reward) if self.shaped else tr.reward
        # TD(0): target = r (+ γ max Q(s') unless done) — ref :84-92
        max_next = q_table[next_obs].max(dim=-1).values
        target = reward + cfg.gamma * max_next * (1.0 - tr.done.float())
        index = (obs.long(), action.long())
        td = target - q_table[index]
        num = torch.zeros_like(q_table).index_put_(index, td, accumulate=True)
        cnt = torch.zeros_like(q_table).index_put_(index, torch.ones_like(td), accumulate=True)
        q_table = q_table + cfg.lr * num / torch.clamp(cnt, min=1.0)
        mark("update")
        return q_table, vec_state, tr, action, eps

    def train_iter(self, ts: QLearningTrainState,
                   timer: PhaseTimer | None = None) -> tuple[QLearningTrainState, IterOut]:
        """``steps_per_iter`` vector steps. ``timer``, if given, is called with
        "act", "env" and "update" as each part of each step ends."""
        cfg = self.cfg
        mark = timer or (lambda phase: None)
        q_table, vec_state, sample_count = ts.q_table, ts.vec_state, ts.sample_count
        stats = []
        for _ in range(cfg.steps_per_iter):
            q_table, vec_state, tr, _, eps = self.vector_step(q_table, vec_state, ts.noise,
                                                              sample_count, mark)
            sample_count += cfg.num_envs
            stats.append((tr.final_return, tr.final_length, tr.done))
        stats = [torch.stack(f) for f in zip(*stats)]
        new_ts = ts._replace(q_table=q_table, vec_state=vec_state, sample_count=sample_count,
                             env_steps=ts.env_steps + cfg.steps_per_iter * cfg.num_envs)
        metrics = {"epsilon": torch.tensor(eps, device=self.device), "q_max": q_table.max()}
        return new_ts, self._iter_out(stats, metrics)

    def success_rate(self, ts: QLearningTrainState, noise, episodes: int = 20) -> float:
        """FrozenLake eval metric (qlearning_frozenlake.py:131-152)."""
        returns, _ = self.eval_episodes(ts, noise, episodes)
        return float((returns > 0).float().mean())


def qlearning_frozenlake_config(**kw) -> QLearningConfig:
    base = dict(env_name="FrozenLake-v1", epsilon_decay=200.0, use_reward_shaping=True)
    base.update(kw)
    return QLearningConfig(**base)


def qlearning_cliffwalking_config(**kw) -> QLearningConfig:
    base = dict(env_name="CliffWalking-v0", epsilon_decay=300.0, use_reward_shaping=False)
    base.update(kw)
    return QLearningConfig(**base)


class BaselineState(NamedTuple):
    env_steps: int


def _square(x: torch.Tensor) -> torch.Tensor:
    return x * x  # jnp's x ** 2 (lax.integer_pow multiplies)


class MountainCarBaseline(Trainer):
    """Hand-crafted phase-space policy (mountaincar_baseline.py:26-45)."""

    def __init__(self, cfg=None, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        self.venv = make_vec("MountainCar-v0", 1)

    def init(self, seed: int = 0) -> BaselineState:
        return BaselineState(env_steps=0)

    @torch.no_grad()
    def policy(self, ts, obs, noise, deterministic: bool = True):
        position, velocity = obs[..., 0], obs[..., 1]
        lb = torch.minimum(-0.09 * _square(position + 0.25) + 0.03,
                           0.3 * _square(_square(position + 0.9)) - 0.008)
        ub = -0.07 * _square(position + 0.38) + 0.07
        return torch.where((lb < velocity) & (velocity < ub), 2, 0).to(torch.int32)
