"""Batched PyTorch MountainCar-v0 (counterpart of ``gymrl_tpu/envs/mountaincar.py``).

Gymnasium semantics: 3 actions, vel += (a−1)·0.001 − cos(3·pos)·0.0025 in
float32, vel clipped to ±0.07, pos clipped to [−1.2, 0.6], the velocity
zeroed at the left wall, the goal at pos ≥ 0.5 with vel ≥ 0, reward −1
per step, 200-step limit. The order of the clips follows the JAX engine.

Random draws are arguments: ``reset_from(params, u)`` takes the initial
positions ``u[B] ~ U(−0.6, −0.4)``; the velocity starts at 0. A step draws
nothing (``step_draws`` is ``None``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit


class MountainCarParams(NamedTuple):
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.5
    goal_velocity: float = 0.0
    force: float = 0.001
    gravity: float = 0.0025


class MountainCarState(NamedTuple):
    position: torch.Tensor  # f32[B]
    velocity: torch.Tensor  # f32[B]
    t: torch.Tensor  # i32[B]


class MountainCar(Env):
    name = "MountainCar-v0"
    n_actions = 3
    obs_shape = (2,)
    max_steps = 200

    def default_params(self) -> MountainCarParams:
        return MountainCarParams()

    @staticmethod
    def _obs(state: MountainCarState) -> torch.Tensor:
        return torch.stack([state.position, state.velocity], dim=1)

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int) -> torch.Tensor:
        return noise.uniform((num,), -0.6, -0.4)

    def step_draws(self, noise, num: int) -> None:
        return None

    # -- pure functions ------------------------------------------------------
    def reset_from(self, params: MountainCarParams, u: torch.Tensor):
        state = MountainCarState(u, torch.zeros_like(u),
                                 torch.zeros(u.shape[0], dtype=torch.int32, device=u.device))
        return state, self._obs(state)

    def step_from(self, params: MountainCarParams, state: MountainCarState,
                  action: torch.Tensor, draws=None) -> StepResult:
        p = params
        velocity = (state.velocity + (action.float() - 1.0) * p.force
                    + torch.cos(3.0 * state.position) * (-p.gravity))
        velocity = torch.clamp(velocity, -p.max_speed, p.max_speed)
        position = torch.clamp(state.position + velocity, p.min_position, p.max_position)
        velocity = torch.where((position == p.min_position) & (velocity < 0.0), 0.0, velocity)
        t = state.t + 1

        new_state = MountainCarState(position, velocity, t)
        terminated = (position >= p.goal_position) & (velocity >= p.goal_velocity)
        truncated = time_limit(t, self.max_steps, terminated)
        reward = torch.full_like(position, -1.0)
        return StepResult(new_state, self._obs(new_state), reward, terminated, truncated)
