"""Batched PyTorch Pendulum-v1 (counterpart of ``gymrl_tpu/envs/pendulum.py``).

Gymnasium semantics: torque clipped to ±2, reward −(Δθ² + 0.1·θ̇² + 0.001·u²),
dt=0.05, g=10, m=1, l=1, θ̇ clipped ±8, initial θ ∈ U(−π, π) and
θ̇ ∈ U(−1, 1), obs = [cosθ, sinθ, θ̇], 200-step limit, never terminates.

Random draws are arguments: ``reset_from(params, draws)`` takes θ and θ̇
(``PendulumResetDraws``). A step draws nothing (``step_draws`` is ``None``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit


class PendulumParams(NamedTuple):
    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0


class PendulumState(NamedTuple):
    theta: torch.Tensor  # f32[B]
    theta_dot: torch.Tensor
    t: torch.Tensor  # i32[B]


class PendulumResetDraws(NamedTuple):
    theta: torch.Tensor  # f32[B], U(-π, π)
    theta_dot: torch.Tensor  # f32[B], U(-1, 1)


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    # Floor modulo (the sign of the divisor), as jnp's ``%``; fmod would differ
    # for angles below -π.
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


class Pendulum(Env):
    name = "Pendulum-v1"
    act_dim = 1
    action_bound = 2.0
    obs_shape = (3,)
    max_steps = 200

    def default_params(self) -> PendulumParams:
        return PendulumParams()

    @staticmethod
    def _obs(state: PendulumState) -> torch.Tensor:
        return torch.stack(
            [torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], dim=1
        )

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int) -> PendulumResetDraws:
        return PendulumResetDraws(
            theta=noise.uniform((num,), -math.pi, math.pi),
            theta_dot=noise.uniform((num,), -1.0, 1.0),
        )

    def step_draws(self, noise, num: int) -> None:
        return None

    # -- pure functions ------------------------------------------------------
    def reset_from(self, params: PendulumParams, draws: PendulumResetDraws):
        t = torch.zeros(draws.theta.shape[0], dtype=torch.int32, device=draws.theta.device)
        state = PendulumState(draws.theta, draws.theta_dot, t)
        return state, self._obs(state)

    def step_from(self, params: PendulumParams, state: PendulumState,
                  action: torch.Tensor, draws=None) -> StepResult:
        p = params
        u = torch.clamp(action.reshape(-1).float(), -p.max_torque, p.max_torque)
        th, thdot = state.theta, state.theta_dot

        cost = _angle_normalize(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2

        newthdot = thdot + (
            3.0 * p.g / (2.0 * p.l) * torch.sin(th)
            + 3.0 / (p.m * p.l ** 2) * u
        ) * p.dt
        newthdot = torch.clamp(newthdot, -p.max_speed, p.max_speed)
        newth = th + newthdot * p.dt
        t = state.t + 1

        new_state = PendulumState(newth, newthdot, t)
        terminated = torch.zeros_like(t, dtype=torch.bool)
        truncated = time_limit(t, self.max_steps, terminated)
        return StepResult(new_state, self._obs(new_state), -cost, terminated, truncated)
