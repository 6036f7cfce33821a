"""Batched PyTorch CartPole-v1 (counterpart of ``gymrl_tpu/envs/cartpole.py``).

Gymnasium's ``CartPoleEnv``: Euler integration at dt=0.02, force ±10 N,
termination at |x| > 2.4 or |θ| > 12°, reward 1.0 on every step (the
terminating one included), uniform (−0.05, 0.05) initial state, 500-step
time limit. The arithmetic follows the JAX engine operation for operation.

Random draws are arguments: ``reset_from(params, u)`` takes the ``[B, 4]``
initial-state uniforms. A step draws nothing (``step_draws`` is ``None``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit


class CartPoleParams(NamedTuple):
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half pole length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12.0 * 2.0 * math.pi / 360.0
    x_threshold: float = 2.4


class CartPoleState(NamedTuple):
    x: torch.Tensor  # f32[B]
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # i32[B]


class CartPole(Env):
    name = "CartPole-v1"
    n_actions = 2
    obs_shape = (4,)
    max_steps = 500

    def default_params(self) -> CartPoleParams:
        return CartPoleParams()

    @staticmethod
    def _obs(state: CartPoleState) -> torch.Tensor:
        return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], dim=1)

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int) -> torch.Tensor:
        return noise.uniform((num, 4), -0.05, 0.05)

    def step_draws(self, noise, num: int) -> None:
        return None

    # -- pure functions ------------------------------------------------------
    def reset_from(self, params: CartPoleParams, u: torch.Tensor):
        """``u[B, 4]``: the initial (x, x_dot, theta, theta_dot)."""
        t = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
        state = CartPoleState(*u.unbind(1), t)
        return state, self._obs(state)

    def step_from(self, params: CartPoleParams, state: CartPoleState,
                  action: torch.Tensor, draws=None) -> StepResult:
        p = params
        force = torch.where(action == 1, p.force_mag, -p.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        total_mass = p.masscart + p.masspole
        polemass_length = p.masspole * p.length

        temp = (force + polemass_length * state.theta_dot ** 2 * sintheta) / total_mass
        thetaacc = (p.gravity * sintheta - costheta * temp) / (
            p.length * (4.0 / 3.0 - p.masspole * costheta ** 2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = state.x + p.tau * state.x_dot
        x_dot = state.x_dot + p.tau * xacc
        theta = state.theta + p.tau * state.theta_dot
        theta_dot = state.theta_dot + p.tau * thetaacc
        t = state.t + 1

        new_state = CartPoleState(x, x_dot, theta, theta_dot, t)
        terminated = (torch.abs(x) > p.x_threshold) | (torch.abs(theta) > p.theta_threshold)
        truncated = time_limit(t, self.max_steps, terminated)
        reward = torch.ones_like(x)
        return StepResult(new_state, self._obs(new_state), reward, terminated, truncated)
