"""Batched PyTorch CliffWalking-v0 (counterpart of ``gymrl_tpu/envs/cliffwalking.py``).

Gymnasium semantics: a 4x12 grid, start (3, 0) = cell 36, goal (3, 11) =
cell 47; actions 0=UP, 1=RIGHT, 2=DOWN, 3=LEFT (not FrozenLake's order);
stepping into a cliff cell (row 3, cols 1..10) gives -100 and sends the
agent back to the start without ending the episode; every other step
costs -1; only the goal terminates. Gymnasium has no time limit; the JAX
engine caps episodes at 1000 steps, and so does this one.

Nothing here is random: a step draws nothing (``step_draws`` is ``None``),
and ``reset_draws`` gives a zero per env, which carries the batch size and
the device to ``reset_from``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit


class CliffWalkingParams(NamedTuple):
    start: int = 36
    goal: int = 47


class CliffWalkingState(NamedTuple):
    pos: torch.Tensor  # i32[B] cell index
    t: torch.Tensor  # i32[B]


class CliffWalking(Env):
    name = "CliffWalking-v0"
    n_actions = 4
    obs_shape = ()
    max_steps = 1000
    nrow = 4
    ncol = 12
    n_states = 48

    def default_params(self) -> CliffWalkingParams:
        return CliffWalkingParams()

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int) -> torch.Tensor:
        return torch.zeros(num, dtype=torch.int32, device=noise.device)

    def step_draws(self, noise, num: int) -> None:
        return None

    # -- pure functions ------------------------------------------------------
    def reset_from(self, params: CliffWalkingParams, zeros: torch.Tensor):
        state = CliffWalkingState(zeros + params.start, torch.zeros_like(zeros))
        return state, state.pos

    def step_from(self, params: CliffWalkingParams, state: CliffWalkingState,
                  action: torch.Tensor, draws=None) -> StepResult:
        action = action.to(torch.int32)
        row, col = state.pos // self.ncol, state.pos % self.ncol
        row = torch.where(action == 0, torch.clamp(row - 1, min=0), row)
        col = torch.where(action == 1, torch.clamp(col + 1, max=self.ncol - 1), col)
        row = torch.where(action == 2, torch.clamp(row + 1, max=self.nrow - 1), row)
        col = torch.where(action == 3, torch.clamp(col - 1, min=0), col)
        pos = row * self.ncol + col

        is_cliff = (row == 3) & (col >= 1) & (col <= 10)
        reward = torch.where(is_cliff, -100.0, -1.0)
        pos = torch.where(is_cliff, params.start, pos)

        t = state.t + 1
        terminated = pos == params.goal
        truncated = time_limit(t, self.max_steps, terminated)
        new_state = CliffWalkingState(pos, t)
        return StepResult(new_state, pos, reward, terminated, truncated)
