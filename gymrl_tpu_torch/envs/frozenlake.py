"""Batched PyTorch FrozenLake-v1 (counterpart of ``gymrl_tpu/envs/frozenlake.py``).

Gymnasium semantics, 4x4 map: 16 cells, actions 0=LEFT, 1=DOWN, 2=RIGHT,
3=UP; with ``is_slippery`` the executed action is ``(a + slip) % 4`` for a
slip in {-1, 0, 1}; reward 1.0 only on reaching the goal; holes and the
goal terminate; 100-step limit. The observation is the cell index (i32).
The Q-learning trainer's reward shaping lives in ``algos/tabular.py``.

Random draws are arguments. A step takes the slip ``[B]`` (int32 in
[-1, 2)), drawn for every env on every step, slippery or not, as the JAX
engine draws it. A reset draws nothing: ``reset_draws`` gives a zero per
env, which carries the batch size and the device to ``reset_from``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit

MAP_4X4 = ["SFFF", "FHFH", "FFFH", "HFFG"]


class FrozenLakeParams(NamedTuple):
    holes: tuple[bool, ...]  # per cell, row-major
    goal: int
    is_slippery: bool


class FrozenLakeState(NamedTuple):
    pos: torch.Tensor  # i32[B] cell index
    t: torch.Tensor  # i32[B]


@functools.lru_cache(maxsize=8)
def _device_table(values: tuple, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once: a step's lookup then
    copies nothing from the host."""
    return torch.tensor(values, device=device)


class FrozenLake(Env):
    name = "FrozenLake-v1"
    n_actions = 4
    obs_shape = ()
    max_steps = 100
    nrow = 4
    ncol = 4
    n_states = 16

    def __init__(self, is_slippery: bool = True):
        self.is_slippery = is_slippery

    def default_params(self) -> FrozenLakeParams:
        cells = "".join(MAP_4X4)
        return FrozenLakeParams(holes=tuple(c == "H" for c in cells), goal=cells.index("G"),
                                is_slippery=self.is_slippery)

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int) -> torch.Tensor:
        return torch.zeros(num, dtype=torch.int32, device=noise.device)

    def step_draws(self, noise, num: int) -> torch.Tensor:
        return noise.randint(-1, 2, (num,))

    # -- pure functions ------------------------------------------------------
    def reset_from(self, params: FrozenLakeParams, zeros: torch.Tensor):
        state = FrozenLakeState(zeros.clone(), torch.zeros_like(zeros))
        return state, state.pos

    def _move(self, pos: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        row, col = pos // self.ncol, pos % self.ncol
        col = torch.where(action == 0, torch.clamp(col - 1, min=0), col)
        row = torch.where(action == 1, torch.clamp(row + 1, max=self.nrow - 1), row)
        col = torch.where(action == 2, torch.clamp(col + 1, max=self.ncol - 1), col)
        row = torch.where(action == 3, torch.clamp(row - 1, min=0), row)
        return row * self.ncol + col

    def step_from(self, params: FrozenLakeParams, state: FrozenLakeState,
                  action: torch.Tensor, slip: torch.Tensor) -> StepResult:
        action = action.to(torch.int32)
        # torch's % on integers floors, as jnp's does: (0 - 1) % 4 == 3
        eff_action = (action + slip) % 4 if params.is_slippery else action
        pos = self._move(state.pos, eff_action)
        t = state.t + 1

        is_goal = pos == params.goal
        is_hole = _device_table(params.holes, pos.device)[pos]
        terminated = is_goal | is_hole
        truncated = time_limit(t, self.max_steps, terminated)
        reward = torch.where(is_goal, 1.0, 0.0)
        new_state = FrozenLakeState(pos, t)
        return StepResult(new_state, pos, reward, terminated, truncated)
