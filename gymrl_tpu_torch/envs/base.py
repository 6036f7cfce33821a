"""Batched environment API (counterpart of ``gymrl_tpu/envs/base.py``).

The JAX engines are pure per-env functions ``vmap``-ed over a batch. Here an
environment acts on a whole batch at once: every state tensor carries an
explicit leading batch axis ``[B, ...]``.

Random draws are separate from the dynamics. Each env exposes pure
functions that take their uniforms as tensors,

    state, obs = env.reset_from(params, draws)        # draws = env.reset_draws(noise, B)
    result = env.step_from(params, state, action, draws)  # draws = env.step_draws(noise, B)

and thin wrappers ``reset_batch`` / ``step_batch`` that fetch the draws
from a ``Noise`` (``core/noise.py``) and call them. Tests feed the pure
functions the very numbers the JAX reference drew.

Conventions carried over unchanged:
  * ``terminated`` — true MDP termination ("dw"); cuts value bootstrap.
  * ``truncated``  — time-limit cut from ``max_steps`` (gymnasium's
    TimeLimit folded into the engine); cuts the GAE trace only.
  * ``step`` applies the action to the current state; autoreset lives in
    ``envs/rollout.py``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class StepResult(NamedTuple):
    state: Any
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor


class Env:
    """Base class: static metadata + batched pure reset/step."""

    name: str = "Env"
    # Discrete action spaces set n_actions; continuous set act_dim + action_bound.
    n_actions: int | None = None
    act_dim: int | None = None
    action_bound: float | None = None
    obs_shape: tuple[int, ...] = ()
    max_steps: int = 1000

    @property
    def obs_dim(self) -> int:
        d = 1
        for s in self.obs_shape:
            d *= s
        return d

    @property
    def discrete(self) -> bool:
        return self.n_actions is not None

    def default_params(self):
        raise NotImplementedError

    # -- draws and pure functions (subclasses) ------------------------------
    def reset_draws(self, noise, num: int):
        raise NotImplementedError

    def reset_from(self, params, draws):
        raise NotImplementedError

    def step_draws(self, noise, num: int):
        raise NotImplementedError

    def step_from(self, params, state, action, draws) -> StepResult:
        raise NotImplementedError

    # -- batched wrappers ---------------------------------------------------
    def reset_batch(self, params, noise, num_envs: int):
        return self.reset_from(params, noise.env_reset(self, num_envs))

    def step_batch(self, params, states, actions, noise) -> StepResult:
        num = actions.shape[0]
        return self.step_from(params, states, actions, noise.env_step(self, num))


def time_limit(t: torch.Tensor, max_steps: int, terminated: torch.Tensor) -> torch.Tensor:
    """Gymnasium TimeLimit: truncated at t >= max_steps unless terminated."""
    return (t >= max_steps) & ~terminated
