"""Vectorized auto-resetting rollout (counterpart of ``gymrl_tpu/envs/rollout.py``).

Semantics (gymnasium vector autoreset, "same-step" style), unchanged:
  * the returned transition carries the TRUE next observation of the step
    (``next_obs`` — the terminal obs when done), for correct TD targets;
  * the carried observation (``obs``) is the post-reset obs when done, so
    the next step starts the new episode.

The order of work is the reference's: step all envs, reset all envs, select
by ``done``. Every step therefore draws a full batch of reset noise, which
is what lets the tests replay the reference's key splits draw for draw.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env
from gymrl_tpu_torch.utils.profiling import span


class VecState(NamedTuple):
    """Carry for a vectorized auto-resetting environment."""

    env_state: Any  # batched state NamedTuple, every leaf [B, ...]
    obs: torch.Tensor  # f32[B, obs...] — current (post-reset) observation
    ep_return: torch.Tensor  # f32[B] — running raw return of the current episode
    ep_length: torch.Tensor  # i32[B]


class VecTransition(NamedTuple):
    obs: torch.Tensor  # s_t
    action: torch.Tensor
    reward: torch.Tensor  # raw env reward
    next_obs: torch.Tensor  # true s_{t+1} (terminal obs if done)
    terminated: torch.Tensor  # bool — "dw"
    truncated: torch.Tensor
    done: torch.Tensor  # terminated | truncated
    # Finished-episode stats, valid where done (else 0).
    final_return: torch.Tensor
    final_length: torch.Tensor


def tree_select(pred: torch.Tensor, on_true, on_false):
    """Batched element-wise select, ``jax.tree_util.tree_map``'s way: over a
    tensor of any rank ``[B, ...]``, or leaf by leaf over matching (nested)
    NamedTuples; ``pred`` is ``[B]``."""
    if isinstance(on_true, torch.Tensor):
        p = pred.reshape(pred.shape + (1,) * (on_true.dim() - pred.dim()))
        return torch.where(p, on_true, on_false)
    return type(on_true)(*(tree_select(pred, a, b) for a, b in zip(on_true, on_false)))


class VecEnv:
    """Env + params + batch size bundled for rollouts."""

    def __init__(self, env: Env, params, num_envs: int):
        self.env = env
        self.params = params
        self.num_envs = num_envs

    def reset(self, noise) -> VecState:
        env_state, obs = self.env.reset_batch(self.params, noise, self.num_envs)
        return VecState(
            env_state=env_state,
            obs=obs,
            ep_return=torch.zeros(self.num_envs, device=obs.device),
            ep_length=torch.zeros(self.num_envs, dtype=torch.int32, device=obs.device),
        )

    def step(self, vstate: VecState, action: torch.Tensor, noise) -> tuple[VecState, VecTransition]:
        with span("env.step"):
            sr = self.env.step_batch(self.params, vstate.env_state, action, noise)
            done = sr.terminated | sr.truncated

            ep_return = vstate.ep_return + sr.reward
            ep_length = vstate.ep_length + 1

            reset_state, reset_obs = self.env.reset_batch(self.params, noise, self.num_envs)
            new_env_state = tree_select(done, reset_state, sr.state)
            new_obs = tree_select(done, reset_obs, sr.obs)

            transition = VecTransition(
                obs=vstate.obs,
                action=action,
                reward=sr.reward,
                next_obs=sr.obs,
                terminated=sr.terminated,
                truncated=sr.truncated,
                done=done,
                final_return=torch.where(done, ep_return, 0.0),
                final_length=torch.where(done, ep_length, 0),
            )
            new_vstate = VecState(
                env_state=new_env_state,
                obs=new_obs,
                ep_return=torch.where(done, 0.0, ep_return),
                ep_length=torch.where(done, 0, ep_length),
            )
            return new_vstate, transition
