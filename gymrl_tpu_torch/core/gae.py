"""Generalized Advantage Estimation (counterpart of ``gymrl_tpu/core/gae.py``).

The reference's reverse ``lax.scan`` becomes a reverse Python loop over T;
each iteration is one elementwise update over the trailing batch dims.

Semantics (reference utils/buffer.py:20-35):
  delta = r + γ·V(s')·(1-dw) − V(s)
  A_t   = delta + γλ·(1-done)·A_{t+1}
"""

from __future__ import annotations

import torch


def compute_gae(
    rewards: torch.Tensor,  # f32[T, ...]
    values: torch.Tensor,  # f32[T, ...]
    next_values: torch.Tensor,  # f32[T, ...] — V(s') aligned per step
    terminated: torch.Tensor,  # bool/f32[T, ...] — "dw": true termination only
    done: torch.Tensor,  # bool/f32[T, ...] — terminated | truncated
    gamma: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(advantages, v_target)`` with ``v_target = adv + values``."""
    terminated = terminated.float()
    done = done.float()
    deltas = rewards + gamma * next_values * (1.0 - terminated) - values
    decay = gamma * lam * (1.0 - done)
    advantages = torch.empty_like(deltas)
    adv = torch.zeros_like(deltas[0])
    for t in reversed(range(deltas.shape[0])):
        adv = deltas[t] + decay[t] * adv
        advantages[t] = adv
    return advantages, advantages + values


def compute_gae_dual_lambda(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    lam_actor: float,
    lam_critic: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decoupled-λ GAE: ``(actor_advantages, critic_returns)``, actor
    advantages from λ_actor, critic returns ``adv(λ_critic) + values``."""
    adv_a, _ = compute_gae(rewards, values, next_values, terminated, done, gamma, lam_actor)
    _, returns = compute_gae(rewards, values, next_values, terminated, done, gamma, lam_critic)
    return adv_a, returns


def standardize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rollout-wide advantage standardization. ``correction=0``: the
    reference's ``jnp.std`` is the population std (ddof 0)."""
    return (x - x.mean()) / (x.std(correction=0) + eps)
