"""Hyperparameter schedules (counterpart of ``gymrl_tpu/core/schedules.py``).

  * ε-greedy exponential decay ``ε_end + (ε_start - ε_end)·exp(-t/decay)``
    (reference algorithms/dqn_cartpole.py:117-122).
  * linear anneal of lr / entropy coef with training progress.
  * the Rainbow lr decay ``0.9·lr·(1 - t/T) + 0.1·lr``.
  * PER β anneal 0.4 → 1.0.

Each takes a step count (a Python number or a tensor) and returns a 0-dim
float32 tensor on the step's device (the CPU for a Python number), computed
in float32 as the reference computes it: an ε compared with a float32
uniform must be the reference's float32 ε.
"""

from __future__ import annotations

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _progress(step, total_steps) -> torch.Tensor:
    return torch.clamp(_f32(step) / total_steps, 0.0, 1.0)


def exp_epsilon_decay(step, eps_start: float, eps_end: float, decay: float) -> torch.Tensor:
    return eps_end + (eps_start - eps_end) * torch.exp(-_f32(step) / decay)


def linear_anneal(step, total_steps, init_value: float, final_frac: float = 0.0) -> torch.Tensor:
    """init·(1 - progress·(1 - final_frac)); progress clipped to [0, 1]."""
    return init_value * (1.0 - _progress(step, total_steps) * (1.0 - final_frac))


def ref_lr_decay(step, total_steps, init_lr: float) -> torch.Tensor:
    """0.9·lr·(1 - t/T) + 0.1·lr — reference rainbow_dqn_cartpole.py:354-359."""
    return 0.9 * init_lr * (1.0 - _progress(step, total_steps)) + 0.1 * init_lr


def per_beta_anneal(step, total_steps, beta_start: float = 0.4) -> torch.Tensor:
    """β: beta_start → 1.0 linearly with progress (rainbow_dqn_cartpole.py:229-231)."""
    return beta_start + (1.0 - beta_start) * _progress(step, total_steps)
