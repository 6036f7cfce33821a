"""Running normalization statistics (counterpart of ``gymrl_tpu/core/normalization.py``).

  * ``RunningMeanStd`` — Welford running mean/std, with the reference's
    ``n == 1`` quirk (the first single sample sets ``std = x``) on the
    one-sample path and Chan's parallel merge on the batch path.
  * ``normalize_obs`` — ``(x - mean) / (std + 1e-8)``; eval freezes the
    statistics by not updating them.
  * ``RewardScaler`` — divide-only scaling by the running std of the
    discounted return ``R = γR + r``, one accumulator per env instance.

State is explicit (NamedTuples of tensors) and every function returns new
state, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningMeanStd(NamedTuple):
    """Running first/second moments. ``shape``-shaped mean/std, scalar count."""

    mean: torch.Tensor  # f32[shape]
    s: torch.Tensor  # f32[shape] — sum of squared deviations (M2 in Welford)
    std: torch.Tensor  # f32[shape] — cached std, refreshed on update
    count: torch.Tensor  # f32[] — number of samples folded in


def rms_init(shape, device: str | torch.device = "cpu") -> RunningMeanStd:
    return RunningMeanStd(
        mean=torch.zeros(shape, device=device),
        s=torch.zeros(shape, device=device),
        std=torch.ones(shape, device=device),
        count=torch.zeros((), device=device),
    )


def rms_update(rms: RunningMeanStd, x: torch.Tensor) -> RunningMeanStd:
    """Fold in ONE sample, including the quirk that the very first sample
    sets ``std = x`` (reference utils/normalization.py:10-22)."""
    x = x.float()
    n = rms.count + 1.0
    old_mean = rms.mean
    new_mean = old_mean + (x - old_mean) / n
    new_s = rms.s + (x - old_mean) * (x - new_mean)
    first = n == 1.0
    new_std = torch.where(first, x, torch.sqrt(new_s / n))
    return RunningMeanStd(mean=torch.where(first, x, new_mean), s=new_s, std=new_std, count=n)


def rms_update_batch(rms: RunningMeanStd, xb: torch.Tensor) -> RunningMeanStd:
    """Fold in a batch ``xb[B, *shape]`` with Chan's merge; the first batch
    sets the statistics to the batch's own."""
    xb = xb.float()
    b = float(xb.shape[0])
    b_mean = xb.mean(dim=0)
    b_s = torch.square(xb - b_mean).sum(dim=0)

    n = rms.count + b
    delta = b_mean - rms.mean
    # full_like: a Python scalar over a tensor would be reciprocal-times,
    # which rounds differently from the reference's division
    new_mean = rms.mean + delta * (torch.full_like(n, b) / n)
    new_s = rms.s + b_s + torch.square(delta) * (rms.count * b / n)
    new_std = torch.sqrt(new_s / n)
    first = rms.count == 0.0
    new_mean = torch.where(first, b_mean, new_mean)
    new_std = torch.where(first, torch.sqrt(b_s / max(b, 1.0)) + 1e-8, new_std)
    return RunningMeanStd(mean=new_mean, s=new_s, std=new_std, count=n)


def normalize_obs(rms: RunningMeanStd, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / (std + 1e-8)`` — reference utils/normalization.py:30-34."""
    return (x - rms.mean) / (rms.std + 1e-8)


class RewardScaler(NamedTuple):
    """Per-env-instance discounted-return accumulator + shared running std."""

    rms: RunningMeanStd  # scalar-shaped stats over R
    ret: torch.Tensor  # f32[B] — per-instance discounted return R
    gamma: float


def reward_scaler_init(num_envs: int, gamma: float,
                       device: str | torch.device = "cpu") -> RewardScaler:
    return RewardScaler(
        rms=rms_init((), device),
        ret=torch.zeros(num_envs, device=device),
        gamma=float(gamma),
    )


def reward_scaler_step(scaler: RewardScaler, reward: torch.Tensor,
                       gather=None) -> tuple[RewardScaler, torch.Tensor]:
    """Update R ← γR + r per instance, fold the R batch into the stats, emit
    r/(std+1e-8) (divide-only, no mean subtraction). Under a mesh ``ret``
    holds this rank's envs and ``gather`` returns every rank's, so the
    statistics are those of the whole batch."""
    ret = scaler.gamma * scaler.ret + reward
    rms = rms_update_batch(scaler.rms, ret if gather is None else gather(ret))
    scaled = reward / (rms.std + 1e-8)
    return RewardScaler(rms=rms, ret=ret, gamma=scaler.gamma), scaled


def reward_scaler_reset(scaler: RewardScaler, done: torch.Tensor) -> RewardScaler:
    """Zero the return accumulator of instances whose episode ended."""
    return scaler._replace(ret=torch.where(done, 0.0, scaler.ret))
