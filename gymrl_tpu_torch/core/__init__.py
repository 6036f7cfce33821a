from gymrl_tpu_torch.core.gae import compute_gae, compute_gae_dual_lambda, standardize
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.core.normalization import (
    RewardScaler,
    RunningMeanStd,
    normalize_obs,
    reward_scaler_init,
    reward_scaler_reset,
    reward_scaler_step,
    rms_init,
    rms_update,
    rms_update_batch,
)
from gymrl_tpu_torch.core.schedules import (
    exp_epsilon_decay,
    linear_anneal,
    per_beta_anneal,
    ref_lr_decay,
)

__all__ = [
    "compute_gae", "compute_gae_dual_lambda", "standardize", "Noise",
    "RunningMeanStd", "rms_init", "rms_update", "rms_update_batch", "normalize_obs",
    "RewardScaler", "reward_scaler_init", "reward_scaler_step", "reward_scaler_reset",
    "exp_epsilon_decay", "linear_anneal", "ref_lr_decay", "per_beta_anneal",
]
