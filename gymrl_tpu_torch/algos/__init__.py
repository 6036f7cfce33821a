from gymrl_tpu_torch.algos.base import IterOut, Trainer, masked_mean
from gymrl_tpu_torch.algos.ppo import ActorCritic, PPOConfig, PPOTrainer, PPOTrainState

__all__ = [
    "IterOut", "Trainer", "masked_mean",
    "ActorCritic", "PPOConfig", "PPOTrainer", "PPOTrainState",
]
