from gymrl_tpu_torch.algos.base import IterOut, Trainer, masked_mean
from gymrl_tpu_torch.algos.continuous import (
    DDPGTrainer,
    DiscreteSACTrainer,
    OffPolicyConfig,
    SACTrainer,
    TD3Trainer,
    ddpg_config,
    sac_config,
    sac_discrete_config,
    td3_config,
)
from gymrl_tpu_torch.algos.dqn import DQNConfig, DQNTrainer
from gymrl_tpu_torch.algos.dqn_variants import (
    DQNFamilyConfig,
    DQNFamilyTrainer,
    ddqn_per_config,
    ddqn_per_duel_config,
    dqn_pixels_config,
    noisy_dqn_config,
    noisy_dqn_flappybird_config,
    rainbow_config,
)
from gymrl_tpu_torch.algos.ppg import PPGConfig, PPGTrainer, ppg_rnn_lunarlander_config
from gymrl_tpu_torch.algos.ppo import ActorCritic, PPOConfig, PPOTrainer, PPOTrainState
from gymrl_tpu_torch.algos.ppo_full import FullTrainState, PPOFullConfig, PPOFullTrainer
from gymrl_tpu_torch.algos.ppo_lstm import LSTMTrainState, PPOLSTMConfig, PPOLSTMTrainer
from gymrl_tpu_torch.algos.ppo_rnn import (
    PPORNNConfig,
    PPORNNTrainer,
    RNNTrainState,
    ppo_rnn_flappybird_config,
    ppo_rnn_lunarlander_config,
)
from gymrl_tpu_torch.algos.tabular import (
    MountainCarBaseline,
    QLearningConfig,
    QLearningTrainer,
    QLearningTrainState,
    qlearning_cliffwalking_config,
    qlearning_frozenlake_config,
)

__all__ = [
    "IterOut", "Trainer", "masked_mean",
    "DQNConfig", "DQNTrainer",
    "DQNFamilyConfig", "DQNFamilyTrainer", "ddqn_per_config", "ddqn_per_duel_config",
    "noisy_dqn_config", "noisy_dqn_flappybird_config", "rainbow_config", "dqn_pixels_config",
    "ActorCritic", "PPOConfig", "PPOTrainer", "PPOTrainState",
    "PPORNNConfig", "PPORNNTrainer", "RNNTrainState", "ppo_rnn_lunarlander_config",
    "ppo_rnn_flappybird_config", "PPGConfig", "PPGTrainer", "ppg_rnn_lunarlander_config",
    "PPOFullConfig", "PPOFullTrainer", "FullTrainState",
    "PPOLSTMConfig", "PPOLSTMTrainer", "LSTMTrainState",
    "OffPolicyConfig", "DDPGTrainer", "TD3Trainer", "SACTrainer", "DiscreteSACTrainer",
    "ddpg_config", "td3_config", "sac_config", "sac_discrete_config",
    "QLearningConfig", "QLearningTrainer", "QLearningTrainState", "MountainCarBaseline",
    "qlearning_frozenlake_config", "qlearning_cliffwalking_config",
]
