"""Workload entry points — ``python -m gymrl_tpu_torch.run.cli <workload> [--device D]``.

Counterpart of ``gymrl_tpu/run/cli.py``, with all 21 of its workloads.
``--device`` defaults to ``cuda``; pass ``--device cpu`` to run on the CPU.
Ctrl+C stops training gracefully and runs the final evaluation. A workload
that trains nothing (``mountaincar_baseline``) runs itself and returns
``None``; ``main`` then returns 0 without a ``TrainLoop``.
"""

from __future__ import annotations

import argparse
import sys

from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.logging import get_logger

logger = get_logger()


def show_config(cfg, algo: str) -> None:
    """Pretty-print the config at startup (ref BasicConfig.show,
    utils/runner.py:39-43)."""
    logger.info(f"{algo} config:")
    for k in cfg.__dataclass_fields__:
        logger.info(f"  {k}: {getattr(cfg, k)}")


def _dqn_cartpole(device: str):
    from gymrl_tpu_torch.algos.dqn import DQNConfig, DQNTrainer
    return DQNTrainer(DQNConfig(), device=device), "DQN", 495.0


def _ddqn_per_cartpole(device: str):
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, ddqn_per_config
    return DQNFamilyTrainer(ddqn_per_config(), device=device), "DDQN_PER", 495.0


def _ddqn_per_duel_cartpole(device: str):
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, ddqn_per_duel_config
    return DQNFamilyTrainer(ddqn_per_duel_config(), device=device), "DDQN_PER_DUEL", 495.0


def _noisy_dqn_cartpole(device: str):
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, noisy_dqn_config
    return DQNFamilyTrainer(noisy_dqn_config(), device=device), "NoisyDQN", 495.0


def _rainbow_dqn_cartpole(device: str):
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, rainbow_config
    return DQNFamilyTrainer(rainbow_config(), device=device), "RainbowDQN", 495.0


def _noisy_dqn_flappybird(device: str):
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, noisy_dqn_flappybird_config
    return DQNFamilyTrainer(noisy_dqn_flappybird_config(), device=device), "NoisyDQN", None


def _dqn_cartpole_pixels(device: str):
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, dqn_pixels_config
    return DQNFamilyTrainer(dqn_pixels_config(), device=device), "DQN_Pixels", 495.0


def _qlearning_frozenlake(device: str):
    from gymrl_tpu_torch.algos.tabular import QLearningTrainer, qlearning_frozenlake_config
    return QLearningTrainer(qlearning_frozenlake_config(), device=device), "QLearning", None


def _qlearning_cliffwalking(device: str):
    from gymrl_tpu_torch.algos.tabular import QLearningTrainer, qlearning_cliffwalking_config
    return QLearningTrainer(qlearning_cliffwalking_config(), device=device), "QLearning", None


def _mountaincar_baseline(device: str):
    """Ten deterministic episodes of the rule policy, logged; trains nothing."""
    from gymrl_tpu_torch.algos.tabular import MountainCarBaseline
    from gymrl_tpu_torch.core.noise import Noise

    agent = MountainCarBaseline(device=device)
    returns, _ = agent.eval_episodes(agent.init(0), Noise(agent.device, 1), 10)
    logger.info(f"rule-based MountainCar: {float(returns.mean()):.1f} "
                f"± {float(returns.std(correction=0)):.1f} over 10 episodes")
    return None


def _ppo_lunarlander(device: str):
    from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
    return PPOTrainer(PPOConfig(), device=device), "PPO", 200.0


def _ppo_rnn_lunarlander(device: str):
    from gymrl_tpu_torch.algos.ppo_rnn import PPORNNTrainer, ppo_rnn_lunarlander_config
    return PPORNNTrainer(ppo_rnn_lunarlander_config(), device=device), "PPO_RNN", 200.0


def _ppo_rnn_flappybird(device: str):
    from gymrl_tpu_torch.algos.ppo_rnn import PPORNNTrainer, ppo_rnn_flappybird_config
    return PPORNNTrainer(ppo_rnn_flappybird_config(), device=device), "PPO_RNN", None


def _ppg_rnn_lunarlander(device: str):
    from gymrl_tpu_torch.algos.ppg import PPGTrainer, ppg_rnn_lunarlander_config
    return PPGTrainer(ppg_rnn_lunarlander_config(), device=device), "PPG_RNN", 200.0


def _ppo_full_lunarlander(device: str):
    from gymrl_tpu_torch.algos.ppo_full import PPOFullConfig, PPOFullTrainer
    return PPOFullTrainer(PPOFullConfig(flat_optimizer=True), device=device), "PPO_FULL", 200.0


def _ppo_lstm_lunarlander(device: str):
    from gymrl_tpu_torch.algos.ppo_lstm import PPOLSTMConfig, PPOLSTMTrainer
    return PPOLSTMTrainer(PPOLSTMConfig(flat_optimizer=True), device=device), "PPO_LSTM", 200.0


def _ppo_cartpole(device: str):
    from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
    cfg = PPOConfig(env_name="CartPole-v1", solve_threshold=495.0)
    return PPOTrainer(cfg, device=device), "PPO", 495.0


def _sac_pendulum(device: str):
    from gymrl_tpu_torch.algos.continuous import SACTrainer, sac_config
    return SACTrainer(sac_config(), device=device), "SAC", None


def _sac_cartpole(device: str):
    from gymrl_tpu_torch.algos.continuous import DiscreteSACTrainer, sac_discrete_config
    return DiscreteSACTrainer(sac_discrete_config(), device=device), "SACD", 495.0


def _td3_pendulum(device: str):
    from gymrl_tpu_torch.algos.continuous import TD3Trainer, td3_config
    return TD3Trainer(td3_config(), device=device), "TD3", None


def _ddpg_pendulum(device: str):
    from gymrl_tpu_torch.algos.continuous import DDPGTrainer, ddpg_config
    return DDPGTrainer(ddpg_config(), device=device), "DDPG", None


WORKLOADS = {
    "dqn_cartpole": _dqn_cartpole,
    "ddqn_per_cartpole": _ddqn_per_cartpole,
    "ddqn_per_duel_cartpole": _ddqn_per_duel_cartpole,
    "noisy_dqn_cartpole": _noisy_dqn_cartpole,
    "rainbow_dqn_cartpole": _rainbow_dqn_cartpole,
    "noisy_dqn_flappybird": _noisy_dqn_flappybird,
    "dqn_cartpole_pixels": _dqn_cartpole_pixels,
    "ppo_lunarlander": _ppo_lunarlander,
    "ppo_cartpole": _ppo_cartpole,
    "ppo_rnn_lunarlander": _ppo_rnn_lunarlander,
    "ppo_rnn_flappybird": _ppo_rnn_flappybird,
    "ppg_rnn_lunarlander": _ppg_rnn_lunarlander,
    "ppo_full_lunarlander": _ppo_full_lunarlander,
    "ppo_lstm_lunarlander": _ppo_lstm_lunarlander,
    "sac_pendulum": _sac_pendulum,
    "sac_cartpole": _sac_cartpole,
    "td3_pendulum": _td3_pendulum,
    "ddpg_pendulum": _ddpg_pendulum,
    "qlearning_frozenlake": _qlearning_frozenlake,
    "qlearning_cliffwalking": _qlearning_cliffwalking,
    "mountaincar_baseline": _mountaincar_baseline,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in WORKLOADS:
        print(f"usage: python -m gymrl_tpu_torch.run.cli <workload> [--device cuda|cpu]\n"
              f"workloads: {', '.join(sorted(WORKLOADS))}")
        return 1
    parser = argparse.ArgumentParser(prog="python -m gymrl_tpu_torch.run.cli")
    parser.add_argument("workload", choices=sorted(WORKLOADS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    built = WORKLOADS[args.workload](args.device)
    if built is None:  # a baseline-style workload has run itself
        return 0
    trainer, algo, solve = built
    show_config(trainer.cfg, algo)
    loop = TrainLoop(trainer, algo, save_every=100_000, eval_every=100_000)
    ts, stats = loop.train(trainer.cfg.max_train_steps, solve_threshold=solve)
    loop.test(ts)
    logger.info(f"done: {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
