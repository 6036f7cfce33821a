"""Workload entry points — ``python -m gymrl_tpu_torch.run.cli <workload> [--device D]``.

Counterpart of ``gymrl_tpu/run/cli.py`` for the workloads the port has so
far. ``--device`` defaults to ``cuda``; pass ``--device cpu`` to run on the
CPU. Ctrl+C stops training gracefully and runs the final evaluation.
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


def _ppo_lunarlander(device: str):
    from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
    return PPOTrainer(PPOConfig(), device=device), "PPO", 200.0


WORKLOADS = {
    "ppo_lunarlander": _ppo_lunarlander,
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

    trainer, algo, solve = WORKLOADS[args.workload](args.device)
    show_config(trainer.cfg, algo)
    loop = TrainLoop(trainer, algo, save_every=100_000, eval_every=100_000)
    ts, stats = loop.train(trainer.cfg.max_train_steps, solve_threshold=solve)
    loop.test(ts)
    logger.info(f"done: {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
