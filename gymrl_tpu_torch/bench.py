"""Throughput benchmark of the port: PPO on LunarLander, one GPU.

    python -m gymrl_tpu_torch.bench [--device cuda]

The JAX package's ``bench.py`` config exactly: B=8192 envs × T=64 steps,
4 epochs × minibatch 16384 (128 grad steps per 524288-sample rollout), flat
optimizer, bf16 SGD, unroll 8 (a no-op here). Two warm-up iterations (the
eager one, then the one that captures the SGD sweep's CUDA graph, as the
JAX bench's first call compiles), then 5 timed ones fenced by
``torch.cuda.synchronize()``. Prints ONE JSON line of
``bench.py``'s shape — metric, value, unit, vs_baseline (value / 1e6) — plus
the GPU's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
from gymrl_tpu_torch.utils.device import gpu_name_and_power_limit

BENCH_CONFIG = PPOConfig(
    env_name="LunarLander-v3",
    num_envs=8192,
    rollout_steps=64,
    minibatch_size=16384,
    num_epochs=4,
    flat_optimizer=True,
    sgd_bf16=True,
    sgd_unroll=8,
    rollout_unroll=8,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m gymrl_tpu_torch.bench")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = BENCH_CONFIG
    trainer = PPOTrainer(cfg, device=args.device)
    ts = trainer.init(0)

    for _ in range(2):  # the warm-up, then the sweep's capture
        ts, _ = trainer.train_iter(ts)
    _sync(trainer.device)

    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, _ = trainer.train_iter(ts)
    _sync(trainer.device)
    dt = time.perf_counter() - t0

    sps = iters * cfg.batch_total / dt
    result = {
        "metric": "ppo_lunarlander_env_steps_per_s",
        "value": round(sps, 1),
        "unit": "steps/s",
        "vs_baseline": round(sps / 1_000_000, 4),
    }
    if trainer.device.type == "cuda":
        result["device"] = torch.cuda.get_device_name(trainer.device)
        result["nvidia_smi"] = gpu_name_and_power_limit()
    else:
        result["device"] = "cpu"
    print(json.dumps(result))


if __name__ == "__main__":
    main()
