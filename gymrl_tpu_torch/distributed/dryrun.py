"""Multichip dry run: one full training step of four families on a mesh
(counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``, with its families, meshes and config sizes).

  * PPO on a ``data × model`` mesh when ``n ≥ 4`` and ``n`` is even (the
    trunk split over ``model``), else on pure DP;
  * Rainbow (PER sum-tree, n-step window, soft targets), SAC (twin critics,
    auto-α, Polyak targets on Pendulum) and PPO-LSTM (RND, mHC backbone,
    URNN) on a pure-DP mesh.

``dryrun_multichip(n)`` runs as ONE rank of a process group of ``n``: every
rank calls it. Under ``torchrun`` (one process per card)::

    torchrun --nproc_per_node=N -m gymrl_tpu_torch.distributed.dryrun
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gymrl_tpu_torch.distributed.mesh import initialize_multihost, make_mesh


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> dict:
    """One ``train_iter`` of each family over a mesh of ``n_devices`` ranks;
    returns each family's metrics (the same on every rank)."""
    from gymrl_tpu_torch.algos.continuous import SACTrainer, sac_config
    from gymrl_tpu_torch.algos.dqn_variants import DQNFamilyTrainer, rainbow_config
    from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
    from gymrl_tpu_torch.algos.ppo_lstm import PPOLSTMConfig, PPOLSTMTrainer

    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun over {n_devices} ranks in a group of {dist.get_world_size()}")
    kind = "cuda" if device is None else torch.device(device).type
    n_model = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model, device=device)
    dp_mesh = (mesh if n_model == 1
               else make_mesh(n_data=n_devices, n_model=1, device=device))
    out = {}

    cfg = PPOConfig(env_name="CartPole-v1", num_envs=2 * n_devices, rollout_steps=8,
                    minibatch_size=16, num_epochs=2)
    trainer = PPOTrainer(cfg, device=kind, mesh=mesh)
    ts, o = trainer.train_iter(trainer.init(0))
    assert ts.env_steps == cfg.num_envs * cfg.rollout_steps
    out["ppo"] = o.metrics

    rcfg = rainbow_config(num_envs=2 * n_devices, steps_per_iter=8, updates_per_step=1,
                          batch_size=2 * n_devices * 4, memory_capacity=1024)
    rtrainer = DQNFamilyTrainer(rcfg, device=kind, mesh=dp_mesh)
    rts, o = rtrainer.train_iter(rtrainer.init(1))
    assert rts.env_steps == rcfg.num_envs * rcfg.steps_per_iter
    out["rainbow"] = o.metrics

    scfg = sac_config(num_envs=2 * n_devices, steps_per_iter=8, updates_per_step=1,
                      batch_size=2 * n_devices * 4, memory_capacity=1024)
    strainer = SACTrainer(scfg, device=kind, mesh=dp_mesh)
    sts, o = strainer.train_iter(strainer.init(2))
    assert sts.env_steps == scfg.num_envs * scfg.steps_per_iter
    out["sac"] = o.metrics

    lcfg = PPOLSTMConfig(env_name="LunarLander-v3", num_envs=2 * n_devices, rollout_steps=8,
                         seq_len=8, seq_minibatch=2 * n_devices, num_epochs=2,
                         mhc_dim=32, mhc_layers=1, mhc_sk_it=3, rnn_hidden=32, rnd_embed=32)
    ltrainer = PPOLSTMTrainer(lcfg, device=kind, mesh=dp_mesh)
    lts, o = ltrainer.train_iter(ltrainer.init(3))
    assert lts.env_steps == lcfg.num_envs * lcfg.rollout_steps
    out["ppo_lstm"] = o.metrics
    for family, metrics in out.items():
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise FloatingPointError(f"{family}: metric {k} is {float(v)}")
    return {f: {k: float(v) for k, v in m.items()} for f, m in out.items()}


def main() -> None:
    """Join the group from ``torchrun``'s environment and run the dry run."""
    rank = initialize_multihost()
    try:
        metrics = dryrun_multichip(dist.get_world_size())
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(metrics, flush=True)


if __name__ == "__main__":
    main()
