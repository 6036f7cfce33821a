"""Hand-written CUDA kernels of the port, for Hopper (sm_90a).

  * ``lunarlander.cu`` / ``lunarlander.py``: the batched LunarLander step
    and reset (``lander_step``, ``lander_reset``), which
    ``envs.lunarlander.LunarLander`` runs for every batch on a CUDA device.
  * ``ppo.cu`` / ``ppo.py``: PPO's update (``ppo_loss_fwd``,
    ``ppo_loss_bwd``, ``grad_sq_norms``, ``clip_adam``), which every grad
    step of ``algos.ppo.PPOTrainer`` runs on a CUDA device.

``build.py`` compiles each source with ``nvcc`` at its first use. Each
wrapper adds one to its entry of ``LAUNCHES`` where it launches its kernel,
so a run can show which kernels its path went through.
"""

LAUNCHES: dict[str, int] = {"lunarlander_step": 0, "lunarlander_reset": 0, "ppo_loss_fwd": 0,
                            "ppo_loss_bwd": 0, "grad_sq_norms": 0, "clip_adam": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
