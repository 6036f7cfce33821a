"""Hand-written CUDA kernels of the port, for Hopper (sm_90a).

  * ``lunarlander.cu`` / ``lunarlander.py``: the batched LunarLander step
    and reset (``lander_step``, ``lander_reset``), which
    ``envs.lunarlander.LunarLander`` runs for every batch on a CUDA device.
  * ``ppo.cu`` / ``ppo.py``: PPO's update (``ppo_loss_fwd``,
    ``ppo_loss_bwd``, ``grad_sq_norms``, ``clip_adam``), which every grad
    step of ``algos.ppo.PPOTrainer`` runs on a CUDA device.

``build.py`` compiles each source with ``nvcc`` at its first use. Each
wrapper adds one to its entry of ``LAUNCHES`` where it launches its kernel,
so a run can show which kernels its path went through; a CUDA graph's
replay adds what its capture counted. ``launch`` calls a
C launcher of either library.
"""

import torch

LAUNCHES: dict[str, int] = {"lunarlander_step": 0, "lunarlander_reset": 0, "ppo_loss_fwd": 0,
                            "ppo_loss_bwd": 0, "grad_sq_norms": 0, "clip_adam": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts: dict[str, int]) -> None:
    """Adds ``counts`` to ``LAUNCHES``: what one replay of a CUDA graph
    launches, as its capture counted it (``algos.base.SweepGraph``)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def launch(fn, args, device: torch.device, what: str) -> None:
    """``fn(*args, device index, stream)``: a C launcher of this package,
    each tensor of ``args`` passed as its address, on the current stream of
    ``device``; raises on a nonzero ``cudaError_t``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if torch.cuda.is_initialized() and torch.cuda.current_device() == device.index:
        err = fn(*args, device.index, stream)
    else:
        # The launcher sets ``device`` in its own CUDA runtime; entering it here
        # too lets PyTorch's runtime restore its current device afterwards.
        with torch.cuda.device(device):
            err = fn(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")
