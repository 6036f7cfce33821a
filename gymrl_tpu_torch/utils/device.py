"""Device selection: ``cuda`` unless the caller asks for the CPU.

There is no silent fallback. An entry point asked for ``cuda`` on a machine
without a GPU raises, so a CPU run is never mistaken for a GPU run.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if CUDA is asked for and absent.

    On CUDA this also turns TF32 off for matmuls and cuDNN: the JAX
    reference computes its float32 matmuls in full float32, and TF32 keeps
    only about three decimal digits. Both flags are process-wide and are
    set here, where the port first selects the GPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every visible card.

    Speed figures are recorded beside this line: a card set below its
    maximum power limit runs slower under load.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
