"""Layers (counterpart of ``gymrl_tpu/nn/layers.py``). Only ``Dense`` so far."""

from __future__ import annotations

import torch
from torch import nn

from gymrl_tpu_torch.nn import initializers as gl_init


class Dense(nn.Linear):
    """``nn.Linear`` with the reference's init: ``kernel_init`` on the weight
    (default kaiming-uniform) and a zero bias. ``generator`` makes the init
    reproducible without touching the global RNG."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_init: gl_init.Initializer = gl_init.kaiming_uniform(),
                 bias: bool = True, generator: torch.Generator | None = None):
        # nn.Linear.__init__ calls reset_parameters(); it reads these two.
        self.kernel_init = kernel_init
        self._init_generator = generator
        super().__init__(in_features, out_features, bias=bias)
        del self._init_generator

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.kernel_init(self.weight, getattr(self, "_init_generator", None))
            if self.bias is not None:
                self.bias.zero_()
