"""Weight initializers (counterpart of ``gymrl_tpu/nn/initializers.py``).

The reference's ``initialize_weights`` scheme: kaiming-uniform (default,
leaky_relu nonlinearity), xavier-uniform, orthogonal with gain √2; biases
zero. Per-layer orthogonal gains (policy head 0.01, value head 1.0) are
passed explicitly. flax's ``lecun_normal`` serves the GRU cell's input
layers and the conv layers.

Each initializer is ``init(weight, generator)`` and fills a torch weight in
its ``[out, in]`` layout in place. The JAX package fills flax kernels laid
out ``[in, out]``; the distributions are the same (fan_in is the ``in``
axis either way), which is all the reference promises — bit parity across
frameworks is neither possible nor needed.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Initializer = Callable[[torch.Tensor, "torch.Generator | None"], torch.Tensor]


def kaiming_uniform(nonlinearity: str = "leaky_relu", a: float = 0.01) -> Initializer:
    """torch.nn.init.kaiming_uniform_ with fan_in over the ``in`` axis;
    gain = sqrt(2/(1+a²)) for leaky_relu, √2 for relu, else 1."""

    def init(weight, generator=None):
        fan_in = weight.shape[1] if weight.dim() >= 2 else 1
        if nonlinearity == "relu":
            gain = math.sqrt(2.0)
        elif nonlinearity == "leaky_relu":
            gain = math.sqrt(2.0 / (1.0 + a * a))
        else:
            gain = 1.0
        bound = gain * math.sqrt(3.0 / fan_in)
        with torch.no_grad():
            return weight.uniform_(-bound, bound, generator=generator)

    return init


def orthogonal(gain: float = math.sqrt(2.0)) -> Initializer:
    def init(weight, generator=None):
        return torch.nn.init.orthogonal_(weight, gain, generator=generator)

    return init


def xavier_uniform() -> Initializer:
    def init(weight, generator=None):
        return torch.nn.init.xavier_uniform_(weight, generator=generator)

    return init


def lecun_normal() -> Initializer:
    """flax's ``lecun_normal``, ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``: a normal truncated to ±2σ, with σ rescaled by
    the truncation's std (0.8796...) so the variance is 1/fan_in. The
    default kernel init of flax's ``GRUCell`` input layers and ``Conv``."""

    def init(weight, generator=None):
        fan_in = math.prod(weight.shape[1:])  # in, or in·kh·kw of an OIHW conv kernel
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)

    return init


INITS = {
    "kaiming": kaiming_uniform(),
    "xavier": xavier_uniform(),
    "orthogonal": orthogonal(),
}
