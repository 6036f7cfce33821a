"""The program's random source, draw for draw: a copy of
``gymrl_tpu_torch/core/noise.py`` ``Noise`` :59-88, one ``torch.Generator``
on the device, seeded once. An env of the reference draws its resets and
steps from it in the program's order (``lander.py`` ``VecLander``)."""

from __future__ import annotations

import torch

_F32_TINY = float(torch.finfo(torch.float32).tiny)


class Draws:
    def __init__(self, device: torch.device, seed: int):
        self.device = device
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def uniform(self, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u * (high - low) + low

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        return torch.randint(low, high, shape, generator=self.generator,
                             device=self.device, dtype=torch.int32)

    def gumbel(self, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return -torch.log(-torch.log(u.clamp_(min=_F32_TINY)))

    def permutations(self, count: int, n: int) -> torch.Tensor:
        return torch.stack([torch.randperm(n, generator=self.generator, device=self.device)
                            for _ in range(count)])
