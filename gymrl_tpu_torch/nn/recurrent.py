"""Recurrent cells (counterpart of ``gymrl_tpu/nn/recurrent.py``): flax's
``GRUCell`` and the hybrid ``MLPRNNCell``.

  * ``GRUCell`` — flax.linen's cell, not torch's: six ``Dense`` named
    ``ir``, ``iz``, ``in`` (with bias) and ``hr``, ``hz`` (no bias), ``hn``
    (with bias), computing
    ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``,
    ``n = tanh(in(x) + r·hn(h))``, ``h' = (1 − z)·n + z·h``.
    PyTorch's library GRU puts a bias on every one of the six maps; two of
    them would train and leave flax's parameter tree. Inits are flax's:
    ``lecun_normal`` input kernels, orthogonal recurrent kernels, zero
    biases.
  * ``MLPRNNCell`` — the reference's MLPRNN (utils/model.py:290-302): 3/4
    of the output is a linear map of the input (``rnn_linear``, an ``MLP``
    of one layer and no activation) and 1/4 the GRU's new hidden
    (``output_dim // 4`` wide), concatenated.

Cells are ``(h, x) -> (h', y)`` functions of an explicit carry. ``unroll``
runs a cell over a whole ``[mb, L, ...]`` sequence with the time-independent
input maps batched over all ``mb·L`` rows, so the loop over L holds only
the hidden-side matmul and the gate arithmetic; it equals L calls of the
cell. Submodule names are flax's, so weights map across by name
(``interop.params_from_flax``). ``URNNCell`` is not ported yet
(``ROADMAP.md`` §1 item 12, with ``ppo_lstm``, its only user).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.layers import MLP, Dense


class GRUCell(nn.Module):
    """flax.linen ``GRUCell`` of ``features`` units on ``in_dim`` inputs."""

    def __init__(self, in_dim: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.features = features
        g = generator
        lecun, ortho = gl_init.lecun_normal(), gl_init.orthogonal(1.0)
        # registered in flax's creation order
        self.ir = Dense(in_dim, features, lecun, generator=g)
        self.hr = Dense(features, features, ortho, bias=False, generator=g)
        self.iz = Dense(in_dim, features, lecun, generator=g)
        self.hz = Dense(features, features, ortho, bias=False, generator=g)
        self.add_module("in", Dense(in_dim, features, lecun, generator=g))  # a keyword
        self.hn = Dense(features, features, ortho, generator=g)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        h = (1.0 - z) * n + z * h
        return h, h

    def unroll(self, h: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """``hs[mb, L, H]``: the hidden after each step of ``xs[mb, L, in]``
        from ``h[mb, H]``. The three input maps are one matmul over all
        steps; each step is one matmul of the stacked hidden maps (``hn``'s
        bias inside it) and the gates. The steps are collected with
        ``stack`` (an in-place write into one buffer would trip autograd)."""
        H = self.features
        n_in = getattr(self, "in")
        xg = F.linear(xs, torch.cat([self.ir.weight, self.iz.weight, n_in.weight]),
                      torch.cat([self.ir.bias, self.iz.bias, n_in.bias]))
        w_h = torch.cat([self.hr.weight, self.hz.weight, self.hn.weight]).t()
        b_h = torch.cat([self.hn.bias.new_zeros(2 * H), self.hn.bias])
        hs = []
        for t in range(xs.shape[1]):
            hg = torch.addmm(b_h, h, w_h)
            x_t = xg[:, t]
            rz = torch.sigmoid(x_t[:, :2 * H] + hg[:, :2 * H])
            r, z = rz[:, :H], rz[:, H:]
            n = torch.tanh(x_t[:, 2 * H:] + r * hg[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            hs.append(h)
        return torch.stack(hs, dim=1)


class MLPRNNCell(nn.Module):
    """One step of the hybrid MLP+GRU layer. Carry: ``h[B, output_dim // 4]``."""

    def __init__(self, in_dim: int, output_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        if output_dim % 4:
            raise ValueError(f"output_dim {output_dim} must be divisible by 4")
        self.rnn_size = output_dim // 4
        self.rnn_linear = MLP(in_dim, [3 * self.rnn_size], generator=generator)
        self.gru = GRUCell(in_dim, self.rnn_size, generator=generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        linear_out = self.rnn_linear(x)
        h, rnn_out = self.gru(h, x)
        return h, torch.cat([linear_out, rnn_out], dim=-1)

    def unroll(self, h: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """Outputs ``[mb, L, output_dim]`` of ``xs[mb, L, in]`` from ``h``;
        the last step's hidden is the last ``rnn_size`` columns."""
        return torch.cat([self.rnn_linear(xs), self.gru.unroll(h, xs)], dim=-1)

    def initial_state(self, batch: int, device: str | torch.device = "cpu") -> torch.Tensor:
        return torch.zeros(batch, self.rnn_size, device=device)
