"""Recurrent cells (counterpart of ``gymrl_tpu/nn/recurrent.py``): flax's
``GRUCell`` and ``OptimizedLSTMCell``, the packed ``URNNCell`` and the
hybrid ``MLPRNNCell``.

  * ``GRUCell`` — flax.linen's cell, not torch's: six ``Dense`` named
    ``ir``, ``iz``, ``in`` (with bias) and ``hr``, ``hz`` (no bias), ``hn``
    (with bias), computing
    ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``,
    ``n = tanh(in(x) + r·hn(h))``, ``h' = (1 − z)·n + z·h``.
    PyTorch's library GRU puts a bias on every one of the six maps; two of
    them would train and leave flax's parameter tree. Inits are flax's:
    ``lecun_normal`` input kernels, orthogonal recurrent kernels, zero
    biases.
  * ``LSTMCell`` — flax.linen's ``OptimizedLSTMCell``, not torch's: input
    kernels ``ii``, ``if``, ``ig``, ``io`` without bias and recurrent
    kernels ``hi``, ``hf``, ``hg``, ``ho`` with bias; i, f, o through σ
    and g through tanh, ``c' = f·c + i·g``, ``h' = o·tanh(c')``; flax's
    carry order ``(c, h)`` and flax's inits, as the GRU's.
  * ``URNNCell`` — ppo_lstm's cell behind one packed hidden vector:
    ``[h]`` for the GRU, ``[h | c]`` for the LSTM.
  * ``MLPRNNCell`` — the reference's MLPRNN (utils/model.py:290-302): 3/4
    of the output is a linear map of the input (``rnn_linear``, an ``MLP``
    of one layer and no activation) and 1/4 the GRU's new hidden
    (``output_dim // 4`` wide), concatenated.

Cells are ``(h, x) -> (h', y)`` functions of an explicit carry. ``unroll``
runs a cell over a whole ``[mb, L, ...]`` sequence with the time-independent
input maps batched over all ``mb·L`` rows, so the loop over L holds only
the hidden-side matmul and the gate arithmetic; it equals L calls of the
cell. Submodule names are flax's, so weights map across by name
(``interop.params_from_flax``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.layers import MLP, Dense
from gymrl_tpu_torch.utils.profiling import span


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
        with span("rnn.unroll"):
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


class LSTMCell(nn.Module):
    """flax.linen ``OptimizedLSTMCell`` of ``features`` units on ``in_dim``
    inputs. Carry ``(c, h)`` as flax orders it."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_dim: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.features = features
        g = generator
        lecun, ortho = gl_init.lecun_normal(), gl_init.orthogonal(1.0)
        for gate in self.GATES:  # flax's creation order; "if" is a keyword
            self.add_module(f"i{gate}", Dense(in_dim, features, lecun, bias=False, generator=g))
            self.add_module(f"h{gate}", Dense(features, features, ortho, generator=g))

    def _gates(self, xg: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
               w_h: torch.Tensor, b_h: torch.Tensor):
        """One step from the input maps ``xg[..., 4H]`` (gate order i, f, g,
        o): the stacked hidden maps, then ``c' = f·c + i·g``, ``h' = o·tanh(c')``."""
        H = self.features
        z = torch.addmm(b_h, h, w_h) + xg
        i, f, o = (torch.sigmoid(z[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
        c = f * c + i * torch.tanh(z[:, 2 * H:3 * H])
        return c, o * torch.tanh(c)

    def _stacked(self):
        """The four input kernels, and the four hidden kernels and biases,
        each as one matrix in gate order."""
        w_i = torch.cat([getattr(self, f"i{k}").weight for k in self.GATES])
        w_h = torch.cat([getattr(self, f"h{k}").weight for k in self.GATES]).t()
        b_h = torch.cat([getattr(self, f"h{k}").bias for k in self.GATES])
        return w_i, w_h, b_h

    def forward(self, carry: tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
        c, h = carry
        w_i, w_h, b_h = self._stacked()
        c, h = self._gates(F.linear(x, w_i), c, h, w_h, b_h)
        return (c, h), h

    def unroll(self, c: torch.Tensor, h: torch.Tensor,
               xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(hs[mb, L, H], c_L)`` of ``xs[mb, L, in]`` from ``(c, h)``: the
        input maps are one matmul over all steps, each step one matmul of
        the stacked hidden maps and the gates (``GRUCell.unroll``'s shape)."""
        with span("rnn.unroll"):
            w_i, w_h, b_h = self._stacked()
            xg = F.linear(xs, w_i)
            hs = []
            for t in range(xs.shape[1]):
                c, h = self._gates(xg[:, t], c, h, w_h, b_h)
                hs.append(h)
            return torch.stack(hs, dim=1), c


class URNNCell(nn.Module):
    """The unified cell of ppo_lstm (reference ppo_lstm_lunarlander.py:449-491)
    with ONE packed hidden vector: ``'gru'`` packs ``[h]`` (a ``GRUCell``
    named ``gru``), ``'lstm'`` packs ``[h | c]`` (an ``LSTMCell`` named
    ``lstm``), so trainers store and reset hiddens alike for either."""

    def __init__(self, in_dim: int, hidden_size: int, cell_type: str = "gru",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cell_type not in ("gru", "lstm"):
            raise ValueError(f"cell_type must be 'gru' or 'lstm', got {cell_type!r}")
        self.hidden_size, self.cell_type = hidden_size, cell_type
        cls = LSTMCell if cell_type == "lstm" else GRUCell
        self.add_module(cell_type, cls(in_dim, hidden_size, generator))

    @property
    def packed_size(self) -> int:
        return self.hidden_size * (2 if self.cell_type == "lstm" else 1)

    def forward(self, packed: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.cell_type == "lstm":
            h, c = packed.split(self.hidden_size, dim=-1)
            (c, h), out = self.lstm((c, h), x)
            return torch.cat([h, c], dim=-1), out
        return self.gru(packed, x)

    def unroll(self, packed: torch.Tensor, xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(outs[mb, L, H], packed_L)``: the outputs of ``xs[mb, L, in]``
        from ``packed[mb, packed_size]`` and the last packed hidden; equals L
        calls of the cell."""
        if self.cell_type == "lstm":
            h, c = packed.split(self.hidden_size, dim=-1)
            hs, c = self.lstm.unroll(c, h, xs)
            return hs, torch.cat([hs[:, -1], c], dim=-1)
        hs = self.gru.unroll(packed, xs)
        return hs, hs[:, -1]

    def initial_state(self, batch: int, device: str | torch.device = "cpu") -> torch.Tensor:
        return torch.zeros(batch, self.packed_size, device=device)


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
