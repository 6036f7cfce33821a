"""Layers (counterpart of ``gymrl_tpu/nn/layers.py``): ``Dense``, ``PReLU``,
``NoisyDense``, ``LayerNorm``, ``MLP``, ``PSCN``, ``RMSNorm``, the conv
layers (``Conv``, ``ConvEncoder``, ``DSConv``, ``NoisyConv2d``),
``positional_encoding`` and ``MultiHeadAttention``.

Parameter and submodule names are the flax ones (``layer_{i}``, ``act_{i}``,
``mlp_{i}``, ``kernel_mu``, ``negative_slope``, ...), so
weights map across by name (``interop.params_from_flax``). ``Dense`` keeps
torch's ``[out, in]`` weight; ``NoisyDense`` keeps flax's ``[in, out]``
kernels, which its per-row form multiplies as they are.

The conv layers take and give channels-last ``[N, H, W, C]`` tensors, as
flax's do, so a flattened conv output has flax's order and the ``Dense``
after it maps across unchanged. ``Conv`` keeps torch's OIHW weight (flax's
HWIO kernel, transposed by ``interop``) and runs ``conv2d`` on the
channels-last tensor viewed as NCHW; ``NoisyConv2d`` keeps flax's HWIO
``kernel_mu``/``kernel_sigma``, as ``NoisyDense`` keeps its layout.

NoisyNet noise is an argument, never drawn inside a layer: a noisy forward
takes one ``(eps_in, eps_out)`` pair per noisy layer, in call order (the
order of ``noisy_layers(module)``), already passed through
``f(ε) = sign(ε)·√|ε|``, as ``Noise.noisy_act`` / ``Noise.noisy_update``
hand them out. Composite modules take an iterator over the pairs and each
noisy layer takes the next one; ``None`` gives the μ-only forward (eval,
and the target network). A pair of vectors ``[in]``/``[out]`` is one draw
shared by the batch; ``[rows, in]``/``[rows, out]`` is one per row.

``mlp_activation_edges`` / ``pscn_activation_edges`` state where an MLP's
or a PSCN's PReLU kinks sit and which layers read those units; a net's
``activation_edges`` is built from them.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence

import numpy as np
import torch
from torch import nn

from gymrl_tpu_torch.nn import initializers as gl_init

NoiseIter = Iterator[tuple[torch.Tensor, torch.Tensor]] | None


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


class PReLU(nn.Module):
    """One shared slope, torch's default init 0.25:
    ``where(x >= 0, x, a·x)``."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


class NoisyDense(nn.Module):
    """Factorized-Gaussian NoisyNet linear layer (reference
    utils/model.py:54-97). μ ~ U(±1/√in), σ₀ = 0.5/√fan.

    ``eps=None``: ``x @ w_μ + b_μ``. A shared pair:
    ``x @ (w_μ + w_σ ∘ (ε_in ⊗ ε_out)) + b_μ + b_σ ∘ ε_out``. A per-row pair:
    ``x_i@w_μ + ((x_i∘ε_in_i)@w_σ)∘ε_out_i + b_μ + b_σ∘ε_out_i``, two plain
    matmuls with no per-row weight."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        mu_range = 1.0 / math.sqrt(in_features)
        self.kernel_mu = nn.Parameter(
            torch.empty(in_features, out_features).uniform_(-mu_range, mu_range, generator=generator))
        self.kernel_sigma = nn.Parameter(
            torch.full((in_features, out_features), 0.5 / math.sqrt(in_features)))
        self.bias_mu = nn.Parameter(
            torch.empty(out_features).uniform_(-mu_range, mu_range, generator=generator))
        self.bias_sigma = nn.Parameter(torch.full((out_features,), 0.5 / math.sqrt(out_features)))

    def forward(self, x, eps: tuple[torch.Tensor, torch.Tensor] | None = None):
        if eps is None:
            return x @ self.kernel_mu + self.bias_mu
        eps_in, eps_out = eps
        if eps_in.dim() > 1:  # one draw per row
            y = x @ self.kernel_mu
            y = y + ((x * eps_in) @ self.kernel_sigma) * eps_out
            return y + self.bias_mu + self.bias_sigma * eps_out
        w = self.kernel_mu + self.kernel_sigma * (eps_in[:, None] * eps_out[None, :])
        b = self.bias_mu + self.bias_sigma * eps_out
        return x @ w + b


def noisy_layers(module: nn.Module) -> list[tuple[int, int]]:
    """``(in, out)`` of every ``NoisyDense`` under ``module``, in call order
    (modules are registered in the order their forward calls them)."""
    return [(m.in_features, m.out_features) for m in module.modules()
            if isinstance(m, NoisyDense)]


def linear_layer(in_features: int, out_features: int, noisy: bool,
                 generator: torch.Generator | None = None) -> nn.Module:
    """A ``NoisyDense`` or a kaiming-uniform ``Dense``."""
    if noisy:
        return NoisyDense(in_features, out_features, generator)
    return Dense(in_features, out_features, generator=generator)


def call(module: nn.Module, x, eps: NoiseIter):
    """``module(x)`` with its share of the noise: none for a ``Dense`` or a
    μ-only forward, the next pair for a ``NoisyDense``, the iterator for a
    composite module."""
    if eps is None or isinstance(module, Dense):
        return module(x)
    return module(x, next(eps) if isinstance(module, NoisyDense) else eps)


class LayerNorm(nn.Module):
    """flax's ``LayerNorm``: parameters ``scale`` (ones) and ``bias`` (zeros),
    eps 1e-6 (torch's default is 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return nn.functional.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


class MLP(nn.Module):
    """Linear (+ LayerNorm) + PReLU per layer (reference utils/model.py:26-52).
    ``dims`` excludes the input width; ``linear="noisy"`` makes every layer
    a ``NoisyDense``; the activation follows every layer but the last, and
    the last too with ``last_act``; ``use_norm`` puts a ``LayerNorm``
    (``norm_{i}``) before each activation. (The reference's other
    activations have no caller.)"""

    def __init__(self, in_dim: int, dims: Sequence[int], last_act: bool = False,
                 linear: str = "dense", use_norm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not dims:
            raise ValueError("dims can't be empty")
        if linear not in ("dense", "noisy"):
            raise ValueError(f"linear must be 'dense' or 'noisy', got {linear!r}")
        self.n = len(dims)
        self.last_act, self.use_norm = last_act, use_norm
        for i, feat in enumerate(dims):
            self.add_module(f"layer_{i}", linear_layer(in_dim, feat, linear == "noisy",
                                                       generator))
            if i < self.n - 1 or last_act:
                if use_norm:
                    self.add_module(f"norm_{i}", LayerNorm(feat))
                self.add_module(f"act_{i}", PReLU())
            in_dim = feat
        self.out_dim = in_dim

    def forward(self, x, eps: NoiseIter = None):
        for i in range(self.n):
            x = call(getattr(self, f"layer_{i}"), x, eps)
            if i < self.n - 1 or self.last_act:
                if self.use_norm:
                    x = getattr(self, f"norm_{i}")(x)
                x = getattr(self, f"act_{i}")(x)
        return x


class PSCN(nn.Module):
    """Parallel Split Concatenate Network (reference utils/model.py:256-286):
    ``depth`` one-layer MLPs (with activation) of widths output_dim/2^i;
    each non-final output's first half is emitted and its second half feeds
    the next; the emitted parts and the last output are concatenated."""

    def __init__(self, in_dim: int, output_dim: int, depth: int = 4, linear: str = "dense",
                 generator: torch.Generator | None = None):
        super().__init__()
        if depth < 1 or output_dim % 2 ** (depth - 1):
            raise ValueError(f"output_dim {output_dim} must be divisible by "
                             f"2^(depth-1) for depth {depth} >= 1")
        self.depth = depth
        out_dim = output_dim
        for i in range(depth):
            self.add_module(f"mlp_{i}", MLP(in_dim, [out_dim], last_act=True, linear=linear,
                                            generator=generator))
            in_dim = out_dim // 2
            out_dim //= 2

    def forward(self, x, eps: NoiseIter = None):
        parts = []
        for i in range(self.depth):
            x = getattr(self, f"mlp_{i}")(x, eps)
            if i < self.depth - 1:
                half = x.shape[-1] // 2
                parts.append(x[..., :half])
                x = x[..., half:]
            else:
                parts.append(x)
        return torch.cat(parts, dim=-1)


class RMSNorm(nn.Module):
    """flax's RMS normalization (reference ppo_full_lunarlander.py:273-284):
    ``x · rsqrt(mean(x²) + eps)`` computed in float32, times ``scale``
    (ones at init). Not ``torch.nn.RMSNorm``, whose parameter is named
    ``weight`` and whose default eps differs."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        rms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x32 * rms).to(x.dtype) * self.scale.to(x.dtype)


class Conv(nn.Module):
    """flax's ``nn.Conv`` with ``VALID`` padding on ``[N, H, W, C]``: an OIHW
    ``weight`` (``lecun_normal``, fan-in ``in/groups·kh·kw``) and a zero
    ``bias``. ``groups`` is flax's ``feature_group_count``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int | tuple[int, int],
                 stride: int | tuple[int, int] = 1, groups: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = (kh, kw)
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kh, kw))
        gl_init.lecun_normal()(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def out_hw(self, h: int, w: int) -> tuple[int, int]:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def forward(self, x):
        y = nn.functional.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride,
                                 groups=self.groups)
        return y.permute(0, 2, 3, 1)


class ConvEncoder(nn.Module):
    """The conv trunk for pixel observations, ``[..., H, W, C] → [...,
    features]`` (reference image path, utils/runner.py:57-66): Nature-DQN
    style strided ``Conv`` + ReLU layers (``conv_{i}``), a channels-last
    flatten, ``Dense`` ``proj`` + ReLU. Leading dims are arbitrary, as in
    flax. ``in_shape`` is ``(H, W, C)``: the flatten's width follows from it
    (48×48 → 11 → 4 → 2, so 2·2·32 = 128 for the defaults)."""

    def __init__(self, in_shape: Sequence[int], features: int = 256,
                 channels: Sequence[int] = (16, 32, 32), kernels: Sequence[int] = (8, 4, 3),
                 strides: Sequence[int] = (4, 2, 1), generator: torch.Generator | None = None):
        super().__init__()
        h, w, c = in_shape
        self.n, self.features = len(channels), features
        for i, (ch, k, s) in enumerate(zip(channels, kernels, strides)):
            conv = Conv(c, ch, k, s, generator=generator)
            self.add_module(f"conv_{i}", conv)
            (h, w), c = conv.out_hw(h, w), ch
        self.out_hw = (h, w)
        self.proj = Dense(h * w * c, features, generator=generator)

    def forward(self, x):
        lead = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:]))
        for i in range(self.n):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
        x = torch.relu(self.proj(x.reshape(x.shape[0], -1)))
        return x.reshape(lead + (self.features,))


class DSConv(nn.Module):
    """Depthwise-separable conv (utils/model.py:112-122): a ``depthwise``
    ``Conv`` with one group per input channel, then a 1×1 ``pointwise``."""

    def __init__(self, in_channels: int, features: int, kernel_size: tuple[int, int] = (3, 3),
                 strides: tuple[int, int] = (1, 1), generator: torch.Generator | None = None):
        super().__init__()
        self.depthwise = Conv(in_channels, in_channels, kernel_size, strides, groups=in_channels,
                              generator=generator)
        self.pointwise = Conv(in_channels, features, 1, generator=generator)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class NoisyConv2d(nn.Module):
    """Factorized-Gaussian noisy convolution (utils/model.py:126-184; no
    workload uses it). μ ~ U(±1/√fan_in), σ₀ = 0.5/√fan with fan_in =
    in·kh·kw; HWIO ``kernel_mu``/``kernel_sigma``. ``eps=None`` is the
    μ-only forward; else ``eps = (eps_in[in·kh·kw], eps_out[out])``, one
    ``Noise`` draw of an ``(in·kh·kw, out)`` noisy layer, and the kernel is
    ``μ + σ ∘ (ε_in ⊗ ε_out)`` with ε_in laid out as (kh, kw, in)."""

    def __init__(self, in_channels: int, features: int, kernel_size: tuple[int, int] = (3, 3),
                 strides: tuple[int, int] = (1, 1), sigma_init: float = 0.5,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.stride = tuple(strides)
        self.fan_in, self.features = in_channels * kh * kw, features
        mu_range = 1.0 / math.sqrt(self.fan_in)
        shape = (kh, kw, in_channels, features)
        self.kernel_mu = nn.Parameter(
            torch.empty(shape).uniform_(-mu_range, mu_range, generator=generator))
        self.kernel_sigma = nn.Parameter(torch.full(shape, sigma_init / math.sqrt(self.fan_in)))
        self.bias_mu = nn.Parameter(
            torch.empty(features).uniform_(-mu_range, mu_range, generator=generator))
        self.bias_sigma = nn.Parameter(torch.full((features,), sigma_init / math.sqrt(features)))

    def forward(self, x, eps: tuple[torch.Tensor, torch.Tensor] | None = None):
        if eps is None:
            w, b = self.kernel_mu, self.bias_mu
        else:
            eps_in, eps_out = eps
            w = self.kernel_mu + self.kernel_sigma * (
                eps_in.reshape(self.kernel_mu.shape[:3] + (1,)) * eps_out)
            b = self.bias_mu + self.bias_sigma * eps_out
        y = nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, self.stride)
        return y.permute(0, 2, 3, 1) + b


def positional_encoding(seq_len: int, d_model: int) -> torch.Tensor:
    """Sinusoidal table ``[seq_len, d_model]`` (utils/model.py:189-211),
    computed in numpy float32 as the JAX package computes it."""
    position = np.arange(seq_len)[:, None].astype(np.float32)
    div_term = np.exp(np.arange(0, d_model, 2).astype(np.float32)
                      * (-np.log(10000.0) / d_model))
    pe = np.zeros((seq_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


class MultiHeadAttention(nn.Module):
    """Einsum attention (utils/model.py:215-251; no workload uses it): the
    ``values``/``keys``/``queries`` projections are one bias-free ``Dense``
    of ``head_dim`` shared by the heads, then softmax(q·kᵀ/√head_dim) with
    ``mask == 0`` set to −1e20, and ``fc_out``."""

    def __init__(self, embed_size: int, num_heads: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if embed_size % num_heads:
            raise ValueError(f"embed_size {embed_size} is not a multiple of {num_heads} heads")
        self.embed_size, self.num_heads = embed_size, num_heads
        self.head_dim = hd = embed_size // num_heads
        for name in ("values", "keys", "queries"):
            self.add_module(name, Dense(hd, hd, bias=False, generator=generator))
        self.fc_out = Dense(embed_size, embed_size, generator=generator)

    def forward(self, values, keys, query, mask=None):
        n, hd = query.shape[0], self.head_dim
        values = self.values(values.reshape(n, values.shape[1], self.num_heads, hd))
        keys = self.keys(keys.reshape(n, keys.shape[1], self.num_heads, hd))
        queries = self.queries(query.reshape(n, query.shape[1], self.num_heads, hd))
        energy = torch.einsum("nqhd,nkhd->nhqk", queries, keys)
        if mask is not None:
            energy = torch.where(mask == 0, -1e20, energy)
        attention = torch.softmax(energy / math.sqrt(hd), dim=3)
        out = torch.einsum("nhql,nlhd->nqhd", attention, values)
        return self.fc_out(out.reshape(n, query.shape[1], self.embed_size))


Edge = tuple[str, str, int, int, int]


def mlp_activation_edges(prefix: str, mlp: MLP, after: Sequence[str] = ()) -> list[Edge]:
    """``activation_edges`` of an ``MLP`` named ``prefix``: each layer's
    units pass a PReLU into the next layer, and the last layer's (with
    ``last_act``) into each layer of ``after``."""
    edges = []
    for i in range(mlp.n):
        name = f"{prefix}.layer_{i}"
        nxt = [f"{prefix}.layer_{i + 1}"] if i < mlp.n - 1 else (list(after) if mlp.last_act
                                                                 else [])
        width = getattr(mlp, f"layer_{i}").out_features
        edges.extend((name, c, 0, width, 0) for c in nxt)
    return edges


def pscn_activation_edges(prefix: str, pscn: PSCN, after: Sequence[str]) -> list[Edge]:
    """``activation_edges`` of a ``PSCN`` named ``prefix`` whose output
    feeds each layer of ``after``: block i's emitted half enters them at
    the offset of what the earlier blocks emitted, its other half the next
    block."""
    edges, emitted = [], 0
    for i in range(pscn.depth):
        name = f"{prefix}.mlp_{i}.layer_0"
        width = getattr(pscn, f"mlp_{i}").layer_0.out_features
        half = width // 2 if i < pscn.depth - 1 else width
        edges.extend((name, c, 0, half, emitted) for c in after)
        if half < width:
            edges.append((name, f"{prefix}.mlp_{i + 1}.layer_0", half, width, -half))
        emitted += half
    return edges
