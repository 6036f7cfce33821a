"""mHC — manifold hyper-connections backbone (counterpart of
``gymrl_tpu/nn/mhc.py``; reference algorithms/ppo_full_lunarlander.py:76-267).

A multi-branch residual backbone. Each fuse layer derives, per sample, three
mixing maps from the flattened branch state ``h[B, N, D]``:

  * ``H_pre``  — σ weights pooling the N branches into one vector,
  * ``H_post`` — 2·σ weights broadcasting the transformed vector back out,
  * ``H_res``  — an N×N inter-branch mix projected onto the doubly
    stochastic matrices by Sinkhorn-Knopp. The scaling vectors ``u, v`` are
    computed without gradient and ``u·A·v`` is re-applied differentiably
    through ``A`` (the reference's stop-gradient "recover" trick, :170-177);
    differentiating through the Sinkhorn loop gives other gradients.

β starts identity-favouring (+2 on the H_res diagonal logits, −2 off it),
``w`` at zero and α at 0.01, so the maps start at their β-defined values.

Sinkhorn runs in float32 on ``[B, n, n]`` in the elementwise form: each
matrix-vector product is ``(A · v).sum(-1)`` (n products, then their sum),
not a ``bmm`` of n×n blocks, so the card and the CPU round it alike.

Parameter and submodule names are flax's (``w``, ``alpha``, ``beta``,
``norm_weight``; ``input_proj``, ``block_{i}``, ``mhc{1,2}``,
``linear{1,2}``, ``final_norm``), so ``interop.params_from_flax`` maps them
by name. ``w`` keeps flax's ``[N·D, N²+2N]`` layout. ``input_proj`` and
``linear{i}`` are flax's plain ``nn.Dense`` (``lecun_normal`` kernel, zero
bias), not the reference's kaiming ``Dense``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.layers import Dense, RMSNorm
from gymrl_tpu_torch.utils.profiling import span


def sinkhorn_knopp(A: torch.Tensor, iters: int, eps: float = 1e-8):
    """Project batched non-negative ``[B, n, n]`` onto doubly stochastic
    matrices: ``iters`` rounds of ``u = 1/(A v + eps)``, ``v = 1/(Aᵀ u + eps)``
    from ones. Returns ``(P, u, v)`` with ``P = diag(u) A diag(v)``."""
    A = A.float()
    u = torch.ones(A.shape[:2], device=A.device)
    v = torch.ones(A.shape[:2], device=A.device)
    for _ in range(iters):
        u = 1.0 / ((A * v[:, None, :]).sum(dim=-1) + eps)
        v = 1.0 / ((A * u[:, :, None]).sum(dim=-2) + eps)
    P = u[:, :, None] * A * v[:, None, :]
    return P, u, v


class MHCFuse(nn.Module):
    """One fuse layer: ``h[B, N, D] → (H_pre[B, N], H_post[B, N], H_res[B, N, N])``."""

    def __init__(self, dim: int, rate: int, sk_iters: int = 10):
        super().__init__()
        n = rate
        nc, n2 = n * dim, n * n
        self.rate, self.sk_iters = rate, sk_iters
        self.w = nn.Parameter(torch.zeros(nc, n2 + 2 * n))
        self.alpha = nn.Parameter(torch.full((3,), 0.01))
        beta = torch.zeros(n2 + 2 * n)
        beta[:2 * n] = 0.01
        beta[2 * n:] = (4.0 * torch.eye(n) - 2.0).reshape(-1)  # +2 diagonal, −2 off it
        self.beta = nn.Parameter(beta)
        # the "RMSNorm fused trick": a learnable elementwise scale and an explicit 1/r
        self.norm_weight = nn.Parameter(torch.ones(nc))

    def forward(self, h: torch.Tensor):
        n = self.rate
        b = h.shape[0]
        h_flat = h.reshape(b, -1)
        H = (self.norm_weight * h_flat) @ self.w
        r = torch.linalg.vector_norm(h_flat.float(), dim=-1, keepdim=True) / math.sqrt(
            h_flat.shape[1])
        r_ = 1.0 / (r + 1e-6)
        alpha, beta = self.alpha, self.beta
        H_pre = torch.sigmoid(r_ * H[:, :n] * alpha[0] + beta[:n])
        H_post = 2.0 * torch.sigmoid(r_ * H[:, n:2 * n] * alpha[1] + beta[n:2 * n])
        A = torch.exp((r_ * H[:, 2 * n:] * alpha[2] + beta[2 * n:]).reshape(b, n, n))
        with torch.no_grad(), span("mhc.sinkhorn"):
            _, u, v = sinkhorn_knopp(A, self.sk_iters)
        H_res = u[:, :, None] * A * v[:, None, :]
        return H_pre, H_post, H_res


class MHCBlock(nn.Module):
    """Two rounds of fuse → ``linear{i}`` → SiLU → mix back (ref :197-229)."""

    def __init__(self, dim: int, rate: int, sk_iters: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        lecun = gl_init.lecun_normal()
        for i in (1, 2):
            self.add_module(f"mhc{i}", MHCFuse(dim, rate, sk_iters))
            self.add_module(f"linear{i}", Dense(dim, dim, lecun, generator=generator))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i in (1, 2):
            H_pre, H_post, H_res = getattr(self, f"mhc{i}")(h)
            h_pre = torch.bmm(H_pre[:, None, :], h)[:, 0]  # pool the branches
            h_res = torch.bmm(H_res, h)  # inter-branch mix
            h_out = F.silu(getattr(self, f"linear{i}")(h_pre))
            h = H_post[:, :, None] * h_out[:, None, :] + h_res  # broadcast back
        return h


class MHCBackbone(nn.Module):
    """``input_proj`` → repeat to ``rate`` branches → blocks → branch sum →
    ``RMSNorm(1e-6)`` (ref :232-267). Takes ``[B, in_dim]``."""

    def __init__(self, in_dim: int, output_dim: int, rate: int = 2, num_layers: int = 2,
                 sk_iters: int = 10, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.input_proj = Dense(in_dim, output_dim, gl_init.lecun_normal(), generator=generator)
        for i in range(num_layers):
            self.add_module(f"block_{i}", MHCBlock(output_dim, rate, sk_iters, generator))
        self.num_layers = num_layers
        self.final_norm = RMSNorm(output_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("mhc"):
            h = self.input_proj(x)
            h = h[:, None, :].expand(-1, self.rate, -1)  # [B, N, D]
            for i in range(self.num_layers):
                h = getattr(self, f"block_{i}")(h)
            return self.final_norm(h.sum(dim=1))
