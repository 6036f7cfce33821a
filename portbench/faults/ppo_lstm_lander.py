"""Faults planted in the port's recurrent full-tricks PPO on the lander
underneath a run, to show that the comparison catches them (``calibrate.py``
and the tests; a benchmark run plants none). Each is ``plant(trainer)``,
applied before the trainer's first iteration:

  * ``sinkhorn_once``: every mHC fuse projects its mixing map with one
    Sinkhorn-Knopp round in place of the configuration's ten. From the
    seed's weights (every fuse's ``w`` zero, so every mixing map is the
    same symmetric matrix, which one round already projects) it differs
    from the sound program by rounding alone in a run's first iterations:
    the tests catch it with ``w`` drawn at random;
  * ``detached_mix``: every fuse's mixing map ``H_res`` is applied without
    its gradient, so nothing trains the map's ``w``, ``alpha`` and ``beta``;
  * ``fresh_h0``: the update re-unrolls every chunk from a zero hidden in
    place of the hidden stored at its start;
  * ``no_rnd_reward``: the rollout leaves out the intrinsic reward (the RND
    predictor still trains).

``WITNESSES`` are plants of the same form that keep the maths and change
only how float32 sums are grouped, as a rewrite of the trainer for speed
would: their readings are the sound side of the limits.

  * ``mhc_regrouped``: every fuse scales ``w`` in place of the branches,
    runs its Sinkhorn rounds as batched matrix-vector products and applies
    ``u`` and ``v`` to ``A`` in the other order;
  * ``gru_regrouped``: the GRU cell steps the rollout with its stacked
    maps and re-unrolls the chunks with each gate's maps apart;
  * ``per_tensor_adam``: Adam steps each tensor on its own
    (``flat_optimizer`` off).

One chip: no exchange between chips exists to leave out.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def _on_every_net(trainer, alter) -> None:
    make_net = trainer.make_net

    def made(*args, **kw):
        net = make_net(*args, **kw)
        alter(net)
        return net

    trainer.make_net = made


def sinkhorn_once(trainer) -> None:
    def once(net):
        for m in net.modules():
            if hasattr(m, "sk_iters"):
                m.sk_iters = 1

    _on_every_net(trainer, once)


def _fuse_detached(fuse, h):
    H_pre, H_post, H_res = type(fuse).forward(fuse, h)
    return H_pre, H_post, H_res.detach()


def detached_mix(trainer) -> None:
    def detach(net):
        for m in net.modules():
            if hasattr(m, "sk_iters"):
                m.forward = lambda h, m=m: _fuse_detached(m, h)

    _on_every_net(trainer, detach)


def fresh_h0(trainer) -> None:
    seq_forward = trainer._seq_forward
    trainer._seq_forward = lambda net, h0, obs: seq_forward(net, torch.zeros_like(h0), obs)


def no_rnd_reward(trainer) -> None:
    def no_bonus(net):
        def forward(h, obs):
            predict, _ = net.rnd(obs)
            return (*net.step(h, obs), predict, predict)

        net.forward = forward

    _on_every_net(trainer, no_bonus)


PLANTS = {"sinkhorn_once": sinkhorn_once, "detached_mix": detached_mix,
          "fresh_h0": fresh_h0, "no_rnd_reward": no_rnd_reward}


def _fuse_regrouped(fuse, h):
    """``MHCFuse.forward`` (``gymrl_tpu_torch/nn/mhc.py``) with its sums
    grouped otherwise."""
    n, b = fuse.rate, h.shape[0]
    h_flat = h.reshape(b, -1)
    H = h_flat @ (fuse.norm_weight[:, None] * fuse.w)
    r = torch.linalg.vector_norm(h_flat.float(), dim=-1, keepdim=True) / math.sqrt(
        h_flat.shape[1])
    r_ = 1.0 / (r + 1e-6)
    alpha, beta = fuse.alpha, fuse.beta
    H_pre = torch.sigmoid(r_ * H[:, :n] * alpha[0] + beta[:n])
    H_post = 2.0 * torch.sigmoid(r_ * H[:, n:2 * n] * alpha[1] + beta[n:2 * n])
    A = torch.exp((r_ * H[:, 2 * n:] * alpha[2] + beta[2 * n:]).reshape(b, n, n))
    with torch.no_grad():
        u = torch.ones(b, n, 1, device=A.device)
        v = torch.ones(b, n, 1, device=A.device)
        for _ in range(fuse.sk_iters):
            u = 1.0 / (torch.bmm(A, v) + 1e-8)
            v = 1.0 / (torch.bmm(A.transpose(1, 2), u) + 1e-8)
    return H_pre, H_post, u * (A * v.transpose(1, 2))


def mhc_regrouped(trainer) -> None:
    def regroup(net):
        for m in net.modules():
            if hasattr(m, "sk_iters"):
                m.forward = lambda h, m=m: _fuse_regrouped(m, h)

    _on_every_net(trainer, regroup)


def _gru_stacked_step(cell, h, x):
    H, n_in = cell.features, getattr(cell, "in")
    xg = F.linear(x, torch.cat([cell.ir.weight, cell.iz.weight, n_in.weight]),
                  torch.cat([cell.ir.bias, cell.iz.bias, n_in.bias]))
    hg = F.linear(h, torch.cat([cell.hr.weight, cell.hz.weight, cell.hn.weight]),
                  torch.cat([cell.hn.bias.new_zeros(2 * H), cell.hn.bias]))
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    h = (1.0 - z) * torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:]) + z * h
    return h, h


def _gru_per_gate_unroll(cell, h, xs):
    hs = []
    for t in range(xs.shape[1]):
        h, _ = type(cell).forward(cell, h, xs[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


def gru_regrouped(trainer) -> None:
    def regroup(net):
        for m in net.modules():
            if hasattr(m, "hn"):  # the GRU cell
                m.forward = lambda h, x, m=m: _gru_stacked_step(m, h, x)
                m.unroll = lambda h, xs, m=m: _gru_per_gate_unroll(m, h, xs)

    _on_every_net(trainer, regroup)


def per_tensor_adam(trainer) -> None:
    trainer.cfg = dataclasses.replace(trainer.cfg, flat_optimizer=False)


WITNESSES = {"mhc_regrouped": mhc_regrouped, "gru_regrouped": gru_regrouped,
             "per_tensor_adam": per_tensor_adam}
