"""Full-tricks PPO (counterpart of ``gymrl_tpu/algos/ppo_full.py``), the
``ppo_full_lunarlander`` workload.

Algorithm parity with reference algorithms/ppo_full_lunarlander.py, as the
JAX trainer has it:
  * mHC backbone (dim 128, rate 2, 2 layers, 10 Sinkhorn iterations) or the
    PSCN(256, depth 4) fallback; SiLU MLP heads with RMSNorm between layers,
    head gains 0.001 (actor) and 1.0 (critic)
  * rollout 64 envs × 64 steps, 4 epochs, minibatch 1024, γ 0.995
  * decoupled-λ GAE; this variant cuts bootstrap AND trace on ``done``
    (truncation too)
  * clip-higher ``[1−0.2, 1+0.28]`` and dual-clip variant (b): surr1 from the
    ratio clamped to ``[0, 3]``
  * ERC: an entropy-ratio mask against the rollout's entropies (β 0.06),
    multiplied into plain means of the policy, value and entropy terms
  * clip-cov: covariance-based sample dropping, off by default
    (``clip_cov_ratio`` 0), kept for parity (``cov_drop_mask``)
  * value loss ``0.5·corr·(v−ret)²``, no value clipping
  * lr AND entropy coefficient annealed with env-step progress
  * Adam with optax's default eps, 1e-8

``train_iter`` runs eagerly and updates the net and optimizer held by the
state in place, with no host sync. Every draw comes from ``ts.noise`` in the
reference's order: per rollout step the action's Gumbels, then the env's
draws; then one permutation per epoch; then, only when ``clip_cov_ratio >
0``, one uniform per sample of each minibatch (``Noise.cov_uniforms``).

Under a ``mesh`` each data rank steps its share of the envs and computes
their successor values and GAE per env column; the columns are gathered, so
standardization, the packed rows and the permutations are the unsharded
ones. clip-cov's mask is a function of the whole minibatch (its means and
its ranking), so every rank computes it over the whole minibatch before it
takes its share; the plain means of the loss average over ``data``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gymrl_tpu_torch.algos.base import (
    IterOut, PhaseTimer, RolloutSizes, Trainer, adam, assert_flat_tp_ok, grad_step, pack_fields,
    rollout_scan, sweep, unpack_fields,
)
from gymrl_tpu_torch.algos.ppo import categorical_logp_entropy, gumbel_sample, pick_action
from gymrl_tpu_torch.core.gae import compute_gae_dual_lambda, standardize
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.layers import PSCN, Dense, Edge, RMSNorm, pscn_activation_edges
from gymrl_tpu_torch.nn.mhc import MHCBackbone


@dataclass(frozen=True)
class PPOFullConfig(RolloutSizes):
    env_name: str = "LunarLander-v3"
    num_envs: int = 64
    rollout_steps: int = 64  # T·B = 4096 (reference update_freq)
    num_epochs: int = 4
    minibatch_size: int = 1024
    gamma: float = 0.995
    lam_actor: float = 0.95
    lam_critic: float = 0.95
    clip_eps_min: float = 0.2
    clip_eps_max: float = 0.28  # clip-higher
    dual_clip: float = 3.0
    clip_cov_ratio: float = 0.0  # clip-cov off by default
    clip_cov_min: float = 1.0
    clip_cov_max: float = 5.0
    entropy_coef: float = 0.01
    erc_beta_low: float = 0.06
    erc_beta_high: float = 0.06
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    anneal: bool = True
    # backbone
    use_mhc: bool = True
    mhc_dim: int = 128
    mhc_rate: int = 2
    mhc_layers: int = 2
    mhc_sk_it: int = 10
    # One Adam over all parameters as one multi-tensor ("foreach") update,
    # the counterpart of the reference's Adam over one raveled vector.
    flat_optimizer: bool = False
    max_train_steps: int = 5_000_000
    solve_threshold: float = 200.0

    @property
    def num_minibatches(self) -> int:
        mb = min(self.minibatch_size, self.batch_total)
        if self.batch_total % mb:
            raise ValueError(f"T·B={self.batch_total} must divide by minibatch {mb}")
        return self.batch_total // mb


def annealed(cfg, env_steps: int) -> tuple[float, float]:
    """``(lr, entropy coefficient)`` for an iteration starting at
    ``env_steps``: both scaled by ``1 − progress`` when ``cfg.anneal``,
    computed in float32 as the reference computes them."""
    lr, ent = np.float32(cfg.lr), np.float32(cfg.entropy_coef)
    if cfg.anneal:
        progress = np.clip(np.float32(env_steps) / np.float32(cfg.max_train_steps),
                           np.float32(0.0), np.float32(1.0))
        lr, ent = lr * (np.float32(1.0) - progress), ent * (np.float32(1.0) - progress)
    return float(lr), float(ent)


def cov_drop_mask(u: torch.Tensor, covs: torch.Tensor, ratio: float, cov_min: float,
                  cov_max: float) -> torch.Tensor:
    """clip-cov keep mask (float32 ``[n]``): drop EXACTLY
    ``min(max(int(n_in·ratio), 1), n_in)`` of the ``n_in`` samples whose
    covariance lies in ``(cov_min, cov_max)``, chosen by the uniforms ``u``:
    in-band samples score ``u``, the others ``inf``; a stable argsort ranks
    them and the ``num_drop`` lowest ranks are zeroed."""
    n = covs.shape[0]
    in_band = (covs > cov_min) & (covs < cov_max)
    n_in = in_band.sum().to(torch.int32)
    num_drop = torch.minimum(torch.clamp((n_in.float() * ratio).to(torch.int32), min=1), n_in)
    scores = torch.where(in_band, u, torch.inf)
    order = torch.argsort(scores, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=covs.device))
    return torch.where(rank < num_drop, 0.0, 1.0)


class SiluRMSMLP(nn.Module):
    """ppo_full's MLP (ref :287-318): ``fc{i}`` (orthogonal √2) → SiLU →
    ``norm{i}`` (RMSNorm, eps 1e-6) between layers; the last layer's
    orthogonal gain is ``last_std`` when given."""

    def __init__(self, in_dim: int, dims, last_std: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n = len(dims)
        for i, feat in enumerate(dims):
            last = i == self.n - 1
            gain = last_std if (last and last_std) else math.sqrt(2.0)
            self.add_module(f"fc{i}", Dense(in_dim, feat, gl_init.orthogonal(gain),
                                            generator=generator))
            if not last:
                self.add_module(f"norm{i}", RMSNorm(feat, eps=1e-6))
            in_dim = feat

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1:
                x = getattr(self, f"norm{i}")(F.silu(x))
        return x


class FullActorCritic(nn.Module):
    """Backbone ``shared`` → ``actor`` SiluRMSMLP[256, A] and ``critic``
    SiluRMSMLP[256, 1] (ref :378-389). ``forward(obs) -> (logits, value)``.
    Submodule names are the flax module's, so weights map across by name."""

    def __init__(self, obs_dim: int, n_actions: int, use_mhc: bool = True, mhc_dim: int = 128,
                 mhc_rate: int = 2, mhc_layers: int = 2, mhc_sk_it: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        if use_mhc:
            self.shared = MHCBackbone(obs_dim, mhc_dim, mhc_rate, mhc_layers, mhc_sk_it, g)
        else:
            self.shared = PSCN(obs_dim, 256, depth=4, generator=g)
        feat = mhc_dim if use_mhc else 256
        self.actor = SiluRMSMLP(feat, (256, n_actions), last_std=0.001, generator=g)
        self.critic = SiluRMSMLP(feat, (256, 1), last_std=1.0, generator=g)

    def forward(self, x):
        feat = self.shared(x)
        return self.actor(feat), self.critic(feat).squeeze(-1)

    def activation_edges(self) -> list[Edge]:
        """The PReLU kinks (``QNet.activation_edges``' form): only the PSCN
        fallback has any; its units enter both heads' first layers."""
        if isinstance(self.shared, PSCN):
            return pscn_activation_edges("shared", self.shared, ["actor.fc0", "critic.fc0"])
        return []


class FullTrainState(NamedTuple):
    params: FullActorCritic  # its parameters are the f32 master weights
    opt_state: torch.optim.Adam
    vec_state: VecState
    noise: Noise  # the reference's `key`
    env_steps: int


class FullRollout(NamedTuple):
    obs: torch.Tensor  # f32[T, B, obs]
    action: torch.Tensor  # i32[T, B]
    logp: torch.Tensor
    value: torch.Tensor
    entropy: torch.Tensor  # the rollout's entropies, ERC's reference
    reward: torch.Tensor
    next_obs: torch.Tensor  # f32[T, B, obs] — true successor
    done: torch.Tensor  # f32[T, B] — cuts bootstrap and trace


class PPOFullTrainer(Trainer):
    def __init__(self, cfg: PPOFullConfig, device: str | torch.device = "cuda", mesh=None):
        if cfg.flat_optimizer:
            assert_flat_tp_ok(mesh)
        super().__init__(cfg, device, mesh)
        self._check_split(cfg.batch_total // cfg.num_minibatches, "minibatch_size")
        self.venv = make_vec(cfg.env_name, self.local_envs)
        self.obs_dim = self.venv.env.obs_dim
        self.n_actions = self.venv.env.n_actions

    def make_net(self, generator: torch.Generator | None = None) -> FullActorCritic:
        c = self.cfg
        return FullActorCritic(self.obs_dim, self.n_actions, c.use_mhc, c.mhc_dim, c.mhc_rate,
                               c.mhc_layers, c.mhc_sk_it, generator)

    # -- API ------------------------------------------------------------------
    def init(self, seed: int = 0) -> FullTrainState:
        """Fresh state. Params come from a CPU generator seeded ``seed`` (the
        same weights on every device); env and training noise from a
        generator on the trainer's device."""
        net = self.make_net(torch.Generator().manual_seed(seed)).to(self.device)
        noise = self._noise(seed)
        return FullTrainState(
            params=net,
            opt_state=adam(list(net.parameters()), self.cfg.lr, 1e-8,
                           foreach=self.cfg.flat_optimizer),
            vec_state=self.venv.reset(noise),
            noise=noise,
            env_steps=0,
        )

    @torch.no_grad()
    def policy(self, ts: FullTrainState, obs, noise, deterministic: bool = True):
        logits, _ = ts.params(obs)
        return pick_action(logits, noise, deterministic)

    def train_iter(self, ts: FullTrainState,
                   timer: PhaseTimer | None = None) -> tuple[FullTrainState, IterOut]:
        """One iteration; updates ``ts.params`` / ``ts.opt_state`` in place.
        ``timer``, if given, is called with "rollout", "gae" (successor
        values, dual-λ GAE and the packed rows) and "sgd" as each phase ends."""
        cfg = self.cfg
        mark = timer or (lambda phase: None)
        vec_state, roll, stats = self._collect(ts)
        mark("rollout")
        n = cfg.batch_total
        with torch.no_grad():
            # successor values in one batched forward; done cuts them anyway
            _, next_values = ts.params(roll.next_obs.reshape(-1, self.obs_dim))
            adv, returns = compute_gae_dual_lambda(
                roll.reward, roll.value, next_values.reshape(roll.value.shape),
                roll.done, roll.done, cfg.gamma, cfg.lam_actor, cfg.lam_critic,
            )
            # every rank's env columns, in rank order: the unsharded rollout
            roll, adv, returns, stats = self._gather(
                (roll._replace(next_obs=None), adv, returns, stats), axis=1)
            packed, spec = pack_fields({
                "obs": roll.obs.reshape(n, -1), "action": roll.action.reshape(n),
                "logp": roll.logp.reshape(n), "old_entropy": roll.entropy.reshape(n),
                "adv": standardize(adv).reshape(n), "ret": returns.reshape(n),
            })
        mark("gae")

        lr, ent_coef = annealed(cfg, ts.env_steps)
        for group in ts.opt_state.param_groups:
            group["lr"] = lr
        metrics = self._sgd(ts, packed, spec, ent_coef)
        mark("sgd")

        new_ts = ts._replace(vec_state=vec_state, env_steps=ts.env_steps + n)
        return new_ts, self._iter_out(stats, metrics, lr=lr, ent_coef=ent_coef)

    # -- internals ------------------------------------------------------------
    @torch.no_grad()
    def _collect(self, ts: FullTrainState):
        """The T-step rollout (``rollout_scan``, eager): ``(vec_state,
        FullRollout, (final_return, final_length, done))``."""

        def step(vec_state):
            obs = vec_state.obs
            logits, value = ts.params(obs)
            action, logp, entropy = gumbel_sample(logits, ts.noise)
            vec_state, tr = self.venv.step(vec_state, action, ts.noise)
            roll = FullRollout(obs=obs, action=action, logp=logp, value=value, entropy=entropy,
                               reward=tr.reward, next_obs=tr.next_obs, done=tr.done.float())
            return vec_state, (roll, (tr.final_return, tr.final_length, tr.done))

        vec_state, (roll, stats) = rollout_scan(step, ts.vec_state, self.cfg.rollout_steps)
        return vec_state, roll, stats

    def _sgd(self, ts: FullTrainState, packed: torch.Tensor, spec: dict,
             ent_coef: float) -> dict[str, torch.Tensor]:
        """Epochs of shuffled minibatches (``sweep``), each with its clip-cov
        mask (all ones when clip-cov is off); returns the metrics averaged
        over every gradient step."""
        cfg = self.cfg
        n_mb = cfg.num_minibatches
        mb_size = cfg.batch_total // n_mb
        perms = ts.noise.permutations(cfg.num_epochs, cfg.batch_total)
        cov_u = (ts.noise.cov_uniforms(cfg.num_epochs, n_mb, mb_size)
                 if cfg.clip_cov_ratio > 0 else None)

        def step(epoch, i, rows):
            mb = unpack_fields(rows, spec)
            mb["cov_keep"] = (torch.ones(mb_size, device=rows.device) if cov_u is None
                              else cov_drop_mask(cov_u[epoch, i], self._covs(ts.params, mb),
                                                 cfg.clip_cov_ratio, cfg.clip_cov_min,
                                                 cfg.clip_cov_max))
            return self._grad_step(ts, mb, ent_coef)

        return sweep(packed, perms, n_mb, step)

    @torch.no_grad()
    def _covs(self, net, mb: dict) -> torch.Tensor:
        """clip-cov's per-sample covariances of a minibatch (ref :608-612): the
        current log-probs' and the advantages' deviations from their means."""
        logits, _ = net(mb["obs"])
        lp, _ = categorical_logp_entropy(logits, mb["action"])
        return (lp - lp.mean()) * (mb["adv"] - mb["adv"].mean())

    def _grad_step(self, ts: FullTrainState, mb: dict, ent_coef: float) -> dict[str, torch.Tensor]:
        """One clipped Adam step on the minibatch ``mb`` (this rank's share
        of it under a mesh)."""
        return grad_step(ts.params, ts.opt_state, lambda net, m: self._loss(net, m, ent_coef),
                         self._share(mb), self.cfg.max_grad_norm, self.mesh)

    def _loss(self, net, mb: dict, ent_coef: float):
        cfg = self.cfg
        logits, values = net(mb["obs"])
        logp, entropy = categorical_logp_entropy(logits, mb["action"])
        # ERC mask (ref :585-597); clip-cov's dropping folds in here
        entropy_ratio = entropy / (mb["old_entropy"] + 1e-8)
        erc_mask = ((entropy_ratio > 1.0 - cfg.erc_beta_low)
                    & (entropy_ratio < 1.0 + cfg.erc_beta_high)).float()
        corr = erc_mask * mb["cov_keep"]

        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        # dual-clip variant (b): surr1 from the ratio clamped to [0, dual_clip]
        surr1 = torch.clamp(ratio, 0.0, cfg.dual_clip) * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_eps_min, 1.0 + cfg.clip_eps_max) * adv
        policy_loss = (-torch.minimum(surr1, surr2) * corr).mean()
        value_loss = (0.5 * corr * torch.square(values - mb["ret"])).mean()
        entropy_term = (entropy * corr).mean()
        loss = policy_loss + value_loss - ent_coef * entropy_term
        clipped = (ratio < 1.0 - cfg.clip_eps_min) | (ratio > 1.0 + cfg.clip_eps_max)
        return loss, {
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy_term,
            "approx_kl": (mb["logp"] - logp).mean(),
            "clip_frac": (clipped.float() * corr).mean(),
            "erc_clip_frac": 1.0 - erc_mask.mean(),
        }
