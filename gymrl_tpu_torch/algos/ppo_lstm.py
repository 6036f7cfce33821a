"""Recurrent full-tricks PPO with RND (counterpart of
``gymrl_tpu/algos/ppo_lstm.py``), the ``ppo_lstm_lunarlander`` workload.

Algorithm parity with reference algorithms/ppo_lstm_lunarlander.py, as the
JAX trainer has it:
  * network: RND (a predictor and a frozen target, PSCN of width
    ``rnd_embed`` and depth log2(embed/16), on the raw observation) beside
    the mHC backbone (dim 256, rate 2, 2 layers) or PSCN(512, depth 5) →
    URNN cell (GRU or LSTM, hidden 512, one packed hidden vector) → actor
    SiluRMSMLP[512, A] (head gain 0.001) and critic SiluRMSMLP[512, 1]
  * collection: the hidden is recorded BEFORE each forward (the chunks'
    initial hiddens) and after it, before the reset at done; the intrinsic
    reward ``mean((pred − target)²)`` is added to the env reward
  * successor values under the post-step hidden, dual-λ GAE cutting
    bootstrap and trace on ``done``, advantage standardization
  * sequence training: each env column cut into ``seq_len``-step chunks
    (spanning episode boundaries), re-unrolled from the stored hidden at
    the chunk's start; minibatches of 128 sequences
  * loss: the ERC mask through ``masked_mean``, dual-clip variant (b) with
    clip-higher, asymmetric value clipping ``old + clip(v − old, −0.2,
    +0.28)``, entropy 0.015 (annealed with lr), the RND predictor's MSE in
    the total; grad-norm 0.5, Adam(3e-4, eps 1e-5)

The frozen RND target stays in the optimizer: the loss never reads its
parameters, so ``grad_step`` gives them zero gradients, Adam counts its
steps as optax does (the raveled flat-optimizer state lines up) and the
target never moves.

The training re-unroll (``_seq_forward``) runs the RND pair, the backbone,
the cell's input maps and the heads once over all ``mb·L`` steps; only the
cell's hidden side is a loop over L. ``train_iter`` updates the net and
optimizer in place and makes no host sync. On a CUDA device without a mesh,
while ``trainer.graphs`` is on, the T-step rollout and the epoch ×
minibatch sweep are each one replay of a captured CUDA graph
(``Trainer._rollout_route``, ``Trainer._sweep_route``, as ``PPOTrainer``'s),
Adam's step on the ``clip_adam`` kernel after the plain clip; the successor
forward, GAE and the packing run eagerly between them. The
entropy coefficient, annealed every iteration, reaches the captured loss as
a buffer on the card, the lr as ``clip_adam``'s step terms. Every draw
comes from ``ts.noise`` in the reference's order: per rollout step the
action's Gumbels, then the env's draws; then one permutation per epoch,
drawn outside the graphs.

Under a ``mesh`` each data rank steps its share of the envs with their
packed hiddens and computes their successor values and GAE per env column;
the columns the chunks read are gathered, so standardization, the chunks
and the permutations are the unsharded ones. Each rank takes its share of
each minibatch; the ERC mask depends on the current policy, so its masked
means sum their active counts over ``data``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from gymrl_tpu_torch.algos.base import (
    IterOut, PhaseTimer, RecurrentTrainer, RolloutGraph, SeqRolloutSizes, SweepGraph, adam,
    assert_flat_tp_ok, masked_mean, pack_fields, to_chunks,
)
from gymrl_tpu_torch.algos.ppo import categorical_logp_entropy, gumbel_sample, pick_action
from gymrl_tpu_torch.algos.ppo_full import SiluRMSMLP, annealed
from gymrl_tpu_torch.core.gae import compute_gae_dual_lambda, standardize
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.nn.layers import PSCN, Edge, pscn_activation_edges
from gymrl_tpu_torch.nn.mhc import MHCBackbone
from gymrl_tpu_torch.nn.recurrent import LSTMCell, URNNCell
from gymrl_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class PPOLSTMConfig(SeqRolloutSizes):
    env_name: str = "LunarLander-v3"
    num_envs: int = 64
    rollout_steps: int = 64  # T·B = 4096 (reference update_freq)
    seq_len: int = 8
    seq_minibatch: int = 128  # sequences per minibatch
    num_epochs: int = 4
    gamma: float = 0.995
    lam_actor: float = 0.95
    lam_critic: float = 0.95
    clip_eps_min: float = 0.2
    clip_eps_max: float = 0.28
    dual_clip: float = 3.0
    entropy_coef: float = 0.015
    erc_beta_low: float = 0.06
    erc_beta_high: float = 0.06
    lr: float = 3e-4
    adam_eps: float = 1e-5
    max_grad_norm: float = 0.5
    anneal: bool = True
    use_mhc: bool = True
    mhc_dim: int = 256
    mhc_rate: int = 2
    mhc_layers: int = 2
    mhc_sk_it: int = 10
    rnn_hidden: int = 512
    rnn_cell: str = "gru"  # 'gru' | 'lstm'
    rnd_embed: int = 512
    # One Adam over all parameters as one multi-tensor ("foreach") update,
    # the counterpart of the reference's Adam over one raveled vector.
    flat_optimizer: bool = False
    # The reference's lax.scan unroll of the cell recurrence. Accepted so
    # configs carry over; it changes nothing here (the loop is a Python loop).
    cell_unroll: int = 1
    max_train_steps: int = 5_000_000
    solve_threshold: float = 200.0


class RNDPair(nn.Module):
    """Random network distillation (ref :494-513): a ``predictor`` and a
    frozen ``target``, each PSCN(``embed_dim``, depth log2(embed/16)).
    ``forward(x) -> (predict, target)``; the target runs without gradient."""

    def __init__(self, in_dim: int, embed_dim: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        depth = int(math.log2(embed_dim // 16))
        self.predictor = PSCN(in_dim, embed_dim, depth=depth, generator=generator)
        self.target = PSCN(in_dim, embed_dim, depth=depth, generator=generator)

    def forward(self, x):
        with span("rnd"):
            with torch.no_grad():
                target = self.target(x)
            return self.predictor(x), target


class LSTMActorCritic(nn.Module):
    """RND + backbone + URNN cell + heads (ref :446-520), one step at a time:
    ``forward(h, obs) -> (h', logits, value, predict, target)``; ``step`` is
    the same without the RND pair. ``encode`` (the backbone, ``[n, obs]``),
    ``cell``, ``heads`` and ``rnd`` are the training re-unroll's pieces.
    Submodule names are the flax module's (``shared``, ``rnn``, ``actor``,
    ``critic``, ``rnd``), so weights map across by name."""

    def __init__(self, obs_dim: int, n_actions: int, cfg: PPOLSTMConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, c = generator, cfg
        if c.use_mhc:
            self.shared = MHCBackbone(obs_dim, c.mhc_dim, c.mhc_rate, c.mhc_layers, c.mhc_sk_it, g)
        else:
            self.shared = PSCN(obs_dim, 512, depth=5, generator=g)
        self.rnn = URNNCell(c.mhc_dim if c.use_mhc else 512, c.rnn_hidden, c.rnn_cell, g)
        self.actor = SiluRMSMLP(c.rnn_hidden, (512, n_actions), last_std=0.001, generator=g)
        self.critic = SiluRMSMLP(c.rnn_hidden, (512, 1), last_std=1.0, generator=g)
        self.rnd = RNDPair(obs_dim, c.rnd_embed, g)
        self.packed_hidden = self.rnn.packed_size

    def forward(self, h, obs):
        predict, target = self.rnd(obs)
        return (*self.step(h, obs), predict, target)

    def step(self, h, obs):
        h, out = self.cell(h, self.encode(obs))
        return (h, *self.heads(out))

    def encode(self, obs):
        return self.shared(obs)

    def cell(self, h, x):
        return self.rnn(h, x)

    def heads(self, out):
        """Actor logits and critic value of cell outputs (any leading shape)."""
        return self.actor(out), self.critic(out).squeeze(-1)

    def activation_edges(self) -> list[Edge]:
        """The PReLU kinks (``QNet.activation_edges``' form): the PSCN
        fallback's units enter the cell's input maps; each RND PSCN's blocks
        feed only its next block (no layer reads its output, the RND loss's)."""
        edges = []
        if isinstance(self.shared, PSCN):
            kind = self.rnn.cell_type
            maps = [f"i{k}" for k in LSTMCell.GATES] if kind == "lstm" else ["ir", "iz", "in"]
            edges += pscn_activation_edges("shared", self.shared, [f"rnn.{kind}.{m}" for m in maps])
        for name in ("predictor", "target"):
            edges += pscn_activation_edges(f"rnd.{name}", getattr(self.rnd, name), [])
        return edges


class LSTMTrainState(NamedTuple):
    params: LSTMActorCritic  # its parameters are the f32 master weights
    opt_state: torch.optim.Adam
    vec_state: VecState
    hidden: torch.Tensor  # f32[B, packed] — the URNN carry of each env
    noise: Noise  # the reference's `key`
    env_steps: int


class LSTMRollout(NamedTuple):
    obs: torch.Tensor  # f32[T, B, obs]
    action: torch.Tensor  # i32[T, B]
    logp: torch.Tensor
    value: torch.Tensor
    entropy: torch.Tensor  # ERC's reference entropies
    reward: torch.Tensor  # env reward + RND intrinsic reward
    next_obs: torch.Tensor  # f32[T, B, obs] — true successor
    h_pre: torch.Tensor  # f32[T, B, packed] — hidden BEFORE the step
    h_post: torch.Tensor  # f32[T, B, packed] — hidden AFTER the step, before the reset
    done: torch.Tensor  # f32[T, B]


class PPOLSTMTrainer(RecurrentTrainer):
    def __init__(self, cfg: PPOLSTMConfig, device: str | torch.device = "cuda", mesh=None):
        if cfg.flat_optimizer:
            assert_flat_tp_ok(mesh)
        super().__init__(cfg, device, mesh)
        self._check_split(cfg.seqs_per_rollout // cfg.num_minibatches, "seq_minibatch")
        self.venv = make_vec(cfg.env_name, self.local_envs)
        self.obs_dim = self.venv.env.obs_dim
        self.n_actions = self.venv.env.n_actions
        self.rollout_graph: RolloutGraph | None = None  # made at the first rollout it runs
        self.sweep_graph: SweepGraph | None = None  # made at the first sweep it runs

    def make_net(self, generator: torch.Generator | None = None) -> LSTMActorCritic:
        return LSTMActorCritic(self.obs_dim, self.n_actions, self.cfg, generator)

    # -- API ------------------------------------------------------------------
    def init(self, seed: int = 0) -> LSTMTrainState:
        """Fresh state. Params come from a CPU generator seeded ``seed`` (the
        same weights on every device); env and training noise from a
        generator on the trainer's device."""
        cfg, dev = self.cfg, self.device
        net = self.make_net(torch.Generator().manual_seed(seed)).to(dev)
        noise = self._noise(seed)
        return LSTMTrainState(
            params=net,
            opt_state=adam(list(net.parameters()), cfg.lr, cfg.adam_eps,
                           foreach=cfg.flat_optimizer),
            vec_state=self.venv.reset(noise),
            hidden=torch.zeros(self.local_envs, net.packed_hidden, device=dev),
            noise=noise,
            env_steps=0,
        )

    def policy_reset(self, batch: int) -> torch.Tensor:
        """A fresh packed hidden for ``batch`` episodes."""
        size = self.cfg.rnn_hidden * (2 if self.cfg.rnn_cell == "lstm" else 1)
        return torch.zeros(batch, size, device=self.device)

    @torch.no_grad()
    def policy_step(self, ts: LSTMTrainState, carry, obs, noise, deterministic: bool = True):
        """One step threading the packed hidden: returns ``(h', action)``."""
        h, logits, _ = ts.params.step(carry, obs)
        return h, pick_action(logits, noise, deterministic)

    def train_iter(self, ts: LSTMTrainState,
                   timer: PhaseTimer | None = None) -> tuple[LSTMTrainState, IterOut]:
        """One iteration; updates ``ts.params`` / ``ts.opt_state`` in place.
        ``timer``, if given, is called with "rollout", "gae" (successor
        values, dual-λ GAE and the packed chunks) and "sgd" as each phase ends.
        With ``utils.profiling``'s tracing on, the iteration is a
        ``train_iter`` span, and its ``rollout``, ``gae`` and ``sgd`` spans
        each close just before their phase's ``timer`` call, as
        ``PPOTrainer``'s do. On the graph route the returned ``vec_state``
        and ``hidden`` are the graph's carry (``_rollout_route``), every
        reader of the rollout in the graph's pool (the successor forward,
        GAE, ``_chunks``, ``pack_fields``) runs within this iteration, and
        the sweep is one replay (``_sgd``)."""
        cfg = self.cfg
        mark = timer or (lambda phase: None)
        with span("train_iter"):
            (vec_state, hidden), roll, stats = self._collect(ts)
            mark("rollout")
            with torch.no_grad(), span("gae"):
                # successor values under the post-step hidden, one batched step
                packed_h = roll.h_post.shape[-1]
                _, _, next_values = ts.params.step(roll.h_post.reshape(-1, packed_h),
                                                   roll.next_obs.reshape(-1, self.obs_dim))
                adv, returns = compute_gae_dual_lambda(
                    roll.reward, roll.value, next_values.reshape(roll.value.shape),
                    roll.done, roll.done, cfg.gamma, cfg.lam_actor, cfg.lam_critic,
                )
                # every rank's env columns, in rank order: the unsharded rollout
                roll, adv, returns, stats = self._gather(
                    (roll._replace(next_obs=None, h_post=None), adv, returns, stats), axis=1)
                packed, spec = pack_fields(self._chunks(roll, standardize(adv), returns))
            mark("gae")

            with span("sgd"):
                lr, ent_coef = annealed(cfg, ts.env_steps)
                for group in ts.opt_state.param_groups:
                    group["lr"] = lr
                perms = ts.noise.permutations(cfg.num_epochs, packed.shape[0])
                metrics = self._sgd(ts, packed, spec, perms, ent_coef)
            mark("sgd")

            new_ts = ts._replace(vec_state=vec_state, hidden=hidden,
                                 env_steps=ts.env_steps + cfg.batch_total)
            return new_ts, self._iter_out(stats, metrics, lr=lr, ent_coef=ent_coef)

    # -- internals ------------------------------------------------------------
    def _collect(self, ts: LSTMTrainState):
        """The T-step rollout (``_rollout_route``): ``((vec_state, hidden),
        LSTMRollout, (final_return, final_length, done))``. The net is called
        as a module, so an instance's own ``forward`` is what runs (and what a
        capture records)."""

        def step(carry):
            vec_state, h_pre = carry
            obs = vec_state.obs
            with span("policy"):
                h_post, logits, value, predict, target = ts.params(h_pre, obs)
                action, logp, entropy = gumbel_sample(logits, ts.noise)
            vec_state, tr = self.venv.step(vec_state, action, ts.noise)
            rnd_reward = torch.square(predict - target).mean(dim=-1)
            hidden = torch.where(tr.done[:, None], 0.0, h_post)  # a new episode starts fresh
            roll = LSTMRollout(obs=obs, action=action, logp=logp, value=value, entropy=entropy,
                               reward=tr.reward + rnd_reward, next_obs=tr.next_obs, h_pre=h_pre,
                               h_post=h_post, done=tr.done.float())
            return (vec_state, hidden), (roll, (tr.final_return, tr.final_length, tr.done))

        return self._rollout_route(ts.params, ts.noise, (ts.vec_state, ts.hidden), step)

    def _sgd(self, ts: LSTMTrainState, packed: torch.Tensor, spec: dict, perms: torch.Tensor,
             ent_coef: float) -> dict[str, torch.Tensor]:
        """Epochs of shuffled minibatches (``_epochs``); returns the metrics
        averaged over every grad step. On a CUDA device without a mesh, while
        ``graphs`` is on, the sweep is one replay of a captured CUDA graph
        (``_sweep_route``, ``SweepGraph``), as ``PPOTrainer``'s: the packed
        rows, the permutations and the entropy coefficient, a 0-d float32
        tensor the loss reads, are the graph's inputs, copied in before each
        replay, and the group's lr reaches ``clip_adam`` through its step
        terms. Else eager."""
        ent_coef = torch.full((), ent_coef, dtype=torch.float32, device=self.device)
        return self._sweep_route(
            ts, lambda x: self._epochs(ts, x["packed"], spec, x["perms"],
                                       lambda net, mb: self._loss(net, mb, x["ent_coef"])),
            {"packed": packed, "perms": perms, "ent_coef": ent_coef})

    def _chunks(self, roll: LSTMRollout, adv, returns) -> dict[str, torch.Tensor]:
        """The training sequences: each env column cut into ``seq_len``-step
        chunks (``to_chunks``), with the stored hidden at each chunk's start."""
        to_seq = functools.partial(to_chunks, seq_len=self.cfg.seq_len)
        return {"obs": to_seq(roll.obs), "action": to_seq(roll.action),
                "logp": to_seq(roll.logp), "old_entropy": to_seq(roll.entropy),
                "old_value": to_seq(roll.value), "adv": to_seq(adv), "ret": to_seq(returns),
                "h0": to_seq(roll.h_pre)[:, 0]}

    def _seq_forward(self, net: LSTMActorCritic, h0, obs_seq):
        """Logits ``[mb, L, A]``, values ``[mb, L]`` and the RND pair's
        outputs ``[mb, L, E]`` of the re-unroll from ``h0``."""
        mb, L = obs_seq.shape[:2]
        flat = obs_seq.reshape(mb * L, -1)
        predict, target = net.rnd(flat)
        outs, _ = net.rnn.unroll(h0, net.encode(flat).reshape(mb, L, -1))
        logits, values = net.heads(outs)
        return logits, values, predict.reshape(mb, L, -1), target.reshape(mb, L, -1)

    def _loss(self, net, mb: dict, ent_coef: float | torch.Tensor):
        """The minibatch loss and its metrics. ``ent_coef`` is a float, or
        from ``_sgd`` a 0-d float32 tensor: the same product."""
        cfg = self.cfg
        logits, values, predict, target = self._seq_forward(net, mb["h0"], mb["obs"])
        logp, entropy = categorical_logp_entropy(logits, mb["action"])
        entropy_ratio = entropy / (mb["old_entropy"] + 1e-8)
        corr = ((entropy_ratio > 1.0 - cfg.erc_beta_low)
                & (entropy_ratio < 1.0 + cfg.erc_beta_high)).float()

        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        surr1 = torch.clamp(ratio, 0.0, cfg.dual_clip) * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_eps_min, 1.0 + cfg.clip_eps_max) * adv
        policy_loss = masked_mean(-torch.minimum(surr1, surr2), corr, mesh=self.mesh)
        # value clipping, asymmetric like the ratio clip (ref :763-770)
        old = mb["old_value"]
        v_clip = old + torch.clamp(values - old, -cfg.clip_eps_min, cfg.clip_eps_max)
        vl = torch.maximum(torch.square(values - mb["ret"]), torch.square(v_clip - mb["ret"]))
        value_loss = 0.5 * masked_mean(vl, corr, mesh=self.mesh)
        entropy_term = masked_mean(entropy, corr, mesh=self.mesh)
        rnd_loss = torch.square(predict - target).mean()
        loss = policy_loss + value_loss - ent_coef * entropy_term + rnd_loss
        clipped = (ratio < 1.0 - cfg.clip_eps_min) | (ratio > 1.0 + cfg.clip_eps_max)
        return loss, {
            "policy_loss": policy_loss, "value_loss": value_loss,
            "entropy": entropy_term, "rnd_loss": rnd_loss,
            "approx_kl": (mb["logp"] - logp).mean(),
            "clip_frac": masked_mean(clipped.float(), corr, mesh=self.mesh),
            "erc_clip_frac": 1.0 - corr.mean(),
        }
