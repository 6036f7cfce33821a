"""Recurrent PPO with a GRU (counterpart of ``gymrl_tpu/algos/ppo_rnn.py``),
the ``ppo_rnn_lunarlander`` and ``ppo_rnn_flappybird`` workloads.

Algorithm parity with reference algorithms/ppo_rnn_lunarlander.py,
unchanged from the JAX trainer:
  * network: PSCN(obs → F) → MLPRNN(F → F, GRU hidden F/4) → actor
    MLP[64, A] (softmax) and critic MLP[32, 1], PReLU, kaiming init
  * observation normalization and divide-only reward scaling (reset per
    episode) applied during collection; the hidden is zeroed at dones
  * the successor value is computed under the ADVANCED hidden: one batched
    one-step forward over the stored post-step hiddens
  * GAE with the terminated/done distinction, per-iteration advantage
    standardization
  * masked dual-clip 3.0 policy loss, value MSE ·0.5, entropy 1e-2,
    grad-norm clip 0.5, Adam(1e-3, eps 1e-5), 10 epochs

Two training layouts, as in the JAX package:
  * chunks (``whole_episode_bptt=False``): fixed ``seq_len``-step slices of
    each env column, each re-unrolled from the hidden stored at its start
    (truncated BPTT across episode boundaries);
  * whole episodes (the presets): every episode segment of the rollout in
    its own padded row (``replay/episode.episode_buffer_pack``), re-unrolled
    from its true first hidden (zero for a fresh episode, the carried one
    for each column's continuation row) under a masked loss. Segments past
    ``episode_rows_per_env`` per column are dropped and counted
    (``dropped_steps`` / ``dropped_episodes`` metrics).

The training re-unroll (``_seq_forward``) runs the PSCN trunk, the GRU's
input maps and the heads once over all ``mb·L`` steps; only the GRU's
hidden recurrence is a loop over L. It equals the step-by-step forward.

``train_iter`` runs eagerly and updates the net and optimizer held by the
state in place. It makes no host sync: the item and minibatch counts come
from the config, and the dropped counts stay tensors until the caller reads
the metrics. Every draw comes from ``ts.noise`` in the reference's order:
per rollout step the action's Gumbels, then the env's draws; then one
permutation per epoch.

Under a ``mesh`` each data rank steps its share of the envs with their GRU
hiddens and the reward scaler's per-env returns; the obs statistics and the
scaler's RMS read the whole batch. Successor values and GAE are computed
per env column on each rank; the columns the training rows read are then
gathered, so standardization, the training rows and the epoch permutations
are the unsharded ones on every rank. Each rank takes its share of each
minibatch; the masked means sum their active counts over ``data``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from gymrl_tpu_torch.algos.base import (
    IterOut, PhaseTimer, RecurrentTrainer, SeqRolloutSizes, adam, assert_flat_tp_ok, masked_mean,
    pack_fields, rollout_scan, to_chunks,
)
from gymrl_tpu_torch.algos.ppo import categorical_logp_entropy, gumbel_sample, pick_action
from gymrl_tpu_torch.core.gae import compute_gae, standardize
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.core.normalization import (
    RewardScaler, RunningMeanStd, normalize_obs, reward_scaler_init, reward_scaler_reset,
    reward_scaler_step, rms_init, rms_update_batch,
)
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.nn.layers import (
    MLP, PSCN, Edge, mlp_activation_edges, pscn_activation_edges,
)
from gymrl_tpu_torch.nn.recurrent import MLPRNNCell
from gymrl_tpu_torch.replay.episode import episode_buffer_pack


@dataclass(frozen=True)
class PPORNNConfig(SeqRolloutSizes):
    env_name: str = "LunarLander-v3"
    num_envs: int = 32
    rollout_steps: int = 128  # T per env per iteration
    seq_len: int = 16  # truncated-BPTT chunk length (divides rollout_steps)
    num_epochs: int = 10
    seq_minibatch: int = 64  # sequences (or episode rows) per minibatch
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    dual_clip: float = 3.0
    entropy_coef: float = 1e-2
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    lr: float = 1e-3
    adam_eps: float = 1e-5
    feature_dim: int = 256
    normalize_obs: bool = True
    scale_rewards: bool = True
    # Whole-episode BPTT: episode-major padded rows re-unrolled from each
    # episode's true first hidden under a masked loss (module docstring).
    whole_episode_bptt: bool = False
    episode_rows_per_env: int = 8  # most episode segments packed per env column
    # One Adam over all parameters as one multi-tensor ("foreach") update,
    # the counterpart of the reference's Adam over one raveled vector.
    flat_optimizer: bool = False
    # The reference's lax.scan unroll of the cell recurrence. Accepted so
    # configs carry over; it changes nothing here (the loop is a Python loop).
    cell_unroll: int = 1
    max_train_steps: int = 2_000_000
    solve_threshold: float | None = 200.0

    @property
    def n_train_items(self) -> int:
        """Sequences (chunk mode) or episode rows (whole-episode mode)."""
        if self.whole_episode_bptt:
            return self.num_envs * self.episode_rows_per_env
        return self.seqs_per_rollout


class RecurrentActorCritic(nn.Module):
    """PSCN → MLPRNN cell → actor/critic heads (ppo_rnn_lunarlander.py:141-166).

    ``forward(h, obs) -> (h', logits, value)`` is one step, for collection
    and eval: ``encode`` (the trunk), ``cell`` (one MLPRNN step) and
    ``heads``. ``unroll`` and ``heads`` are the training re-unroll's pieces.
    Submodule names are the flax module's (``fc_head``, ``rnn``,
    ``actor_fc``, ``critic_fc``), so weights map across by name.
    """

    def __init__(self, obs_dim: int, n_actions: int, feature_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.fc_head = PSCN(obs_dim, feature_dim, generator=g)
        self.rnn = MLPRNNCell(feature_dim, feature_dim, generator=g)
        self.actor_fc = MLP(feature_dim, [64, n_actions], generator=g)
        self.critic_fc = MLP(feature_dim, [32, 1], generator=g)
        self.rnn_size = self.rnn.rnn_size

    def forward(self, h, obs):
        h, out = self.cell(h, self.encode(obs))
        return (h, *self.heads(out))

    def encode(self, obs):
        """The time-independent trunk (any leading shape)."""
        return self.fc_head(obs)

    def cell(self, h, x):
        """One recurrence step on encoded features: ``(h', out)``."""
        return self.rnn(h, x)

    def unroll(self, h0: torch.Tensor, obs_seq: torch.Tensor) -> torch.Tensor:
        """Cell outputs ``[mb, L, F]`` of ``obs_seq[mb, L, obs]`` from
        ``h0[mb, rnn]``: the trunk batched over every step, then the cell."""
        return self.rnn.unroll(h0, self.encode(obs_seq))

    def heads(self, out):
        """Actor logits and critic value of cell outputs (any leading shape)."""
        return self.actor_fc(out), self.critic_fc(out).squeeze(-1)

    def activation_edges(self) -> list[Edge]:
        """Where the net's PReLU kinks sit, as ``QNet.activation_edges``
        states them: the PSCN's units enter the cell's four input maps, the
        heads' hidden units their output layer. (The cell's gates are
        smooth.)"""
        cell_inputs = ["rnn.rnn_linear.layer_0", "rnn.gru.ir", "rnn.gru.iz", "rnn.gru.in"]
        edges = pscn_activation_edges("fc_head", self.fc_head, cell_inputs)
        for name, child in self.named_children():
            if name.endswith("_fc"):
                edges += mlp_activation_edges(name, child)
        return edges


class RNNTrainState(NamedTuple):
    params: RecurrentActorCritic  # its parameters are the f32 master weights
    opt_state: torch.optim.Adam
    vec_state: VecState
    hidden: torch.Tensor  # f32[B, rnn] — the GRU carry of each env
    obs_rms: RunningMeanStd
    reward_scaler: RewardScaler
    noise: Noise  # the reference's `key`
    env_steps: int


class RNNRollout(NamedTuple):
    obs: torch.Tensor  # f32[T, B, obs] normalized
    action: torch.Tensor  # i32[T, B]
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor  # scaled
    next_obs: torch.Tensor  # f32[T, B, obs] normalized true successor
    h_pre: torch.Tensor  # f32[T, B, rnn] — hidden BEFORE the step
    h_post: torch.Tensor  # f32[T, B, rnn] — hidden AFTER the step, before the reset
    terminated: torch.Tensor  # f32[T, B]
    done: torch.Tensor  # f32[T, B]


class PPORNNTrainer(RecurrentTrainer):
    def __init__(self, cfg: PPORNNConfig, device: str | torch.device = "cuda", mesh=None):
        if cfg.flat_optimizer:
            assert_flat_tp_ok(mesh)
        super().__init__(cfg, device, mesh)
        self._check_split(cfg.n_train_items // cfg.num_minibatches, "seq_minibatch")
        self.venv = make_vec(cfg.env_name, self.local_envs)
        self.obs_dim = self.venv.env.obs_dim
        self.n_actions = self.venv.env.n_actions

    def make_net(self, generator: torch.Generator | None = None) -> RecurrentActorCritic:
        return RecurrentActorCritic(self.obs_dim, self.n_actions, self.cfg.feature_dim, generator)

    # -- API ------------------------------------------------------------------
    def init(self, seed: int = 0) -> RNNTrainState:
        """Fresh state. Params come from a CPU generator seeded ``seed`` (the
        same weights on every device); env and training noise from a
        generator on the trainer's device."""
        cfg, dev = self.cfg, self.device
        net = self.make_net(torch.Generator().manual_seed(seed)).to(dev)
        noise = self._noise(seed)
        return RNNTrainState(
            params=net,
            opt_state=adam(list(net.parameters()), cfg.lr, cfg.adam_eps,
                           foreach=cfg.flat_optimizer),
            vec_state=self.venv.reset(noise),
            hidden=torch.zeros(self.local_envs, net.rnn_size, device=dev),
            obs_rms=rms_init((self.obs_dim,), dev),
            reward_scaler=reward_scaler_init(self.local_envs, cfg.gamma, dev),
            noise=noise,
            env_steps=0,
        )

    def policy_reset(self, batch: int) -> torch.Tensor:
        """A fresh GRU hidden for ``batch`` episodes."""
        return torch.zeros(batch, self.cfg.feature_dim // 4, device=self.device)

    @torch.no_grad()
    def policy_step(self, ts: RNNTrainState, carry, obs, noise, deterministic: bool = True):
        """One step threading the hidden: returns ``(h', action)``."""
        h, logits, _ = self._apply_cell(ts.params, carry, self._norm(ts.obs_rms, obs))
        return h, pick_action(logits, noise, deterministic)

    def train_iter(self, ts: RNNTrainState,
                   timer: PhaseTimer | None = None) -> tuple[RNNTrainState, IterOut]:
        """One iteration; updates ``ts.params`` / ``ts.opt_state`` in place.

        ``timer``, if given, is called with "rollout", "gae" (next values,
        GAE and the packed training data) and "sgd" as each phase ends.
        """
        mark = timer or (lambda phase: None)
        carry, stats, _, packed, spec, pack_metrics = self._rollout_and_data(ts, mark)
        perms = ts.noise.permutations(self.cfg.num_epochs, packed.shape[0])
        metrics = self._epochs(ts, packed, spec, perms, self._loss)
        mark("sgd")
        return self._finish(ts, carry, stats, metrics | pack_metrics)

    # -- internals ------------------------------------------------------------
    def _norm(self, rms, obs):
        return normalize_obs(rms, obs) if self.cfg.normalize_obs else obs

    def _apply_cell(self, net, h, x):
        """One step ``(h', logits, value)``; PPG's hook drops its aux value."""
        return net(h, x)

    @torch.no_grad()
    def _collect(self, ts: RNNTrainState):
        """The T-step rollout (``rollout_scan``, eager): ``((vec_state,
        hidden, obs_rms, reward_scaler), RNNRollout, (final_return,
        final_length, done))``."""
        cfg = self.cfg

        def step(carry):
            vec_state, h_pre, obs_rms, scaler = carry
            nobs = self._norm(obs_rms, vec_state.obs)
            h_post, logits, value = self._apply_cell(ts.params, h_pre, nobs)
            action, logp, _ = gumbel_sample(logits, ts.noise)
            vec_state, tr = self.venv.step(vec_state, action, ts.noise)
            if cfg.normalize_obs:  # statistics of the whole env batch
                obs_rms = rms_update_batch(obs_rms, self._gather(tr.next_obs))
            reward = tr.reward
            if cfg.scale_rewards:
                scaler, reward = reward_scaler_step(scaler, tr.reward, self._gather)
                scaler = reward_scaler_reset(scaler, tr.done)
            hidden = torch.where(tr.done[:, None], 0.0, h_post)  # a new episode starts fresh
            roll = RNNRollout(obs=nobs, action=action, logp=logp, value=value, reward=reward,
                              next_obs=self._norm(obs_rms, tr.next_obs), h_pre=h_pre,
                              h_post=h_post, terminated=tr.terminated.float(),
                              done=tr.done.float())
            return (vec_state, hidden, obs_rms, scaler), (roll, (tr.final_return,
                                                                 tr.final_length, tr.done))

        carry, (roll, stats) = rollout_scan(
            step, (ts.vec_state, ts.hidden, ts.obs_rms, ts.reward_scaler), cfg.rollout_steps)
        return carry, roll, stats

    def _rollout_and_data(self, ts: RNNTrainState, mark: PhaseTimer):
        """Collection, then the successor values, GAE and the packed training
        rows: ``(carry, stats, data, packed, spec, pack_metrics)``."""
        cfg = self.cfg
        carry, roll, stats = self._collect(ts)
        mark("rollout")
        with torch.no_grad():
            # successor values under the ADVANCED hidden, one batched step
            # over all T·B stored (h_post, next_obs)
            _, _, next_values = self._apply_cell(
                ts.params, roll.h_post.reshape(-1, roll.h_post.shape[-1]),
                roll.next_obs.reshape(-1, self.obs_dim))
            adv, v_target = compute_gae(
                roll.reward, roll.value, next_values.reshape(roll.value.shape),
                roll.terminated, roll.done, cfg.gamma, cfg.gae_lambda,
            )
            if self.mesh is not None:  # the columns the training rows read
                obs, action, logp, h_pre, done, adv, v_target, stats = self._gather(
                    (roll.obs, roll.action, roll.logp, roll.h_pre, roll.done, adv, v_target,
                     stats), axis=1)
                roll = roll._replace(obs=obs, action=action, logp=logp, h_pre=h_pre, done=done)
            data, pack_metrics = self._training_data(roll, standardize(adv), v_target)
            # one [n, F] matrix: each epoch's shuffle is one row gather
            packed, spec = pack_fields(data)
        mark("gae")
        return carry, stats, data, packed, spec, pack_metrics

    def _training_data(self, roll: RNNRollout, adv, v_target):
        """The per-item training tensors with their ``mask``, and the pack
        metrics (module docstring: chunks or whole episodes)."""
        cfg = self.cfg
        if cfg.whole_episode_bptt:
            packed = episode_buffer_pack(
                {"obs": roll.obs, "action": roll.action, "logp": roll.logp, "adv": adv,
                 "v_target": v_target, "h_pre": roll.h_pre},
                roll.done, cfg.episode_rows_per_env,
            )
            data = dict(packed.data)
            data["h0"] = data.pop("h_pre")[:, 0]  # the hidden at each episode's first step
            data["mask"] = packed.active.float()
            # overflow beyond rows_per_env is counted, never silent
            extra = {"dropped_steps": packed.dropped_steps.float(),
                     "dropped_episodes": packed.dropped_episodes.float()}
            return data, extra

        to_seq = functools.partial(to_chunks, seq_len=cfg.seq_len)
        data = {"obs": to_seq(roll.obs), "action": to_seq(roll.action),
                "logp": to_seq(roll.logp), "adv": to_seq(adv), "v_target": to_seq(v_target),
                "h0": to_seq(roll.h_pre)[:, 0]}  # the stored hidden at each chunk start
        data["mask"] = torch.ones_like(data["logp"])
        return data, {}

    def _seq_forward(self, net, h0, obs_seq):
        """Logits ``[mb, L, A]`` and values ``[mb, L]`` of the re-unroll."""
        return net.heads(net.unroll(h0, obs_seq))

    def _loss(self, net, mb):
        cfg = self.cfg
        mask = mb["mask"]
        logits, values = self._seq_forward(net, mb["h0"], mb["obs"])
        logp, entropy = categorical_logp_entropy(logits, mb["action"])
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
        min_surr = torch.minimum(surr1, surr2)
        policy_obj = torch.where(adv < 0.0, torch.maximum(min_surr, cfg.dual_clip * adv), min_surr)
        policy_loss = -masked_mean(policy_obj, mask, mesh=self.mesh)
        value_loss = masked_mean(torch.square(values - mb["v_target"]), mask, mesh=self.mesh)
        entropy_mean = masked_mean(entropy, mask, mesh=self.mesh)
        loss = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy_mean
        return loss, {
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy_mean,
            "approx_kl": masked_mean(mb["logp"] - logp, mask, mesh=self.mesh),
        }

    def _finish(self, ts: RNNTrainState, carry, stats, metrics):
        vec_state, hidden, obs_rms, scaler = carry
        new_ts = ts._replace(vec_state=vec_state, hidden=hidden, obs_rms=obs_rms,
                             reward_scaler=scaler, env_steps=ts.env_steps + self.cfg.batch_total)
        return new_ts, self._iter_out(stats, metrics)


def ppo_rnn_lunarlander_config(**kw) -> PPORNNConfig:
    """Whole-episode BPTT and the flat optimizer: the JAX package's
    ``ppo_rnn_lunarlander`` preset (the reference's own training scheme,
    ppo_rnn_lunarlander.py:322-327)."""
    base = dict(env_name="LunarLander-v3", whole_episode_bptt=True,
                episode_rows_per_env=8, seq_minibatch=64, flat_optimizer=True)
    base.update(kw)
    return PPORNNConfig(**base)


def ppo_rnn_flappybird_config(**kw) -> PPORNNConfig:
    """ppo_rnn_flappybird.py: the same loop at width 512, γ 0.995,
    whole-episode BPTT, no solve bar."""
    base = dict(env_name="FlappyBird-v0", feature_dim=512, solve_threshold=None,
                gamma=0.995, whole_episode_bptt=True, episode_rows_per_env=8,
                seq_minibatch=64, flat_optimizer=True)
    base.update(kw)
    return PPORNNConfig(**base)
