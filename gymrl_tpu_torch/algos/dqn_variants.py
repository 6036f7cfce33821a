"""The DQN family beyond vanilla: Double / PER / Dueling / Noisy / Rainbow
(counterpart of ``gymrl_tpu/algos/dqn_variants.py``).

One parameterized trainer covers six workloads; the presets at the end pin
each reference script's hyperparameters, unchanged from the JAX package:

  * DDQN+PER          — 2x256 relu trunk, double-DQN target, stratified PER
    with β 0.4 +0.001 per sample, priority min(|δ|+1e-4, 1)^0.6, per-param
    grad clamp ±1, hard target sync every 4 episodes, γ=0.9.
  * DDQN+PER+Dueling  — 1x256 trunk + V/A streams, Q = V + (A − mean A).
  * NoisyDQN+Dueling  — all-noisy 2x64 trunk and streams, no ε-greedy
    (μ-only in eval), uniform replay 16k, hard sync every 500 learn steps.
  * NoisyDQN FlappyBird — all-noisy PSCN-512 + MLP[512, 256, 256] trunk,
    MLP[64, ·] dueling streams, inline obs normalization and per-episode
    reward scaling, grad-norm clip 1, hard sync every 400 learn steps.
  * Rainbow           — noisy dueling heads on a 2x256 relu trunk, PER with
    β annealed by progress, 5-step returns bootstrapped with γ^n on true
    termination, soft target τ=0.005, grad-norm clip 10, lr decay.
  * Pixel DQN         — ``ConvEncoder`` trunk on CartPolePixels-v0 (48×48×4
    frames), dueling double DQN, uniform replay of 16,384 with uint8 frames,
    lr 1e-4 with the lr decay, hard sync every 1000 learn steps, 2 updates
    per env step.

One ``train_iter`` is ``steps_per_iter`` env steps, each: act (per-row
NoisyNet noise, or ε-greedy) on the normalized obs → ``VecEnv.step`` →
reward scaling and obs statistics → n-step window roll and fold → push
(once the window is warm) → ``n_updates`` updates once the replay holds a
batch → target maintenance. Updates use one shared NoisyNet draw per online
forward and a μ-only target net. ``pos``/``size``, ``env_steps`` and
``learn_steps`` are Python ints, so every gate is decided on the host
without waiting for the device; ``max_priority``, β, the episode and sync
counters stay on the device. Every draw comes from ``ts.noise`` in the
reference's order. With ``obs_uint8`` the replay stores frames as
``clamp(round(x·255), 0, 255)`` in uint8, quantized before the push (the
ring's slice write would truncate floats) and divided by 255 after the
sample.

Under a ``mesh`` each data rank acts for its share of the envs and keeps
their n-step window; the obs statistics and the reward scaler's RMS read the
whole batch, and each env step's folded transitions are gathered, so every
rank pushes the whole batch and holds the same replay and sum-tree. Sampled
indices, PER uniforms and an update's NoisyNet ε are shared draws; the IS
weights are normalized over the whole sampled batch before each rank takes
its share; gradients and the loss are averaged over ``data`` before the
clip; the TD errors are gathered, so every rank writes the same priorities.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from gymrl_tpu_torch.algos.base import (
    IterOut, PhaseTimer, Trainer, adam, clip_grads_by_global_norm_, clip_grads_by_value_,
    frozen_copy, mesh_mean, set_grads, soft_update,
)
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.core.normalization import (
    RewardScaler, RunningMeanStd, normalize_obs, reward_scaler_init, reward_scaler_reset,
    reward_scaler_step, rms_init, rms_update_batch,
)
from gymrl_tpu_torch.core.schedules import exp_epsilon_decay, per_beta_anneal, ref_lr_decay
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.nn.layers import (
    MLP, PSCN, ConvEncoder, call, linear_layer, mlp_activation_edges, noisy_layers,
    pscn_activation_edges,
)
from gymrl_tpu_torch.replay.per import (
    PERState, per_init, per_push_batch, per_sample, per_update_priorities,
)
from gymrl_tpu_torch.replay.uniform import (
    ReplayState, replay_init, replay_push_batch, replay_sample,
)


@dataclass(frozen=True)
class DQNFamilyConfig:
    env_name: str = "CartPole-v1"
    num_envs: int = 16
    steps_per_iter: int = 32
    batch_size: int = 64
    gamma: float = 0.9
    lr: float = 1e-3
    hidden_dim: int = 256
    memory_capacity: int = 65536  # power of two when use_per
    # feature flags
    double: bool = True
    dueling: bool = False
    noisy_trunk: bool = False
    noisy_heads: bool = False
    trunk_layers: int = 2
    trunk: str = "mlp"  # "mlp" | "pscn" (flappybird) | "conv" (pixel obs)
    pscn_dim: int = 512
    trunk_dims: tuple = ()  # post-PSCN MLP widths (flappy: (512, 256, 256))
    head_hidden: int = 0  # dueling stream hidden width (flappy: 64)
    use_per: bool = True
    n_steps: int = 1
    # inline normalization: running obs norm on what enters the net/replay,
    # and per-episode reward scaling
    normalize_obs: bool = False
    scale_rewards: bool = False
    # exploration (ignored when noisy)
    epsilon_start: float = 0.95
    epsilon_end: float = 0.01
    epsilon_decay: float = 800.0
    # PER
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_increment: float = 0.001  # per sample() call; 0 ⇒ progress anneal
    per_eps: float = 1e-4
    per_error_max: float | None = 1.0  # None ⇒ unclipped (rainbow)
    # target network
    target_mode: str = "hard_episode"  # hard_episode | hard_step | soft
    target_update_freq: int = 4  # episodes or learn steps per mode
    tau: float = 0.005
    # optimization
    grad_clip_value: float | None = 1.0  # per-param clamp
    grad_clip_norm: float | None = None
    lr_decay: bool = False  # rainbow's 0.9·lr·(1−t/T)+0.1·lr
    updates_per_step: int | None = None  # None ⇒ num_envs (ref cadence)
    obs_uint8: bool = False  # uint8 pixel replay: 4× less device memory
    max_train_steps: int = 2_000_000
    solve_threshold: float | None = 495.0

    @property
    def n_updates(self) -> int:
        return self.num_envs if self.updates_per_step is None else self.updates_per_step

    @property
    def noisy(self) -> bool:
        return self.noisy_trunk or self.noisy_heads


class QNet(nn.Module):
    """Configurable trunk + (dueling) head with optional noisy layers.

      * ``"mlp"``  — ``trunk_layers`` × Dense/NoisyDense(hidden_dim) + ReLU;
      * ``"pscn"`` — PSCN(pscn_dim), then MLP(trunk_dims) with its last
        activation (the FlappyBird network);
      * ``"conv"`` — ``ConvEncoder(obs_shape, hidden_dim)`` on ``[B, H, W, C]``
        frames (the pixel network).
    ``head_hidden`` > 0 makes each dueling stream MLP[head_hidden, out];
    0 keeps one linear layer per stream. Flax names throughout (``fc{i}``,
    ``pscn``, ``trunk_mlp``, ``value``, ``advantage``, ``head``).

    ``forward(x, eps)``: ``eps`` is one noise pair per noisy layer in call
    order (``noisy_layers(net)``), or ``None`` for the μ-only forward.
    """

    def __init__(self, obs_shape: tuple[int, ...], n_actions: int, hidden_dim: int,
                 trunk_layers: int, dueling: bool, noisy_trunk: bool, noisy_heads: bool,
                 trunk: str = "mlp", pscn_dim: int = 512, trunk_dims: tuple = (),
                 head_hidden: int = 0, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.trunk, self.dueling, self.trunk_layers = trunk, dueling, trunk_layers
        linear = "noisy" if noisy_trunk else "dense"
        obs_dim = math.prod(obs_shape)
        if trunk == "conv":
            self.conv = ConvEncoder(obs_shape, hidden_dim, generator=g)
            width = hidden_dim
        elif trunk == "pscn":
            self.pscn = PSCN(obs_dim, pscn_dim, linear=linear, generator=g)
            width = pscn_dim
            if trunk_dims:
                self.trunk_mlp = MLP(width, list(trunk_dims), last_act=True, linear=linear,
                                     generator=g)
                width = self.trunk_mlp.out_dim
        elif trunk == "mlp":
            width = obs_dim
            for i in range(trunk_layers):
                self.add_module(f"fc{i + 1}", linear_layer(width, hidden_dim, noisy_trunk, g))
                width = hidden_dim
        else:
            raise ValueError(f"trunk must be 'mlp', 'pscn' or 'conv', got {trunk!r}")

        def stream(out_dim):
            if head_hidden > 0:
                return MLP(width, [head_hidden, out_dim],
                           linear="noisy" if noisy_heads else "dense", generator=g)
            return linear_layer(width, out_dim, noisy_heads, g)

        if dueling:
            self.value = stream(1)
            self.advantage = stream(n_actions)
        else:
            self.head = linear_layer(width, n_actions, noisy_heads, g)

    def activation_edges(self) -> list[tuple[str, str, int, int, int]]:
        """Where the net's kinks at 0 sit: ``(producer, consumer, lo, hi,
        offset)`` says that output units ``lo..hi-1`` of layer ``producer``
        pass a ReLU or PReLU and enter layer ``consumer`` as input rows
        ``unit + offset`` (names as in ``named_modules``). A check of float32
        agreement reads it: a pre-activation within rounding of 0 may take
        either side of the kink, which moves the producer's weights of that
        unit and the consumers' weights that read it."""
        def first(stream, name):
            return f"{name}.layer_0" if isinstance(stream, MLP) else name

        heads = ([first(self.value, "value"), first(self.advantage, "advantage")]
                 if self.dueling else ["head"])
        edges = []
        if self.trunk == "conv":
            enc = self.conv
            for i in range(enc.n - 1):
                width = getattr(enc, f"conv_{i}").out_channels
                edges.append((f"conv.conv_{i}", f"conv.conv_{i + 1}", 0, width, 0))
            # the channels-last flatten: channel c at position p is proj's input p·C + c
            width = getattr(enc, f"conv_{enc.n - 1}").out_channels
            edges.extend((f"conv.conv_{enc.n - 1}", "conv.proj", 0, width, p * width)
                         for p in range(enc.out_hw[0] * enc.out_hw[1]))
            edges.extend(("conv.proj", c, 0, enc.features, 0) for c in heads)
        elif self.trunk == "pscn":
            after_pscn = ["trunk_mlp.layer_0"] if hasattr(self, "trunk_mlp") else heads
            edges += pscn_activation_edges("pscn", self.pscn, after_pscn)
            if hasattr(self, "trunk_mlp"):
                edges += mlp_activation_edges("trunk_mlp", self.trunk_mlp, heads)
        else:
            for i in range(self.trunk_layers):
                name = f"fc{i + 1}"
                nxt = [f"fc{i + 2}"] if i < self.trunk_layers - 1 else heads
                width = self.get_submodule(name).out_features
                edges.extend((name, c, 0, width, 0) for c in nxt)
        for name in ("value", "advantage"):
            if isinstance(getattr(self, name, None), MLP):
                edges += mlp_activation_edges(name, getattr(self, name))
        return edges

    def forward(self, x, eps=None):
        eps = None if eps is None else iter(eps)
        if self.trunk == "conv":
            x = self.conv(x)
        elif self.trunk == "pscn":
            x = self.pscn(x, eps)
            if hasattr(self, "trunk_mlp"):
                x = self.trunk_mlp(x, eps)
        else:
            for i in range(self.trunk_layers):
                x = torch.relu(call(getattr(self, f"fc{i + 1}"), x, eps))
        if self.dueling:
            v = call(self.value, x, eps)
            a = call(self.advantage, x, eps)
            return v + (a - a.mean(dim=-1, keepdim=True))
        return call(self.head, x, eps)


class NStepWindow(NamedTuple):
    """Ring of the last n transitions per env instance ([n, B, ...])."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    terminated: torch.Tensor  # f32 — cuts bootstrap (γ^n target)
    done: torch.Tensor  # f32 — cuts reward folding


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor  # i32
    reward: torch.Tensor
    next_obs: torch.Tensor
    terminated: torch.Tensor  # f32 — rainbow bootstraps on true termination only
    done: torch.Tensor  # f32 — the 1-step variants bootstrap on done (incl. truncation)


class FamilyTrainState(NamedTuple):
    params: QNet
    target_params: QNet  # μ-only, no grads; moved in place
    opt_state: torch.optim.Adam
    replay: PERState | ReplayState
    vec_state: VecState
    window: NStepWindow | None
    obs_rms: RunningMeanStd
    reward_scaler: RewardScaler
    noise: Noise  # the reference's `key`
    env_steps: int
    learn_steps: int
    episodes: torch.Tensor  # i32[] on the device
    target_syncs: torch.Tensor  # i32[] on the device
    beta: torch.Tensor  # f32[] on the device — PER β


def quantize_frames(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] frames as uint8 levels: ``clamp(round(x·255), 0, 255)``
    (round half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def fold_window(w: NStepWindow, gamma: float) -> Transition:
    """The n-step transition of the window's oldest entry: rewards folded
    back to front, cut at the first done; the bootstrap obs and the
    termination flag of the step that ended the fold (rainbow :207-218)."""
    n = w.reward.shape[0]
    n_reward = torch.zeros_like(w.reward[0])
    next_obs = w.next_obs[n - 1]
    terminal = w.terminated[n - 1]
    for i in reversed(range(n)):
        n_reward = w.reward[i] + gamma * (1.0 - w.done[i]) * n_reward
        cut = w.done[i] > 0.5
        next_obs = torch.where(cut.reshape(cut.shape + (1,) * (next_obs.dim() - 1)),
                               w.next_obs[i], next_obs)
        terminal = torch.where(cut, w.terminated[i], terminal)
    return Transition(obs=w.obs[0], action=w.action[0], reward=n_reward,
                      next_obs=next_obs, terminated=terminal, done=w.done[0])


class DQNFamilyTrainer(Trainer):
    def __init__(self, cfg: DQNFamilyConfig, device: str | torch.device = "cuda", mesh=None):
        if cfg.obs_uint8 and cfg.normalize_obs:
            raise ValueError("obs_uint8 stores raw [0, 1] frames; it excludes normalize_obs")
        super().__init__(cfg, device, mesh)
        self._check_split(cfg.batch_size, "batch_size")
        self.venv = make_vec(cfg.env_name, self.local_envs)
        self.obs_shape = self.venv.env.obs_shape  # (d,) for vectors, (H, W, C) for pixels
        self.obs_dim = self.venv.env.obs_dim
        self.n_actions = self.venv.env.n_actions

    def make_net(self, generator: torch.Generator | None = None) -> QNet:
        cfg = self.cfg
        return QNet(self.obs_shape, self.n_actions, cfg.hidden_dim, cfg.trunk_layers, cfg.dueling,
                    cfg.noisy_trunk, cfg.noisy_heads, cfg.trunk, cfg.pscn_dim,
                    tuple(cfg.trunk_dims), cfg.head_hidden, generator)

    # -- API ------------------------------------------------------------------
    def init(self, seed: int = 0) -> FamilyTrainState:
        """Fresh state. Params come from a CPU generator seeded ``seed`` (the
        same weights on every device); env and training noise from a
        generator on the trainer's device."""
        cfg, dev = self.cfg, self.device
        net = self.make_net(torch.Generator().manual_seed(seed)).to(dev)
        noise = self._noise(seed)
        d, b, n = self.obs_shape, self.local_envs, cfg.n_steps
        frame = torch.zeros(d, dtype=torch.uint8 if cfg.obs_uint8 else torch.float32)
        example = Transition(
            obs=frame, action=torch.zeros((), dtype=torch.int32),
            reward=torch.zeros(()), next_obs=frame,
            terminated=torch.zeros(()), done=torch.zeros(()),
        )
        replay = (per_init(example, cfg.memory_capacity, dev) if cfg.use_per
                  else replay_init(example, cfg.memory_capacity, dev))
        window = None
        if n > 1:
            window = NStepWindow(
                obs=torch.zeros((n, b) + d, device=dev),
                action=torch.zeros(n, b, dtype=torch.int32, device=dev),
                reward=torch.zeros(n, b, device=dev),
                next_obs=torch.zeros((n, b) + d, device=dev),
                terminated=torch.zeros(n, b, device=dev),
                done=torch.zeros(n, b, device=dev),
            )
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return FamilyTrainState(
            params=net,
            target_params=frozen_copy(net),
            opt_state=adam(list(net.parameters()), cfg.lr, 1e-8, foreach=True),
            replay=replay,
            vec_state=self.venv.reset(noise),
            window=window,
            obs_rms=rms_init(d, dev),
            reward_scaler=reward_scaler_init(b, cfg.gamma, dev),
            noise=noise,
            env_steps=0,
            learn_steps=0,
            episodes=zero,
            target_syncs=zero.clone(),
            beta=torch.full((), cfg.per_beta0, device=dev),
        )

    @torch.no_grad()
    def policy(self, ts: FamilyTrainState, obs, noise, deterministic: bool = True):
        """Eval: μ-only for noisy nets, argmax, frozen normalization."""
        if self.cfg.normalize_obs:
            obs = normalize_obs(ts.obs_rms, obs)
        eps = None
        if self.cfg.noisy and not deterministic:
            eps = noise.noisy_update(noisy_layers(ts.params), 1)[0]
        return torch.argmax(ts.params(obs, eps), dim=-1).to(torch.int32)

    def train_iter(self, ts: FamilyTrainState,
                   timer: PhaseTimer | None = None) -> tuple[FamilyTrainState, IterOut]:
        """One iteration; updates the nets, optimizer, replay storage and
        sum-tree held by ``ts`` in place.

        ``timer``, if given, is called with "act" (act, env step, scaling,
        n-step fold and push) and "update" (the updates and the target
        maintenance) as each phase of each env step ends.
        """
        cfg, dev = self.cfg, self.device
        mark = timer or (lambda phase: None)
        net, opt, noise = ts.params, ts.opt_state, ts.noise
        online, target = list(net.parameters()), list(ts.target_params.parameters())
        layers = noisy_layers(net)
        push = per_push_batch if cfg.use_per else replay_push_batch
        anneal_beta = cfg.use_per and cfg.per_beta_increment == 0
        replay, vec_state, window = ts.replay, ts.vec_state, ts.window
        obs_rms, scaler = ts.obs_rms, ts.reward_scaler
        env_steps, learn_steps = ts.env_steps, ts.learn_steps
        episodes, target_syncs, beta = ts.episodes, ts.target_syncs, ts.beta
        zero = torch.zeros((), device=dev)
        stats, losses = [], []
        for _ in range(cfg.steps_per_iter):
            # --- act on the normalized obs
            nobs = normalize_obs(obs_rms, vec_state.obs) if cfg.normalize_obs else vec_state.obs
            action = self._act(net, nobs, noise, env_steps, layers)
            vec_state, tr = self.venv.step(vec_state, action, noise)

            # --- scaling and statistics before the replay sees the transition
            reward = tr.reward
            if cfg.scale_rewards:
                scaler, reward = reward_scaler_step(scaler, reward, self._gather)
                scaler = reward_scaler_reset(scaler, tr.done)
            if cfg.normalize_obs:  # statistics of the whole env batch
                obs_rms = rms_update_batch(obs_rms, self._gather(tr.next_obs))
                next_obs = normalize_obs(obs_rms, tr.next_obs)
            else:
                next_obs = tr.next_obs
            emit = Transition(obs=nobs, action=action, reward=reward, next_obs=next_obs,
                              terminated=tr.terminated.float(), done=tr.done.float())

            # --- n-step fold + push
            warm = True
            if cfg.n_steps > 1:
                window = NStepWindow(*(torch.cat([w[1:], x[None]]) for w, x in zip(window, emit)))
                emit = fold_window(window, cfg.gamma)
                warm = env_steps >= (cfg.n_steps - 1) * cfg.num_envs
            if cfg.obs_uint8:  # clamp before the cast: uint8 would wrap mod 256
                emit = emit._replace(obs=quantize_frames(emit.obs),
                                     next_obs=quantize_frames(emit.next_obs))
            if warm:  # every rank's envs, in rank order: the same replay everywhere
                replay = push(replay, self._gather(emit))
            mark("act")

            # --- k gradient updates (update:data parity)
            if cfg.lr_decay:
                lr = float(ref_lr_decay(env_steps, cfg.max_train_steps, cfg.lr))
                for group in opt.param_groups:
                    group["lr"] = lr
            if anneal_beta:
                beta = torch.full((), float(per_beta_anneal(env_steps, cfg.max_train_steps,
                                                            cfg.per_beta0)), device=dev)
            did_update = replay.size >= cfg.batch_size
            if did_update:
                step_losses = []
                for _ in range(cfg.n_updates):
                    replay, beta, loss = self._update(ts, replay, beta, layers)
                    step_losses.append(loss)
                loss = torch.stack(step_losses).mean()
                learn_steps += cfg.n_updates
            else:
                loss = zero

            # --- target network maintenance
            done, ep_stats = self._gather((tr.done, (tr.final_return, tr.final_length)))
            episodes = episodes + done.sum(dtype=torch.int32)
            target_syncs = self._target_update(online, target, episodes, learn_steps,
                                               did_update, target_syncs)
            mark("update")

            env_steps += cfg.num_envs
            losses.append(loss)
            stats.append((*ep_stats, done))

        stats = [torch.stack(f) for f in zip(*stats)]
        new_ts = ts._replace(
            replay=replay, vec_state=vec_state, window=window, obs_rms=obs_rms,
            reward_scaler=scaler, env_steps=env_steps, learn_steps=learn_steps,
            episodes=episodes, target_syncs=target_syncs, beta=beta,
        )
        return new_ts, self._iter_out(stats, {"loss": torch.stack(losses).mean(), "beta": beta})

    # -- internals ------------------------------------------------------------
    def _act(self, net: QNet, nobs, noise, env_steps: int, layers) -> torch.Tensor:
        """Per-row NoisyNet noise, or ε-greedy on the μ-only net."""
        cfg = self.cfg
        with torch.no_grad():
            if cfg.noisy:
                q = net(nobs, noise.noisy_act(layers, nobs.shape[0]))
                return torch.argmax(q, dim=-1).to(torch.int32)
            greedy = torch.argmax(net(nobs), dim=-1).to(torch.int32)
        eps = exp_epsilon_decay(env_steps, cfg.epsilon_start, cfg.epsilon_end, cfg.epsilon_decay)
        u, randoms = noise.explore(nobs.shape[0], self.n_actions)
        return torch.where(u < float(eps), randoms, greedy)

    def _td_error(self, net: QNet, target: QNet, batch: Transition, eps) -> torch.Tensor:
        """Double or plain TD error; the target net is always μ-only."""
        cfg = self.cfg
        q = net(batch.obs, eps[0])
        q_sa = q.gather(-1, batch.action.long()[:, None]).squeeze(-1)
        with torch.no_grad():
            if cfg.double:
                next_a = torch.argmax(net(batch.next_obs, eps[1]), dim=-1)
                next_q = target(batch.next_obs).gather(-1, next_a[:, None]).squeeze(-1)
            else:
                next_q = target(batch.next_obs).max(dim=-1).values
            # rainbow (n > 1) bootstraps on true termination with γ^n; the
            # 1-step variants cut on done, as each script does
            cut = batch.terminated if cfg.n_steps > 1 else batch.done
            y = batch.reward + (cfg.gamma ** cfg.n_steps) * next_q * (1.0 - cut)
        return q_sa - y

    def _update(self, ts: FamilyTrainState, replay, beta, layers):
        """One sampled minibatch step on ``ts``'s net and optimizer, in
        place. Returns (replay, β, the loss before the step)."""
        cfg, noise = self.cfg, ts.noise
        if cfg.use_per:
            batch, leaf_idx, weights = per_sample(replay, noise, cfg.batch_size, beta)
        else:
            batch, weights = replay_sample(replay, noise, cfg.batch_size), None
        if cfg.obs_uint8:  # dequantize the sampled frames back to [0, 1]
            batch = batch._replace(obs=batch.obs.float() / 255.0,
                                   next_obs=batch.next_obs.float() / 255.0)
        eps = (noise.noisy_update(layers, 2 if cfg.double else 1) if cfg.noisy
               else [None, None])
        # this rank's share of the sampled batch (its IS weights already
        # normalized over the whole batch)
        batch, weights = self._share((batch, weights))
        delta = self._td_error(ts.params, ts.target_params, batch, eps)
        sq = torch.square(delta)
        loss = (sq if weights is None else sq * weights).mean()
        params = list(ts.params.parameters())
        set_grads(params, loss, self.mesh)
        grads = [p.grad for p in params]
        if cfg.grad_clip_value:
            clip_grads_by_value_(grads, cfg.grad_clip_value)
        if cfg.grad_clip_norm:
            clip_grads_by_global_norm_(grads, cfg.grad_clip_norm)
        ts.opt_state.step()

        if cfg.use_per:
            err = self._gather(delta.detach()).abs() + cfg.per_eps
            if cfg.per_error_max is not None:
                err = torch.clamp(err, max=cfg.per_error_max)
            replay = per_update_priorities(replay, leaf_idx, torch.pow(err, cfg.per_alpha))
            if cfg.per_beta_increment > 0:
                beta = torch.clamp(beta + cfg.per_beta_increment, max=1.0)
        return replay, beta, mesh_mean([loss], self.mesh)[0]

    @torch.no_grad()
    def _target_update(self, online, target, episodes, learn_steps: int, did_update: bool,
                       target_syncs):
        cfg = self.cfg
        if cfg.target_mode == "soft":
            # once per env step that updated (rainbow :347-352)
            if did_update:
                soft_update(target, online, cfg.tau)
            return target_syncs
        counter = episodes if cfg.target_mode == "hard_episode" else learn_steps
        due = counter // cfg.target_update_freq
        sync = due > target_syncs
        for t, o in zip(target, online):
            torch.where(sync, o, t, out=t)
        return torch.where(sync, due, target_syncs)


# -- presets: one per reference script ---------------------------------------

def ddqn_per_config(**kw) -> DQNFamilyConfig:
    """algorithms/ddqn_per_cartpole.py hyperparameters."""
    base = dict(
        gamma=0.9, memory_capacity=65536, double=True, dueling=False,
        use_per=True, per_beta_increment=0.001, per_error_max=1.0, per_eps=1e-4,
        target_mode="hard_episode", target_update_freq=4, grad_clip_value=1.0,
        trunk_layers=2, hidden_dim=256,
    )
    base.update(kw)
    return DQNFamilyConfig(**base)


def ddqn_per_duel_config(**kw) -> DQNFamilyConfig:
    """algorithms/ddqn_per_duel_cartpole.py — adds the dueling head."""
    return ddqn_per_config(dueling=True, trunk_layers=1, **kw)


def noisy_dqn_config(**kw) -> DQNFamilyConfig:
    """algorithms/noisy_dqn_cartpole.py hyperparameters."""
    base = dict(
        gamma=0.99, memory_capacity=16384, double=False, dueling=True,
        noisy_trunk=True, noisy_heads=True, trunk_layers=2, hidden_dim=64,
        use_per=False, target_mode="hard_step", target_update_freq=500,
        grad_clip_value=1.0,
    )
    base.update(kw)
    return DQNFamilyConfig(**base)


def noisy_dqn_flappybird_config(**kw) -> DQNFamilyConfig:
    """algorithms/noisy_dqn_flappybird.py hyperparameters + network:
    PSCN-512 + MLP[512, 256, 256] all-noisy, dueling streams MLP[64, ·],
    double-DQN, γ=0.9, Adam 1e-4, batch 256, capacity 51200, hard target sync
    every 400 learn steps, grad-norm clip 1, inline obs normalization and
    per-episode reward scaling."""
    base = dict(
        env_name="FlappyBird-v0", gamma=0.9, lr=1e-4, batch_size=256,
        memory_capacity=51200, double=True, dueling=True,
        noisy_trunk=True, noisy_heads=True,
        trunk="pscn", pscn_dim=512, trunk_dims=(512, 256, 256), head_hidden=64,
        use_per=False, target_mode="hard_step", target_update_freq=400,
        grad_clip_value=None, grad_clip_norm=1.0,
        normalize_obs=True, scale_rewards=True,
        solve_threshold=None,
    )
    base.update(kw)
    return DQNFamilyConfig(**base)


def dqn_pixels_config(**kw) -> DQNFamilyConfig:
    """Pixel-observation DQN on CartPolePixels-v0, the JAX package's solving
    defaults: the conv trunk, uint8 frames in a 16k replay, lr 1e-4 with the
    rainbow lr decay, hard target sync every 1000 learn steps."""
    base = dict(
        env_name="CartPolePixels-v0", trunk="conv", hidden_dim=256,
        gamma=0.99, lr=1e-4, double=True, dueling=True, use_per=False,
        num_envs=32, batch_size=32, memory_capacity=16384, obs_uint8=True,
        epsilon_decay=40_000.0, lr_decay=True, max_train_steps=3_000_000,
        target_mode="hard_step", target_update_freq=1000,
        grad_clip_value=None, grad_clip_norm=10.0, updates_per_step=2,
    )
    base.update(kw)
    return DQNFamilyConfig(**base)


def rainbow_config(**kw) -> DQNFamilyConfig:
    """algorithms/rainbow_dqn_cartpole.py hyperparameters (reference-exact;
    the JAX package records that gamma=0.99 is what makes it solve)."""
    base = dict(
        gamma=0.9, batch_size=256, memory_capacity=32768, double=True,
        dueling=True, noisy_trunk=False, noisy_heads=True, trunk_layers=2,
        hidden_dim=256, use_per=True, per_beta_increment=0.0,  # progress anneal
        per_eps=0.01, per_error_max=None, n_steps=5,
        target_mode="soft", tau=0.005, grad_clip_value=None, grad_clip_norm=10.0,
        lr_decay=True, max_train_steps=250_000,
    )
    base.update(kw)
    return DQNFamilyConfig(**base)
