"""PPO on vectorized envs (counterpart of ``gymrl_tpu/algos/ppo.py``).

Algorithm parity with reference algorithms/ppo_lunarlander.py, unchanged
from the JAX trainer:
  * shared 2x256 tanh trunk, tanh actor/critic heads, orthogonal init
    gain √2 (policy head 0.01, value head 1.0)
  * Adam(3e-4, eps=1e-5), linear lr anneal with env steps
  * GAE(γ=0.99, λ=0.95) with rollout-wide advantage standardization
  * clipped surrogate + dual-clip 3.0:
    adv<0 ? max(min(surr1,surr2), 3·adv) : min(surr1,surr2)
  * value MSE ·0.5, entropy bonus 0.01, grad-norm clip 0.5 (optax form)
  * metrics: policy/value loss, entropy, clip_frac, approx_kl

One ``train_iter``: a T-step rollout of B lockstep envs (forward → Gumbel-max
sample → batched env step with autoreset), one batched next-value forward
over all T·B successors, GAE and standardization, then epochs of shuffled
minibatches over the packed ``[N, obs+4]`` rows. Every random draw comes
from ``ts.noise`` in the reference's order, so a replaying noise source
reproduces the JAX trainer's iteration.

Under a ``mesh`` (``distributed/mesh.py``): each data rank steps its share
of the envs and computes their successor values and GAE (elementwise per
env column, so bit-equal to those columns of the unsharded GAE); the
rollout's columns are then gathered, so standardization, the packed rows
and the epoch permutations are the unsharded ones on every rank; each rank
takes its share of each minibatch, and gradients and metrics are averaged
over ``data`` before the clip. A ``model`` axis splits the trunk Megatron's
way (``split_trunk``), as the JAX trainer's layout does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from gymrl_tpu_torch.algos.base import (
    IterOut, PhaseTimer, RolloutGraph, RolloutSizes, SweepGraph, Trainer, adam, assert_flat_tp_ok,
    clip_adam_, sweep,
)
from gymrl_tpu_torch.core.gae import compute_gae, standardize
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.core.normalization import (
    RunningMeanStd,
    normalize_obs,
    rms_init,
    rms_update_batch,
)
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.kernels import ppo as ppo_kernels
from gymrl_tpu_torch.kernels.ppo import METRICS
from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.layers import Dense
from gymrl_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class PPOConfig(RolloutSizes):
    env_name: str = "LunarLander-v3"
    num_envs: int = 32
    rollout_steps: int = 64  # T; total horizon = T·num_envs (ref: 2048 total)
    num_epochs: int = 10
    minibatch_size: int = 64  # in samples (ref batch_size)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    dual_clip: float = 3.0
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    lr: float = 3e-4
    adam_eps: float = 1e-5
    anneal_lr: bool = True
    hidden_dim: int = 256
    normalize_obs: bool = False  # plain PPO matches ref (no state_norm)
    max_train_steps: int = 1_000_000
    solve_threshold: float = 200.0
    # bf16 on the (no-grad) rollout forward: params and obs cast to bf16
    # inside the forward, logits/values upcast to f32 before sampling/GAE.
    rollout_bf16: bool = False
    # bf16 compute in the SGD loss forward/backward. The cast happens inside
    # the loss (torch.func.functional_call on bf16 copies of the params), so
    # autograd returns f32 grads on the f32 master params.
    sgd_bf16: bool = False
    # One Adam over all parameters as one multi-tensor ("foreach") update,
    # the counterpart of the reference's Adam over one raveled vector: the
    # same math, fewer and wider kernels. Off: one update per tensor.
    flat_optimizer: bool = False
    # XLA scan-unroll knobs of the reference, accepted so configs carry over.
    # They change nothing here: ``rollout_scan`` and ``sweep`` are Python
    # loops, or one CUDA graph each (``trainer.graphs``).
    sgd_unroll: int = 1
    rollout_unroll: int = 1

    @property
    def num_minibatches(self) -> int:
        if self.batch_total % self.minibatch_size != 0:
            raise ValueError(
                f"T·B={self.batch_total} must divide by minibatch {self.minibatch_size}"
            )
        return self.batch_total // self.minibatch_size


class ActorCritic(nn.Module):
    """Shared tanh trunk + tanh actor/critic heads (ref ppo_lunarlander.py:63-118).

    Submodule names are the flax module's, so weights map across by name
    (``interop.params_from_flax``).
    """

    def __init__(self, obs_dim: int, n_actions: int, hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        ortho = gl_init.orthogonal()
        g = generator
        self.shared_0 = Dense(obs_dim, hidden_dim, ortho, generator=g)
        self.shared_1 = Dense(hidden_dim, hidden_dim, ortho, generator=g)
        self.actor_0 = Dense(hidden_dim, hidden_dim, ortho, generator=g)
        self.actor_head = Dense(hidden_dim, n_actions, gl_init.orthogonal(0.01), generator=g)
        self.critic_0 = Dense(hidden_dim, hidden_dim, ortho, generator=g)
        self.critic_head = Dense(hidden_dim, 1, gl_init.orthogonal(1.0), generator=g)

    # Parameters held as one ``model`` split each, by name → the split dim
    # (``split_trunk``); empty for the whole net.
    model_split: dict[str, int] = {}

    def forward(self, x):
        trunk = torch.tanh(self.shared_1(torch.tanh(self.shared_0(x))))
        logits = self.actor_head(torch.tanh(self.actor_0(trunk)))
        value = self.critic_head(torch.tanh(self.critic_0(trunk)))
        return logits, value.squeeze(-1)


class RowParallelDense(nn.Module):
    """A ``Dense`` holding one ``model`` rank's input columns of the weight
    (rows ``[H/M·m, H/M·(m+1))`` of the flax kernel): the partial product is
    summed over ``model``, then the whole bias is added."""

    def __init__(self, dense: Dense, mesh):
        super().__init__()
        n = dense.in_features // mesh.model_size
        cols = slice(mesh.model_rank * n, (mesh.model_rank + 1) * n)
        self.weight = nn.Parameter(dense.weight.detach()[:, cols].clone())
        self.bias = nn.Parameter(dense.bias.detach().clone())
        self.mesh = mesh

    def forward(self, x):
        return self.mesh.model_sum(F.linear(x, self.weight)) + self.bias


def split_trunk(net: ActorCritic, mesh) -> ActorCritic:
    """Megatron's split of the trunk over ``model``, in place (the JAX
    trainer's layout, ``gymrl_tpu/algos/ppo.py:215-229``): ``shared_0`` by
    output units (its weight's rows and its bias), ``shared_1`` by input
    columns (``RowParallelDense``), whose partial products are summed over
    ``model``; everything after the sum is replicated. The trunk's input is
    the observation, which needs no gradient, so Megatron's other operator
    (identity forward, all-reduce backward) has nothing to do and is left
    out. A net with ``model_size == 1`` is returned whole."""
    m = mesh.model_size
    if m == 1:
        return net
    h = net.shared_0.out_features
    if h % m:
        raise ValueError(f"hidden {h} does not split over model={m} ranks")
    rows = slice(mesh.model_rank * (h // m), (mesh.model_rank + 1) * (h // m))
    s0 = Dense(net.shared_0.in_features, h // m, generator=torch.Generator())  # overwritten
    with torch.no_grad():
        s0.weight.copy_(net.shared_0.weight[rows])
        s0.bias.copy_(net.shared_0.bias[rows])
    net.shared_0 = s0
    net.shared_1 = RowParallelDense(net.shared_1, mesh)
    net.model_split = {"shared_0.weight": 0, "shared_0.bias": 0, "shared_1.weight": 1}
    return net


class PPOTrainState(NamedTuple):
    params: ActorCritic  # its parameters are the f32 master weights
    opt_state: torch.optim.Adam  # holds references to params' tensors
    vec_state: VecState
    obs_rms: RunningMeanStd
    noise: Noise  # the reference's `key`
    env_steps: int


class Rollout(NamedTuple):
    obs: torch.Tensor  # f32[T, B, obs] — normalized if cfg.normalize_obs
    action: torch.Tensor  # i32[T, B]
    logp: torch.Tensor  # f32[T, B]
    value: torch.Tensor  # f32[T, B]
    reward: torch.Tensor  # f32[T, B]
    next_obs: torch.Tensor  # f32[T, B, obs] — true successor (terminal at done)
    terminated: torch.Tensor  # f32[T, B]
    done: torch.Tensor  # f32[T, B]


class LossMetrics(dict):
    """The loss's metrics by name (``METRICS``), each a view of one ``[5]``
    tensor, ``vec``, which a grad step hands to the mesh and keeps."""

    def __init__(self, vec: torch.Tensor):
        super().__init__(zip(METRICS, vec.unbind()))
        self.vec = vec


def categorical_logp_entropy(logits, action):
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action.long()[..., None]).squeeze(-1)
    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1)
    return logp, entropy


def pick_action(logits, noise, deterministic: bool = False):
    """The action of ``logits``, i32: the greedy one, or a Gumbel-max draw
    from ``noise`` (``jax.random.categorical``'s own sampler)."""
    if not deterministic:
        logits = logits + noise.gumbel(logits.shape)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def gumbel_sample(logits, noise):
    """``(action, logp, entropy)`` of a Gumbel-max draw (``pick_action``)."""
    action = pick_action(logits, noise)
    return (action, *categorical_logp_entropy(logits, action))


def ppo_head_loss_plain(logits, values, action, logp_old, adv, returns, cfg):
    """The dual-clip PPO loss after the net (JAX: ``PPOTrainer._loss``,
    ``gymrl_tpu/algos/ppo.py``): ``(loss, metrics)`` with ``metrics`` the
    detached ``[5]`` vector of ``METRICS``. Autograd gives its gradient."""
    logp, entropy = categorical_logp_entropy(logits, action)
    ratio = torch.exp(logp - logp_old)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
    min_surr = torch.minimum(surr1, surr2)
    # dual-clip (ref :285-292)
    policy_obj = torch.where(
        adv < 0.0, torch.maximum(min_surr, cfg.dual_clip * adv), min_surr
    )
    policy_loss = -policy_obj.mean()
    value_loss = cfg.value_coef * torch.square(values - returns).mean()
    entropy_mean = entropy.mean()
    loss = policy_loss + value_loss - cfg.entropy_coef * entropy_mean
    clip_frac = ((ratio < 1.0 - cfg.clip_eps) | (ratio > 1.0 + cfg.clip_eps)).float().mean()
    approx_kl = (logp_old - logp).mean()
    metrics = torch.stack([policy_loss, value_loss, entropy_mean, clip_frac, approx_kl])
    return loss, metrics.detach()


def ppo_head_loss(logits, values, action, logp_old, adv, returns, cfg):
    """``(loss, metrics f32[5])`` of the loss head: the ``ppo_loss_fwd`` /
    ``ppo_loss_bwd`` kernels (``kernels.ppo.PPOHeadLoss``) when the logits
    are on a CUDA device, ``ppo_head_loss_plain`` on the CPU. On the card the
    action is the packed minibatch's float32 column."""
    if logits.device.type == "cpu":
        return ppo_head_loss_plain(logits, values, action, logp_old, adv, returns, cfg)
    return ppo_kernels.PPOHeadLoss.apply(logits, values, action, logp_old, adv, returns, cfg)


def forward_bf16(net: nn.Module, obs: torch.Tensor):
    """``net(obs)`` computed in bf16 with f32 outputs. The bf16 copies of the
    params are made inside the call, so gradients reach the f32 masters."""
    bf16 = torch.bfloat16
    cparams = {k: v.to(bf16) for k, v in net.named_parameters()}
    logits, value = functional_call(net, cparams, (obs.to(bf16),))
    return logits.float(), value.float()


class PPOTrainer(Trainer):
    def __init__(self, cfg: PPOConfig, device: str | torch.device = "cuda", mesh=None):
        if cfg.flat_optimizer:
            assert_flat_tp_ok(mesh)
        super().__init__(cfg, device, mesh)
        self._check_split(cfg.minibatch_size, "minibatch_size")
        self.venv = make_vec(cfg.env_name, self.local_envs)
        self.obs_dim = self.venv.env.obs_dim
        self.n_actions = self.venv.env.n_actions
        self.sweep_graph: SweepGraph | None = None  # made at the first sweep it runs
        self.rollout_graph: RolloutGraph | None = None  # made at the first rollout it runs

    # -- API ------------------------------------------------------------------
    def init(self, seed: int = 0) -> PPOTrainState:
        """Fresh state. Params come from a CPU generator seeded ``seed`` (the
        same weights on every device); env and training noise from a
        generator on the trainer's device."""
        cfg = self.cfg
        with span("trainer.init"):
            gen = torch.Generator().manual_seed(seed)
            net = ActorCritic(self.obs_dim, self.n_actions, cfg.hidden_dim, generator=gen)
            if self.mesh is not None:
                net = split_trunk(net, self.mesh)
            net = net.to(self.device)
            noise = self._noise(seed)
            return PPOTrainState(
                params=net,
                opt_state=adam(list(net.parameters()), cfg.lr, cfg.adam_eps,
                               foreach=cfg.flat_optimizer),
                vec_state=self.venv.reset(noise),
                obs_rms=rms_init((self.obs_dim,), self.device),
                noise=noise,
                env_steps=0,
            )

    @torch.no_grad()
    def policy(self, ts: PPOTrainState, obs, noise, deterministic: bool = True):
        obs = self._norm(ts.obs_rms, obs)
        logits, _ = ts.params(obs)
        return pick_action(logits, noise, deterministic)

    def train_iter(self, ts: PPOTrainState,
                   timer: PhaseTimer | None = None) -> tuple[PPOTrainState, IterOut]:
        """One iteration; updates ``ts.params`` / ``ts.opt_state`` in place.

        ``timer``, if given, is called with "rollout", "gae" and "sgd" as
        each phase ends (chip_smoke.py times the phases with CUDA events).
        With ``utils.profiling``'s tracing on, the iteration is a
        ``train_iter`` span, and its ``rollout``, ``gae`` and ``sgd`` spans
        each close just before their phase's ``timer`` call. On the graph
        route the returned ``vec_state`` and ``obs_rms`` are the graph's
        carry (``_rollout_route``).
        """
        cfg = self.cfg
        mark = timer or (lambda phase: None)
        with span("train_iter"):
            (vec_state, obs_rms), roll, stats = self._collect(ts)
            mark("rollout")

            with torch.no_grad(), span("gae"):
                # Values of true successors in ONE batched forward (bootstrap for
                # truncation; terminated steps are masked by (1-dw) inside GAE).
                next_nobs = self._norm(obs_rms, roll.next_obs)
                _, next_values = self._rollout_forward(
                    ts.params, next_nobs.reshape(-1, self.obs_dim)
                )
                next_values = next_values.reshape(roll.value.shape)
                adv, v_target = compute_gae(
                    roll.reward, roll.value, next_values, roll.terminated, roll.done,
                    cfg.gamma, cfg.gae_lambda,
                )
                # every rank's env columns, in rank order: the unsharded rollout
                obs, action, logp, adv, v_target, stats = self._gather(
                    (roll.obs, roll.action, roll.logp, adv, v_target, stats), axis=1)
                adv = standardize(adv)  # rollout-wide (ref :236)

                # The loss reads (obs, action, logp, adv, v_target): pack them into
                # ONE [N, obs+4] matrix so each epoch's shuffle is one row gather.
                # Actions round-trip exactly through f32.
                n = cfg.batch_total
                packed = torch.cat(
                    [
                        obs.reshape(n, self.obs_dim),
                        action.reshape(n, 1).float(),
                        logp.reshape(n, 1),
                        adv.reshape(n, 1),
                        v_target.reshape(n, 1),
                    ],
                    dim=1,
                )
            mark("gae")

            with span("sgd"):
                lr = self._lr(ts.env_steps)
                for group in ts.opt_state.param_groups:
                    group["lr"] = lr
                perms = ts.noise.permutations(cfg.num_epochs, n)
                metrics = self._sgd(ts, packed, perms)
            mark("sgd")

            new_ts = ts._replace(vec_state=vec_state, obs_rms=obs_rms, env_steps=ts.env_steps + n)
            return new_ts, self._iter_out(stats, metrics, lr=lr)

    # -- internals ------------------------------------------------------------
    def _norm(self, rms, obs):
        return normalize_obs(rms, obs) if self.cfg.normalize_obs else obs

    def _rollout_forward(self, net, obs):
        """Policy forward on the (no-grad) rollout path."""
        if self.cfg.rollout_bf16:
            return forward_bf16(net, obs)
        return net(obs)

    def _lr(self, env_steps: int) -> float:
        """lr for this iteration (ref :337-341), computed in float32 as the
        reference computes it."""
        lr = np.float32(self.cfg.lr)
        if self.cfg.anneal_lr:
            frac = np.float32(1.0) - np.float32(env_steps) / np.float32(self.cfg.max_train_steps)
            lr = lr * np.maximum(frac, np.float32(0.0))
        return float(lr)

    def _collect(self, ts: PPOTrainState):
        """The T-step rollout (``_rollout_route``): ``((vec_state, obs_rms),
        Rollout, (final_return, final_length, done))``."""

        def step(carry):
            vec_state, obs_rms = carry
            with span("policy"):
                nobs = self._norm(obs_rms, vec_state.obs)
                logits, value = self._rollout_forward(ts.params, nobs)
                action, logp, _ = gumbel_sample(logits, ts.noise)
            vec_state, tr = self.venv.step(vec_state, action, ts.noise)
            if self.cfg.normalize_obs:  # statistics of the whole env batch
                obs_rms = rms_update_batch(obs_rms, self._gather(tr.next_obs))
            roll = Rollout(obs=nobs, action=action, logp=logp, value=value, reward=tr.reward,
                           next_obs=tr.next_obs, terminated=tr.terminated.float(),
                           done=tr.done.float())
            return (vec_state, obs_rms), (roll, (tr.final_return, tr.final_length, tr.done))

        return self._rollout_route(ts.params, ts.noise, (ts.vec_state, ts.obs_rms), step)

    def _loss(self, net, obs, action, logp_old, adv, returns):
        """The minibatch loss and its metrics: the net (f32, or bf16 with
        ``sgd_bf16``), then the dual-clip head (``ppo_head_loss``: the
        ``ppo_loss_fwd`` / ``ppo_loss_bwd`` kernels on the card, the plain
        head on the CPU). ``action`` may be the packed float column."""
        if self.cfg.sgd_bf16:
            logits, values = forward_bf16(net, obs)
        else:
            logits, values = net(obs)
        loss, vec = ppo_head_loss(logits, values, action, logp_old, adv, returns, self.cfg)
        return loss, LossMetrics(vec)

    def _sgd(self, ts: PPOTrainState, packed: torch.Tensor, perms: torch.Tensor):
        """Epochs of shuffled minibatches; returns metrics averaged over all
        gradient steps. On a CUDA device without a mesh, while ``graphs``
        is on, the sweep is one replay of a captured CUDA graph
        (``_sweep_route``, ``SweepGraph``); else eager."""
        means = self._sweep_route(ts, lambda x: self._sweep(ts, x["packed"], x["perms"]),
                                  {"packed": packed, "perms": perms})
        return dict(zip(METRICS, means.unbind()))

    def _sweep(self, ts: PPOTrainState, packed: torch.Tensor,
               perms: torch.Tensor) -> torch.Tensor:
        """The eager sweep (``sweep``): ``_minibatch_step`` on every minibatch
        of every epoch; the metrics' means over the grad steps, ``[5]``."""
        return sweep(packed, perms, self.cfg.num_minibatches,
                     lambda epoch, i, mb: self._minibatch_step(ts, mb))

    def _minibatch_step(self, ts: PPOTrainState, mb: torch.Tensor) -> torch.Tensor:
        """One clipped Adam step on the packed rows ``mb``; returns its
        metrics, ``[5]`` in ``METRICS`` order. The loss reads its columns
        where they lie in the rows; the clip and Adam are one ``clip_adam_``.
        Under a mesh the rank takes its share of the rows; gradients and
        metrics are averaged over ``data`` in one all-reduce, and the clip
        reads the norm of the whole (split) net."""
        cfg, mesh, net, opt = self.cfg, self.mesh, ts.params, ts.opt_state
        d = self.obs_dim
        mb = self._share(mb)
        loss, metrics = self._loss(
            net, mb[:, :d], mb[:, d], mb[:, d + 1], mb[:, d + 2], mb[:, d + 3])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        names, params = zip(*net.named_parameters())
        grads = [p.grad for p in params]
        if mesh is not None:
            mesh.mean_(grads + [metrics.vec])
        clip_adam_(opt, grads, cfg.max_grad_norm, mesh, [n in net.model_split for n in names])
        return metrics.vec
