"""Off-policy DDPG, TD3, SAC and discrete SAC (counterpart of
``gymrl_tpu/algos/continuous.py``).

Reference parity, unchanged from the JAX trainers (each pins its script's
hyperparameters through the presets at the end):
  * DDPG — deterministic tanh actor ·bound, Q(s, a) critic on concat,
    exploration N(0, 0.1·bound), soft updates τ=0.005 of both nets every
    update, batch 128, γ=0.99, lr 1e-3.
  * TD3 — twin critic (``q1``/``q2``), target smoothing N(0, 0.2) clipped
    ±0.5 then clipped to the bounds, actor and targets updated every 2nd
    critic step; off-steps leave the actor, its Adam and the targets as
    they were.
  * SAC — squashed-Gaussian actor (log_std clamped to [−20, 2], tanh
    log-prob correction), twin critic, target min(Q1, Q2) − α·logπ from the
    pre-update actor, auto-α with target entropy −dim(A) and loss
    −logα·(logπ + H̄).detach(), τ=0.005, batch 128, lrs 3e-4, α0 = 0.2.
  * SACD (discrete) — softmax actor, two per-action critics with their own
    Adams and targets, expectation-form targets Σπ·min(Q1, Q2) + α·H,
    α-loss mean(α·(H − H̄).detach()), target entropy −1.

One ``train_iter`` is ``steps_per_iter`` env steps, each: act → ``VecEnv.step``
→ ring push → (once the replay holds a batch) ``n_updates`` updates, each
on its own sampled minibatch. Every network has its own Adam (eps 1e-8), as
the reference keeps separate optimizers. Every update keeps the reference's
order of dependencies: the actor loss reads the critic the same update just
stepped. Only ``size >= batch_size`` and TD3's ``learn_step % policy_freq``
(Python ints) branch on the host. Every draw comes from ``ts.noise`` in the
reference's order.

Under a ``mesh`` each data rank acts for its share of the envs; each env
step's transitions are gathered, so every rank pushes the whole batch and
holds the same replay. Sampled indices are shared draws: every rank samples
the same minibatch and takes its share of it (and of the update's normals).
Each network's gradients are averaged over ``data`` before its step, and
the metrics after the update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch import nn

from gymrl_tpu_torch.algos.base import (
    IterOut, PhaseTimer, Trainer, adam, frozen_copy, mesh_mean, set_grads, soft_update,
)
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs.registry import make_vec
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.nn.layers import Dense
from gymrl_tpu_torch.replay.uniform import (
    ReplayState, replay_init, replay_push_batch, replay_sample,
)

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2.0 * math.pi)


# -- networks -----------------------------------------------------------------
# Submodule names are the flax modules', so weights map across by name
# (``interop.params_from_flax``). Dense layers take the reference's default
# init (kaiming-uniform, zero bias).

class DeterministicActor(nn.Module):
    """tanh(MLP)·bound (DDPG/TD3 actor)."""

    def __init__(self, obs_dim: int, act_dim: int, action_bound: float,
                 hidden_dim: int = 256, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.action_bound = action_bound
        self.fc1 = Dense(obs_dim, hidden_dim, generator=g)
        self.fc2 = Dense(hidden_dim, hidden_dim, generator=g)
        self.head = Dense(hidden_dim, act_dim, generator=g)

    def forward(self, x):
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return torch.tanh(self.head(x)) * self.action_bound


class QCritic(nn.Module):
    """Q(s, a) on concat."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.fc1 = Dense(obs_dim + act_dim, hidden_dim, generator=g)
        self.fc2 = Dense(hidden_dim, hidden_dim, generator=g)
        self.head = Dense(hidden_dim, 1, generator=g)

    def forward(self, s, a):
        x = torch.cat([s, a], dim=-1)
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return self.head(x).squeeze(-1)


class TwinQCritic(nn.Module):
    """Two Q heads in one module; ``q1`` alone is the TD3 actor's critic."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.q1 = QCritic(obs_dim, act_dim, hidden_dim, generator)
        self.q2 = QCritic(obs_dim, act_dim, hidden_dim, generator)

    def forward(self, s, a):
        return self.q1(s, a), self.q2(s, a)


class SquashedGaussianActor(nn.Module):
    """SAC actor: mean and clamped log_std of a tanh-squashed Normal."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.fc1 = Dense(obs_dim, hidden_dim, generator=g)
        self.fc2 = Dense(hidden_dim, hidden_dim, generator=g)
        self.mean = Dense(hidden_dim, act_dim, generator=g)
        self.log_std = Dense(hidden_dim, act_dim, generator=g)

    def forward(self, x):
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return self.mean(x), torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX)


def squashed_sample(mean, log_std, bound: float, eps):
    """rsample with the standard normals ``eps``, tanh squash and log-prob
    correction — the reference's formula, term for term (sac_pendulum.py:76-87)."""
    std = torch.exp(log_std)
    x = mean + std * eps
    tanh_x = torch.tanh(x)
    action = tanh_x * bound
    logp = -0.5 * (torch.square((x - mean) / std) + 2.0 * log_std + _LOG_2PI)
    logp = logp - torch.log(bound * (1.0 - torch.square(tanh_x)) + 1e-6)
    return action, logp.sum(dim=-1)


class SoftmaxActor(nn.Module):
    """Discrete SAC actor: softmax over actions."""

    def __init__(self, obs_dim: int, n_actions: int, hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.fc1 = Dense(obs_dim, hidden_dim, generator=g)
        self.fc2 = Dense(hidden_dim, hidden_dim, generator=g)
        self.fc3 = Dense(hidden_dim, n_actions, generator=g)

    def forward(self, x):
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return torch.softmax(self.fc3(x), dim=-1)


class PerActionQ(nn.Module):
    """Discrete critic: the vector Q(s, ·)."""

    def __init__(self, obs_dim: int, n_actions: int, hidden_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.fc1 = Dense(obs_dim, hidden_dim, generator=g)
        self.fc2 = Dense(hidden_dim, hidden_dim, generator=g)
        self.fc3 = Dense(hidden_dim, n_actions, generator=g)

    def forward(self, x):
        return self.fc3(torch.relu(self.fc2(torch.relu(self.fc1(x)))))


# -- shared off-policy machinery ---------------------------------------------

class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor  # f32[act_dim], or i32 for discrete SAC
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor  # f32 — all four scripts bootstrap on done (incl. truncation)


@dataclass(frozen=True)
class OffPolicyConfig:
    env_name: str = "Pendulum-v1"
    num_envs: int = 16
    steps_per_iter: int = 32
    batch_size: int = 128
    gamma: float = 0.99
    tau: float = 0.005
    lr_actor: float = 1e-3
    lr_critic: float = 1e-3
    lr_alpha: float = 3e-4
    hidden_dim: int = 256
    memory_capacity: int = 100_000
    exploration_noise: float = 0.1  # ·bound (DDPG/TD3)
    policy_noise: float = 0.2  # TD3 target smoothing
    noise_clip: float = 0.5
    policy_freq: int = 2  # TD3 delayed updates
    init_alpha: float = 0.2  # SAC
    target_entropy: float | None = None  # None ⇒ −act_dim (SAC) / −1.0 (SACD)
    updates_per_step: int | None = None
    max_train_steps: int = 500_000
    solve_threshold: float | None = None

    @property
    def n_updates(self) -> int:
        return self.num_envs if self.updates_per_step is None else self.updates_per_step


class OffPolicyTrainState(NamedTuple):
    nets: dict[str, Any]  # modules, plus SAC's 0-dim "log_alpha" parameter
    targets: dict[str, nn.Module]  # no grads; moved in place
    opts: dict[str, torch.optim.Adam]  # one per entry of ``nets``
    replay: ReplayState
    vec_state: VecState
    noise: Noise  # the reference's `key`
    env_steps: int
    learn_steps: int


def _params(x) -> list[torch.Tensor]:
    return list(x.parameters()) if isinstance(x, nn.Module) else [x]


class OffPolicyContinuousTrainer(Trainer):
    """Shared loop; subclasses define the nets, acting, the update and the
    metric names."""

    target_names: tuple[str, ...] = ()  # the nets that have a target copy
    metric_names: tuple[str, ...] = ()

    def __init__(self, cfg: OffPolicyConfig, device: str | torch.device = "cuda", mesh=None):
        super().__init__(cfg, device, mesh)
        self._check_split(cfg.batch_size, "batch_size")
        self.venv = make_vec(cfg.env_name, self.local_envs)
        env = self.venv.env
        self.obs_dim = env.obs_dim
        self._act_dim = env.act_dim  # None for a discrete env
        self.bound = env.action_bound
        self.n_actions = env.n_actions

    def _make_nets(self, gen: torch.Generator) -> tuple[dict, dict]:
        """(nets, learning rates) for a fresh state."""
        raise NotImplementedError

    def _act(self, nets, obs, noise, deterministic: bool):
        raise NotImplementedError

    def _update(self, ts: OffPolicyTrainState, batch: Transition, learn_step: int,
                noise) -> list[torch.Tensor]:
        """One update on ``batch``, in place; returns the metrics in
        ``metric_names`` order."""
        raise NotImplementedError

    def init(self, seed: int = 0) -> OffPolicyTrainState:
        """Fresh state. Params come from a CPU generator seeded ``seed`` (the
        same weights on every device); env and training noise from a
        generator on the trainer's device."""
        cfg = self.cfg
        nets, lrs = self._make_nets(torch.Generator().manual_seed(seed))
        nets = {k: v.to(self.device) if isinstance(v, nn.Module)
                else nn.Parameter(v.to(self.device)) for k, v in nets.items()}
        targets = {k: frozen_copy(nets[k]) for k in self.target_names}
        opts = {k: adam(_params(v), lrs[k], 1e-8, foreach=True) for k, v in nets.items()}
        act_example = (torch.zeros(self._act_dim) if self._act_dim
                       else torch.zeros((), dtype=torch.int32))
        example = Transition(
            obs=torch.zeros(self.obs_dim), action=act_example, reward=torch.zeros(()),
            next_obs=torch.zeros(self.obs_dim), done=torch.zeros(()),
        )
        noise = self._noise(seed)
        return OffPolicyTrainState(
            nets=nets, targets=targets, opts=opts,
            replay=replay_init(example, cfg.memory_capacity, self.device),
            vec_state=self.venv.reset(noise), noise=noise, env_steps=0, learn_steps=0,
        )

    @torch.no_grad()
    def policy(self, ts: OffPolicyTrainState, obs, noise, deterministic: bool = True):
        return self._act(ts.nets, obs, noise, deterministic)

    def train_iter(self, ts: OffPolicyTrainState,
                   timer: PhaseTimer | None = None) -> tuple[OffPolicyTrainState, IterOut]:
        """One iteration; updates the nets, targets and optimizers held by
        ``ts`` in place.

        ``timer``, if given, is called with "act" (act, env step and push)
        and "update" (the updates) as each phase of each env step ends.
        """
        cfg = self.cfg
        mark = timer or (lambda phase: None)
        replay, vec_state, learn_steps = ts.replay, ts.vec_state, ts.learn_steps
        zeros = torch.zeros(len(self.metric_names), device=self.device)
        stats, metrics = [], []
        for _ in range(cfg.steps_per_iter):
            with torch.no_grad():
                action = self._act(ts.nets, vec_state.obs, ts.noise, deterministic=False)
            vec_state, tr = self.venv.step(vec_state, action, ts.noise)
            # every rank's envs, in rank order: every rank pushes the whole batch
            tr = self._gather(tr)
            replay = replay_push_batch(replay, Transition(
                obs=tr.obs, action=tr.action, reward=tr.reward,
                next_obs=tr.next_obs, done=tr.done.float(),
            ))
            mark("act")

            if replay.size >= cfg.batch_size:
                step_metrics = []
                for _ in range(cfg.n_updates):
                    batch = self._share(replay_sample(replay, ts.noise, cfg.batch_size))
                    step_metrics.append(torch.stack(mesh_mean(
                        self._update(ts, batch, learn_steps, ts.noise), self.mesh)))
                    learn_steps += 1
                metrics.append(torch.stack(step_metrics).mean(dim=0))
            else:
                metrics.append(zeros)
            mark("update")
            stats.append((tr.final_return, tr.final_length, tr.done))

        stats = [torch.stack(f) for f in zip(*stats)]
        new_ts = ts._replace(replay=replay, vec_state=vec_state, learn_steps=learn_steps,
                             env_steps=ts.env_steps + cfg.steps_per_iter * cfg.num_envs)
        means = torch.stack(metrics).mean(dim=0)
        return new_ts, self._iter_out(stats, dict(zip(self.metric_names, means.unbind())))

    def _step(self, opt: torch.optim.Adam, params: list[torch.Tensor], loss: torch.Tensor) -> None:
        set_grads(params, loss, self.mesh)
        opt.step()


# -- DDPG ---------------------------------------------------------------------

class DDPGTrainer(OffPolicyContinuousTrainer):
    target_names = ("actor", "critic")
    metric_names = ("actor_loss", "critic_loss")

    def _make_nets(self, gen):
        nets = {
            "actor": DeterministicActor(self.obs_dim, self._act_dim, self.bound,
                                        self.cfg.hidden_dim, gen),
            "critic": QCritic(self.obs_dim, self._act_dim, self.cfg.hidden_dim, gen),
        }
        return nets, {"actor": self.cfg.lr_actor, "critic": self.cfg.lr_critic}

    def _act(self, nets, obs, noise, deterministic):
        a = nets["actor"](obs)
        if deterministic:
            return a
        n = noise.action_noise(a.shape) * self.cfg.exploration_noise * self.bound
        return torch.clamp(a + n, -self.bound, self.bound)

    def _critic_target(self, ts, batch, noise):
        with torch.no_grad():
            next_a = ts.targets["actor"](batch.next_obs)
            next_q = ts.targets["critic"](batch.next_obs, next_a)
            return batch.reward + self.cfg.gamma * next_q * (1.0 - batch.done)

    def _update(self, ts, batch, learn_step, noise):
        cfg = self.cfg
        actor, critic = ts.nets["actor"], ts.nets["critic"]
        c_loss = self._critic_step(ts, batch, noise)
        # the actor loss reads the critic this update just stepped
        a_loss = self._actor_loss(actor, critic, batch)
        self._step(ts.opts["actor"], _params(actor), a_loss)
        soft_update(_params(ts.targets["actor"]), _params(actor), cfg.tau)
        soft_update(_params(ts.targets["critic"]), _params(critic), cfg.tau)
        return [a_loss.detach(), c_loss]

    def _critic_step(self, ts, batch, noise) -> torch.Tensor:
        critic = ts.nets["critic"]
        c_loss = self._critic_loss(critic, batch, self._critic_target(ts, batch, noise))
        self._step(ts.opts["critic"], _params(critic), c_loss)
        return c_loss.detach()

    def _critic_loss(self, critic, batch, target):
        return torch.square(critic(batch.obs, batch.action) - target).mean()

    def _actor_loss(self, actor, critic, batch):
        return -critic(batch.obs, actor(batch.obs)).mean()


# -- TD3 ----------------------------------------------------------------------

class TD3Trainer(DDPGTrainer):
    """DDPG's update with a twin critic, target smoothing and a delayed actor.

    On off-steps the reference computes the actor update and discards it:
    params, Adam moments and count, and the targets stay as they were. Here
    the actor's backward and Adam step are skipped, which leaves the same
    state; the actor-loss forward still runs, because its value is averaged
    into the iteration's ``actor_loss`` on every learn step.
    """

    def _make_nets(self, gen):
        nets = {
            "actor": DeterministicActor(self.obs_dim, self._act_dim, self.bound,
                                        self.cfg.hidden_dim, gen),
            "critic": TwinQCritic(self.obs_dim, self._act_dim, self.cfg.hidden_dim, gen),
        }
        return nets, {"actor": self.cfg.lr_actor, "critic": self.cfg.lr_critic}

    def _critic_target(self, ts, batch, noise):
        cfg = self.cfg
        with torch.no_grad():
            # target policy smoothing (td3_pendulum.py:194-200)
            smooth = torch.clamp(noise.target_noise(batch.action.shape) * cfg.policy_noise,
                                 -cfg.noise_clip, cfg.noise_clip)
            next_a = torch.clamp(ts.targets["actor"](batch.next_obs) + smooth,
                                 -self.bound, self.bound)
            tq1, tq2 = ts.targets["critic"](batch.next_obs, next_a)
            return batch.reward + cfg.gamma * torch.minimum(tq1, tq2) * (1.0 - batch.done)

    def _critic_loss(self, critic, batch, target):
        q1, q2 = critic(batch.obs, batch.action)
        return torch.square(q1 - target).mean() + torch.square(q2 - target).mean()

    def _actor_loss(self, actor, critic, batch):
        return -critic.q1(batch.obs, actor(batch.obs)).mean()

    def _update(self, ts, batch, learn_step, noise):
        if learn_step % self.cfg.policy_freq == 0:
            return super()._update(ts, batch, learn_step, noise)
        # off-step: the critic steps; the actor loss is only evaluated
        c_loss = self._critic_step(ts, batch, noise)
        with torch.no_grad():
            a_loss = self._actor_loss(ts.nets["actor"], ts.nets["critic"], batch)
        return [a_loss, c_loss]


# -- SAC (continuous) ---------------------------------------------------------

class SACTrainer(OffPolicyContinuousTrainer):
    target_names = ("critic",)
    metric_names = ("actor_loss", "critic_loss", "alpha_loss", "alpha")

    def __init__(self, cfg: OffPolicyConfig, device: str | torch.device = "cuda", mesh=None):
        super().__init__(cfg, device, mesh)
        self.target_entropy = (
            cfg.target_entropy if cfg.target_entropy is not None else -float(self._act_dim)
        )

    def _make_nets(self, gen):
        cfg = self.cfg
        nets = {
            "actor": SquashedGaussianActor(self.obs_dim, self._act_dim, cfg.hidden_dim, gen),
            "critic": TwinQCritic(self.obs_dim, self._act_dim, cfg.hidden_dim, gen),
            "log_alpha": torch.tensor(math.log(cfg.init_alpha), dtype=torch.float32),
        }
        return nets, {"actor": cfg.lr_actor, "critic": cfg.lr_critic, "log_alpha": cfg.lr_alpha}

    def _act(self, nets, obs, noise, deterministic):
        mean, log_std = nets["actor"](obs)
        if deterministic:
            return torch.tanh(mean) * self.bound
        a, _ = squashed_sample(mean, log_std, self.bound, noise.action_noise(mean.shape))
        return a

    def _update(self, ts, batch, learn_step, noise):
        cfg = self.cfg
        actor, critic, log_alpha = ts.nets["actor"], ts.nets["critic"], ts.nets["log_alpha"]
        eps_next, eps_new = noise.sac_update_noise(batch.action.shape)
        alpha = torch.exp(log_alpha.detach())

        with torch.no_grad():  # the target reads the actor before its step
            mean, log_std = actor(batch.next_obs)
            next_a, next_logp = squashed_sample(mean, log_std, self.bound, eps_next)
            tq1, tq2 = ts.targets["critic"](batch.next_obs, next_a)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch.reward + cfg.gamma * (1.0 - batch.done) * target_v
        q1, q2 = critic(batch.obs, batch.action)
        c_loss = torch.square(q1 - target).mean() + torch.square(q2 - target).mean()
        self._step(ts.opts["critic"], _params(critic), c_loss)

        mean, log_std = actor(batch.obs)
        a, logp = squashed_sample(mean, log_std, self.bound, eps_new)
        q1, q2 = critic(batch.obs, a)
        a_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        self._step(ts.opts["actor"], _params(actor), a_loss)

        # auto-α: loss = −logα·(logπ + H̄).detach() (sac_pendulum.py:257-259)
        al_loss = -(log_alpha * (logp.detach() + self.target_entropy)).mean()
        self._step(ts.opts["log_alpha"], [log_alpha], al_loss)

        soft_update(_params(ts.targets["critic"]), _params(critic), cfg.tau)
        return [a_loss.detach(), c_loss.detach(), al_loss.detach(),
                torch.exp(log_alpha.detach())]


# -- SAC (discrete) -----------------------------------------------------------

class DiscreteSACTrainer(OffPolicyContinuousTrainer):
    """sac_cartpole.py: expectation-form targets, two separate critics."""

    target_names = ("critic1", "critic2")
    metric_names = ("actor_loss", "critic_loss", "alpha_loss", "alpha")

    def __init__(self, cfg: OffPolicyConfig, device: str | torch.device = "cuda", mesh=None):
        super().__init__(cfg, device, mesh)
        self.target_entropy = cfg.target_entropy if cfg.target_entropy is not None else -1.0

    def _make_nets(self, gen):
        cfg = self.cfg
        nets = {
            "actor": SoftmaxActor(self.obs_dim, self.n_actions, cfg.hidden_dim, gen),
            "critic1": PerActionQ(self.obs_dim, self.n_actions, cfg.hidden_dim, gen),
            "critic2": PerActionQ(self.obs_dim, self.n_actions, cfg.hidden_dim, gen),
            "log_alpha": torch.tensor(math.log(cfg.init_alpha), dtype=torch.float32),
        }
        lrs = {"actor": cfg.lr_actor, "critic1": cfg.lr_critic, "critic2": cfg.lr_critic,
               "log_alpha": cfg.lr_alpha}
        return nets, lrs

    def _act(self, nets, obs, noise, deterministic):
        probs = nets["actor"](obs)
        if deterministic:
            return torch.argmax(probs, dim=-1).to(torch.int32)
        # jax.random.categorical: argmax(logits + Gumbel)
        logits = torch.log(probs + 1e-8)
        return torch.argmax(logits + noise.gumbel(logits.shape), dim=-1).to(torch.int32)

    def _update(self, ts, batch, learn_step, noise):
        cfg = self.cfg
        actor, log_alpha = ts.nets["actor"], ts.nets["log_alpha"]
        alpha = torch.exp(log_alpha.detach())

        # expectation-form target from the actor before its step (sac_cartpole.py:172-183)
        with torch.no_grad():
            next_probs = actor(batch.next_obs)
            next_logp = torch.log(next_probs + 1e-8)
            next_h = -(next_probs * next_logp).sum(dim=-1)
            tq1 = ts.targets["critic1"](batch.next_obs)
            tq2 = ts.targets["critic2"](batch.next_obs)
            min_next_q = (next_probs * torch.minimum(tq1, tq2)).sum(dim=-1)
            target = batch.reward + cfg.gamma * (1.0 - batch.done) * (min_next_q + alpha * next_h)

        action = batch.action.long()[:, None]
        c_losses = []
        for name in ("critic1", "critic2"):
            critic = ts.nets[name]
            q = critic(batch.obs).gather(-1, action).squeeze(-1)
            c_loss = torch.square(q - target).mean()
            self._step(ts.opts[name], _params(critic), c_loss)
            c_losses.append(c_loss.detach())

        probs = actor(batch.obs)
        logp = torch.log(probs + 1e-8)
        h = -(probs * logp).sum(dim=-1)
        with torch.no_grad():  # both critics after their steps
            q1 = ts.nets["critic1"](batch.obs)
            q2 = ts.nets["critic2"](batch.obs)
        min_q = (probs * torch.minimum(q1, q2)).sum(dim=-1)
        a_loss = (-alpha * h - min_q).mean()
        self._step(ts.opts["actor"], _params(actor), a_loss)

        # α-loss sign convention: mean(α·(H − H̄).detach()) (sac_cartpole.py:211-213)
        al_loss = (torch.exp(log_alpha) * (h.detach() - self.target_entropy)).mean()
        self._step(ts.opts["log_alpha"], [log_alpha], al_loss)

        for name in self.target_names:
            soft_update(_params(ts.targets[name]), _params(ts.nets[name]), cfg.tau)
        return [a_loss.detach(), c_losses[0] + c_losses[1], al_loss.detach(),
                torch.exp(log_alpha.detach())]


# -- presets ------------------------------------------------------------------

def ddpg_config(**kw) -> OffPolicyConfig:
    base = dict(env_name="Pendulum-v1", batch_size=128, lr_actor=1e-3, lr_critic=1e-3)
    base.update(kw)
    return OffPolicyConfig(**base)


def td3_config(**kw) -> OffPolicyConfig:
    return ddpg_config(**kw)


def sac_config(**kw) -> OffPolicyConfig:
    base = dict(
        env_name="Pendulum-v1", batch_size=128,
        lr_actor=3e-4, lr_critic=3e-4, lr_alpha=3e-4, init_alpha=0.2,
    )
    base.update(kw)
    return OffPolicyConfig(**base)


def sac_discrete_config(**kw) -> OffPolicyConfig:
    base = dict(
        env_name="CartPole-v1", batch_size=64, memory_capacity=10_000,
        lr_actor=1e-3, lr_critic=1e-3, lr_alpha=1e-3, init_alpha=0.01,
        target_entropy=-1.0, solve_threshold=495.0,
    )
    base.update(kw)
    return OffPolicyConfig(**base)
