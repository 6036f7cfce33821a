"""Plain PyTorch PPO on a batched env: the yardstick's reference.

A frozen copy of the port's plain paths, which later changes to the program
do not change, with nothing of the program imported:

  * the net and its init: ``gymrl_tpu_torch/algos/ppo.py`` ``ActorCritic``
    :113-140 (gymRL ``algorithms/ppo_lunarlander.py:63-118``), its weights
    from a CPU generator seeded with the run's seed through
    ``torch.nn.init.orthogonal_`` in the module's order
    (``nn/initializers.py`` :45-49, ``nn/layers.py`` ``Dense``), biases zero;
    the bf16 forward of ``forward_bf16`` :255-261;
  * one iteration, ``PPOTrainer.train_iter`` :305-365 with ``_collect``
    :386-410, ``_lr`` :377-384, ``_sweep`` / ``_minibatch_step`` :441-474:
    the rollout (forward, Gumbel-max draw, env step with autoreset), the
    next-value forward, GAE (``core/gae.py`` :16-35) and the rollout-wide
    standardization (:55-58), the packed rows, the epochs' permutations;
  * the update: the dual-clip loss head ``ppo_head_loss_plain`` :222-242
    under autograd, optax's global-norm clip
    (``algos/base.py`` ``clip_grads_by_global_norm_`` :94-114) and
    ``torch.optim.Adam`` with its state made at construction (``adam``
    :222-234).

``Reference(cfg, seed, device, f32_matmul, env)`` is a side of the
comparison (``benchlib/compare.py``): ``iterate`` runs one iteration and
returns the five loss metrics averaged over its grad steps, its finished
episodes and its packed rows; ``leaves`` and ``moments`` read the net and
Adam's first moments. ``env`` is the reference's env class, named by the
configuration (``reference.lander:VecLander``), whose ``obs_dim`` and
``n_actions`` size the net. ``f32_matmul`` ``"tf32"`` computes the float32
products in TF32, the precision below the configuration's (the control of
the comparison); ``"ieee"`` keeps full float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.draws import Draws

METRICS = ("policy_loss", "value_loss", "entropy", "clip_frac", "approx_kl")
LAYERS = (("shared_0", "in", "h", 2 ** 0.5), ("shared_1", "h", "h", 2 ** 0.5),
          ("actor_0", "h", "h", 2 ** 0.5), ("actor_head", "h", "a", 0.01),
          ("critic_0", "h", "h", 2 ** 0.5), ("critic_head", "h", "v", 1.0))


class Net(nn.Module):
    """The shared tanh trunk and the tanh actor and critic heads."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int, seed: int):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        sizes = {"in": obs_dim, "h": hidden, "a": n_actions, "v": 1}
        for name, fan_in, fan_out, gain in LAYERS:
            w = torch.empty(sizes[fan_out], sizes[fan_in])
            torch.nn.init.orthogonal_(w, gain, generator=gen)
            self.register_parameter(f"{name}_weight", nn.Parameter(w))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(sizes[fan_out])))

    def leaves(self) -> dict[str, torch.Tensor]:
        """Parameters by the program's names (``shared_0.weight``, ...)."""
        return {k.replace("_weight", ".weight").replace("_bias", ".bias"): v
                for k, v in self.named_parameters()}

    def forward(self, x, dtype=torch.float32):
        p = {k: (v if v.dtype == dtype else v.to(dtype)) for k, v in self.leaves().items()}
        x = x if x.dtype == dtype else x.to(dtype)

        def dense(name, h):
            return F.linear(h, p[f"{name}.weight"], p[f"{name}.bias"])

        trunk = torch.tanh(dense("shared_1", torch.tanh(dense("shared_0", x))))
        logits = dense("actor_head", torch.tanh(dense("actor_0", trunk)))
        value = dense("critic_head", torch.tanh(dense("critic_0", trunk)))
        return logits.float(), value.squeeze(-1).float()


def logp_entropy(logits, action):
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action.long()[..., None]).squeeze(-1)
    return logp, -(torch.exp(logp_all) * logp_all).sum(dim=-1)


def head_loss(logits, values, action, logp_old, adv, returns, cfg):
    logp, entropy = logp_entropy(logits, action)
    ratio = torch.exp(logp - logp_old)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg["clip_eps"], 1.0 + cfg["clip_eps"]) * adv
    min_surr = torch.minimum(surr1, surr2)
    policy_obj = torch.where(adv < 0.0, torch.maximum(min_surr, cfg["dual_clip"] * adv), min_surr)
    policy_loss = -policy_obj.mean()
    value_loss = cfg["value_coef"] * torch.square(values - returns).mean()
    entropy_mean = entropy.mean()
    loss = policy_loss + value_loss - cfg["entropy_coef"] * entropy_mean
    clip_frac = ((ratio < 1.0 - cfg["clip_eps"]) | (ratio > 1.0 + cfg["clip_eps"])).float().mean()
    approx_kl = (logp_old - logp).mean()
    return loss, torch.stack([policy_loss, value_loss, entropy_mean, clip_frac, approx_kl]).detach()


def gae(rewards, values, next_values, terminated, done, gamma, lam):
    deltas = rewards + gamma * next_values * (1.0 - terminated) - values
    decay = gamma * lam * (1.0 - done)
    advantages = torch.empty_like(deltas)
    adv = torch.zeros_like(deltas[0])
    for t in reversed(range(deltas.shape[0])):
        adv = deltas[t] + decay[t] * adv
        advantages[t] = adv
    return advantages, advantages + values


def clip_by_global_norm_(grads, max_norm: float) -> None:
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


def lr_at(cfg: dict, env_steps: int) -> float:
    lr = np.float32(cfg["lr"])
    if cfg["anneal_lr"]:
        frac = np.float32(1.0) - np.float32(env_steps) / np.float32(cfg["max_train_steps"])
        lr = lr * np.maximum(frac, np.float32(0.0))
    return float(lr)


@contextlib.contextmanager
def f32_products(mode: str):
    """Float32 matrix products in full float32 (``"ieee"``) or TF32."""
    if mode not in ("ieee", "tf32"):
        raise ValueError(f"f32_matmul {mode!r}: 'ieee' or 'tf32'")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class Reference:
    """The reference's train state from ``seed``, stepped one iteration at
    a time by ``iterate``."""

    METRICS = METRICS

    def __init__(self, cfg: dict, seed: int, device: torch.device, f32_matmul: str, env):
        if cfg["normalize_obs"]:
            raise ValueError("the reference runs without obs normalization, as its configs do")
        self.cfg, self.device, self.f32_matmul = cfg, device, f32_matmul
        self.obs_dim = env.obs_dim
        self.net = Net(env.obs_dim, env.n_actions, cfg["hidden_dim"], seed).to(device)
        params = list(self.net.parameters())
        self.opt = torch.optim.Adam(params, lr=cfg["lr"], eps=cfg["adam_eps"],
                                    foreach=cfg["flat_optimizer"])
        for p in params:
            self.opt.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}
        self.draws = Draws(device, seed)
        self.env = env(cfg["num_envs"], self.draws)
        with f32_products(f32_matmul):
            self.carry = self.env.reset()
        self.env_steps = 0

    def _rollout_forward(self, x):
        return self.net(x, torch.bfloat16 if self.cfg["rollout_bf16"] else torch.float32)

    @torch.no_grad()
    def _collect(self):
        steps = []
        for _ in range(self.cfg["rollout_steps"]):
            obs = self.carry[1]
            logits, value = self._rollout_forward(obs)
            action = torch.argmax(logits + self.draws.gumbel(logits.shape), dim=-1).to(torch.int32)
            logp, _ = logp_entropy(logits, action)
            self.carry, (reward, next_obs, term, done, fret, flen) = self.env.step(self.carry,
                                                                                   action)
            steps.append((obs, action, logp, value, reward, next_obs, term.float(), done.float(),
                          fret, flen, done))
        return [torch.stack(f) for f in zip(*steps)]

    def iterate(self) -> dict:
        cfg = self.cfg
        with f32_products(self.f32_matmul):
            return self._iterate(cfg)

    def _iterate(self, cfg) -> dict:
        (obs, action, logp, value, reward, next_obs, term, done, fret, flen,
         done_b) = self._collect()
        d = self.obs_dim
        n = cfg["num_envs"] * cfg["rollout_steps"]
        with torch.no_grad():
            _, next_values = self._rollout_forward(next_obs.reshape(-1, d))
            adv, v_target = gae(reward, value, next_values.reshape(value.shape), term, done,
                                cfg["gamma"], cfg["gae_lambda"])
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
            packed = torch.cat([obs.reshape(n, d), action.reshape(n, 1).float(),
                                logp.reshape(n, 1), adv.reshape(n, 1), v_target.reshape(n, 1)],
                               dim=1)
        lr = lr_at(cfg, self.env_steps)
        for group in self.opt.param_groups:
            group["lr"] = lr
        perms = self.draws.permutations(cfg["num_epochs"], n)
        nmb, mbs = n // cfg["minibatch_size"], cfg["minibatch_size"]
        sgd_dtype = torch.bfloat16 if cfg["sgd_bf16"] else torch.float32
        params = list(self.net.parameters())
        history = []
        for perm in perms:
            for mb in packed[perm].reshape(nmb, mbs, d + 4):
                logits, values = self.net(mb[:, :d], sgd_dtype)
                loss, metrics = head_loss(logits, values, mb[:, d], mb[:, d + 1], mb[:, d + 2],
                                          mb[:, d + 3], cfg)
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_([p.grad for p in params], cfg["max_grad_norm"])
                self.opt.step()
                history.append(metrics)
        self.env_steps += n
        finals = fret[done_b].double()
        return {"metrics": torch.stack(history).mean(dim=0).tolist(),
                "episodes": (int(done_b.sum()), float(finals.sum())), "rows": packed.cpu()}

    @staticmethod
    def loss(cfg: dict, metrics) -> float:
        """An iteration's loss from its metrics in ``METRICS``' order."""
        m = dict(zip(METRICS, metrics))
        return m["policy_loss"] + m["value_loss"] - cfg["entropy_coef"] * m["entropy"]

    @torch.no_grad()
    def judge_rows(self, packed: torch.Tensor) -> float:
        """The widest gap between the log-prob that each packed row records
        for its action and the one this reference's net gives that row's
        observation and action, step by step in the rollout's own batches
        (so each product has the rollout's shape) and in the rollout's type."""
        d, b = self.obs_dim, self.cfg["num_envs"]
        rows = packed.to(self.device)
        gap = torch.zeros((), device=self.device)
        for part in rows.split(b):
            logits, _ = self._rollout_forward(part[:, :d])
            logp = logp_entropy(logits, part[:, d])[0]
            gap = torch.maximum(gap, (logp - part[:, d + 1]).abs().max())
        return float(gap)

    def leaves(self) -> dict[str, torch.Tensor]:
        return self.net.leaves()

    def moments(self) -> dict[str, torch.Tensor]:
        """Adam's first moment by leaf name."""
        return {k: self.opt.state[p]["exp_avg"] for k, p in self.net.leaves().items()}
