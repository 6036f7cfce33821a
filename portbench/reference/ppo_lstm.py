"""Plain PyTorch recurrent full-tricks PPO with RND on a batched env: the
yardstick's reference for gymRL's ``algorithms/ppo_lstm_lunarlander.py``.

Written from gymRL's description (net :446-520, collection :565-616, update
:657-804) and ``algorithms/ppo_full_lunarlander.py``'s mHC backbone
(:76-267), as float32 ``torch`` functions over one ordered table of
parameters, with nothing of the program imported:

  * init: one CPU generator seeded with the run's seed, drawn in the
    program's module order: the mHC backbone's ``input_proj`` and each
    block's ``linear{1,2}`` (flax's ``lecun_normal``: a normal truncated to
    ±2σ with σ rescaled by the truncation's std 0.8796...), its fuses'
    ``w`` at zero, ``alpha`` 0.01, ``beta`` 0.01 for the pooling maps and
    +2 / −2 on / off the mixing map's diagonal, ``norm_weight`` and every
    RMSNorm scale at one; the GRU's input maps ``ir``, ``iz``, ``in``
    (lecun normal, zero bias) and hidden maps ``hr``, ``hz`` (orthogonal,
    no bias), ``hn`` (orthogonal, zero bias); the actor and critic
    ``SiluRMSMLP[512, ·]`` (orthogonal √2, heads 0.001 and 1.0); the RND
    predictor then target, each a PSCN of width 512 and depth 5 (kaiming
    uniform for a leaky ReLU of slope 0.01, PReLU slopes 0.25). Parameters
    carry the program's names, in its order;
  * the mHC fuse: per sample ``H_pre = σ(·)``, ``H_post = 2σ(·)`` and
    ``A = exp(·)`` from one product of the flattened branches scaled by
    ``1/rms``; 10 Sinkhorn-Knopp rounds in the elementwise form (each
    matrix-vector product a product and a sum) give ``u, v`` without
    gradient, and ``H_res = u·A·v`` is re-applied through ``A``; a block
    pools the branches with ``H_pre``, mixes them with ``H_res`` and
    broadcasts ``silu(linear(pooled))`` back with ``H_post``;
  * the GRU cell (flax's: ``n = tanh(in(x) + r·hn(h))``) one step at a time
    in collection, and over a sequence in training with its three input
    maps as one product over all steps and its three hidden maps as one
    product a step;
  * collection: the hidden recorded before each step and after it, reset to
    zero where an episode ends; the intrinsic reward ``mean((pred −
    target)²)`` added to the env's; each step's Gumbels, then the env's
    draws, then one permutation per epoch (``reference/draws.py``);
  * successor values under the post-step hidden; dual-λ GAE cutting
    bootstrap and trace at ``done``; the actor's advantages standardized
    over the rollout (ddof 0); each env column cut into ``seq_len``-step
    chunks that may span episodes, each with the hidden stored at its start;
  * the loss over minibatches of ``minibatch_size / seq_len`` chunks
    re-unrolled from their stored hiddens: the ERC mask (entropy ratio
    within ±β of the rollout's) weighting masked means, dual-clip variant
    (b) with clip-higher, the asymmetric value clip ``old + clip(v − old,
    −0.2, +0.28)``, the annealed entropy term and the RND predictor's MSE;
  * optax's global-norm clip at 0.5 and ``torch.optim.Adam`` (eps 1e-5)
    with its state made at construction, over every parameter: the frozen
    RND target's gradient is zero, so its moments decay and it never moves.

Departures from gymRL, each the program's: the 4,096-step rollout is 64
envs × 64 steps, not one env × 4,096; the sequences of an epoch are
shuffled by ``randperm`` draws; the lr and the entropy coefficient are
annealed over ``max_train_steps`` in float32; products are grouped as the
program groups them (the GRU's stacked maps, the branch pooling as a
batched product), so that on one device the two agree to the bit.

``Reference(cfg, seed, device, f32_matmul, env)`` is a side of the
comparison (``benchlib/compare.py``): ``iterate`` runs one iteration and
returns its seven loss metrics averaged over its grad steps, its finished
episodes and its rows (the chunks by field, with each step's ``done``);
``leaves`` and ``moments`` read the parameters and Adam's first moments by
the program's names. ``env`` is the reference's env class
(``reference.lander:VecLander``). ``f32_matmul`` ``"tf32"`` computes the
float32 products in TF32, the precision below the configuration's (the
control of the comparison); ``"ieee"`` keeps full float32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.draws import Draws

METRICS = ("policy_loss", "value_loss", "entropy", "rnd_loss", "approx_kl", "clip_frac",
           "erc_clip_frac")
HEAD_WIDTH = 512  # the actor's and critic's hidden layer
RMS_EPS = 1e-6
SK_EPS = 1e-8


@contextlib.contextmanager
def f32_products(mode: str):
    """Float32 matrix products in full float32 (``"ieee"``) or TF32."""
    if mode not in ("ieee", "tf32"):
        raise ValueError(f"f32_matmul {mode!r}: 'ieee' or 'tf32'")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# -- init ---------------------------------------------------------------------------
def _lecun_normal(w, gen):
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _orthogonal(gain):
    return lambda w, gen: torch.nn.init.orthogonal_(w, gain, generator=gen)


def _kaiming_uniform(w, gen):
    bound = math.sqrt(2.0 / (1.0 + 0.01 ** 2)) * math.sqrt(3.0 / w.shape[1])
    return w.uniform_(-bound, bound, generator=gen)


def init_params(cfg: dict, obs_dim: int, n_actions: int, seed: int) -> dict[str, torch.Tensor]:
    """Every parameter by the program's name, in its order, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    p: dict[str, torch.Tensor] = {}

    def dense(name, fan_in, fan_out, init, bias=True):
        p[f"{name}.weight"] = init(torch.empty(fan_out, fan_in), gen)
        if bias:
            p[f"{name}.bias"] = torch.zeros(fan_out)

    d, n, hid = cfg["mhc_dim"], cfg["mhc_rate"], cfg["rnn_hidden"]
    dense("shared.input_proj", obs_dim, d, _lecun_normal)
    for b in range(cfg["mhc_layers"]):
        for i in (1, 2):
            fuse = f"shared.block_{b}.mhc{i}"
            p[f"{fuse}.w"] = torch.zeros(n * d, n * n + 2 * n)
            p[f"{fuse}.alpha"] = torch.full((3,), 0.01)
            beta = torch.zeros(n * n + 2 * n)
            beta[:2 * n] = 0.01
            beta[2 * n:] = (4.0 * torch.eye(n) - 2.0).reshape(-1)
            p[f"{fuse}.beta"] = beta
            p[f"{fuse}.norm_weight"] = torch.ones(n * d)
            dense(f"shared.block_{b}.linear{i}", d, d, _lecun_normal)
    p["shared.final_norm.scale"] = torch.ones(d)
    for gate, kind in (("ir", "x"), ("hr", "h"), ("iz", "x"), ("hz", "h"), ("in", "x"),
                       ("hn", "hb")):
        fan_in = d if kind == "x" else hid
        init = _lecun_normal if kind == "x" else _orthogonal(1.0)
        dense(f"rnn.gru.{gate}", fan_in, hid, init, bias=kind != "h")
    for head, out, gain in (("actor", n_actions, 0.001), ("critic", 1, 1.0)):
        dense(f"{head}.fc0", hid, HEAD_WIDTH, _orthogonal(math.sqrt(2.0)))
        p[f"{head}.norm0.scale"] = torch.ones(HEAD_WIDTH)
        dense(f"{head}.fc1", HEAD_WIDTH, out, _orthogonal(gain))
    depth = int(math.log2(cfg["rnd_embed"] // 16))
    for net in ("predictor", "target"):
        fan_in, width = obs_dim, cfg["rnd_embed"]
        for i in range(depth):
            dense(f"rnd.{net}.mlp_{i}.layer_0", fan_in, width, _kaiming_uniform)
            p[f"rnd.{net}.mlp_{i}.act_0.negative_slope"] = torch.tensor(0.25)
            fan_in = width = width // 2
    return p


# -- the net ------------------------------------------------------------------------
def dense(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def rms_norm(x, scale):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + RMS_EPS) * scale


def sinkhorn_knopp(A, iters: int):
    """``(u, v)`` of ``iters`` elementwise rounds from ones: ``u = 1/(A v +
    eps)``, ``v = 1/(Aᵀ u + eps)``."""
    u = torch.ones(A.shape[:2], device=A.device)
    v = torch.ones(A.shape[:2], device=A.device)
    for _ in range(iters):
        u = 1.0 / ((A * v[:, None, :]).sum(dim=-1) + SK_EPS)
        v = 1.0 / ((A * u[:, :, None]).sum(dim=-2) + SK_EPS)
    return u, v


def mhc_fuse(p, name, h, sk_iters: int):
    """``(H_pre, H_post, H_res)`` of the branches ``h[B, N, D]``."""
    b, n = h.shape[0], h.shape[1]
    h_flat = h.reshape(b, -1)
    H = (p[f"{name}.norm_weight"] * h_flat) @ p[f"{name}.w"]
    r = torch.linalg.vector_norm(h_flat, dim=-1, keepdim=True) / math.sqrt(h_flat.shape[1])
    r_ = 1.0 / (r + 1e-6)
    alpha, beta = p[f"{name}.alpha"], p[f"{name}.beta"]
    H_pre = torch.sigmoid(r_ * H[:, :n] * alpha[0] + beta[:n])
    H_post = 2.0 * torch.sigmoid(r_ * H[:, n:2 * n] * alpha[1] + beta[n:2 * n])
    A = torch.exp((r_ * H[:, 2 * n:] * alpha[2] + beta[2 * n:]).reshape(b, n, n))
    with torch.no_grad():
        u, v = sinkhorn_knopp(A, sk_iters)
    return H_pre, H_post, u[:, :, None] * A * v[:, None, :]


def backbone(p, cfg, x):
    """The mHC backbone of ``x[B, obs]``: ``[B, mhc_dim]``."""
    h = dense(p, "shared.input_proj", x)[:, None, :].expand(-1, cfg["mhc_rate"], -1)
    for b in range(cfg["mhc_layers"]):
        for i in (1, 2):
            H_pre, H_post, H_res = mhc_fuse(p, f"shared.block_{b}.mhc{i}", h, cfg["mhc_sk_it"])
            pooled = torch.bmm(H_pre[:, None, :], h)[:, 0]
            out = F.silu(dense(p, f"shared.block_{b}.linear{i}", pooled))
            h = H_post[:, :, None] * out[:, None, :] + torch.bmm(H_res, h)
    return rms_norm(h.sum(dim=1), p["shared.final_norm.scale"])


def gru_step(p, h, x):
    r = torch.sigmoid(dense(p, "rnn.gru.ir", x) + dense(p, "rnn.gru.hr", h))
    z = torch.sigmoid(dense(p, "rnn.gru.iz", x) + dense(p, "rnn.gru.hz", h))
    n = torch.tanh(dense(p, "rnn.gru.in", x) + r * dense(p, "rnn.gru.hn", h))
    return (1.0 - z) * n + z * h


def gru_unroll(p, h, xs):
    """The hidden after each step of ``xs[mb, L, in]`` from ``h[mb, H]``."""
    H = h.shape[-1]
    g = {k: p[f"rnn.gru.{k}.weight"] for k in ("ir", "iz", "in", "hr", "hz", "hn")}
    xg = F.linear(xs, torch.cat([g["ir"], g["iz"], g["in"]]),
                  torch.cat([p["rnn.gru.ir.bias"], p["rnn.gru.iz.bias"], p["rnn.gru.in.bias"]]))
    w_h = torch.cat([g["hr"], g["hz"], g["hn"]]).t()
    b_h = torch.cat([p["rnn.gru.hn.bias"].new_zeros(2 * H), p["rnn.gru.hn.bias"]])
    hs = []
    for t in range(xs.shape[1]):
        hg = torch.addmm(b_h, h, w_h)
        x_t = xg[:, t]
        rz = torch.sigmoid(x_t[:, :2 * H] + hg[:, :2 * H])
        n = torch.tanh(x_t[:, 2 * H:] + rz[:, :H] * hg[:, 2 * H:])
        h = (1.0 - rz[:, H:]) * n + rz[:, H:] * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def head(p, name, x):
    return dense(p, f"{name}.fc1", rms_norm(F.silu(dense(p, f"{name}.fc0", x)),
                                             p[f"{name}.norm0.scale"]))


def pscn(p, name, x, depth: int):
    parts = []
    for i in range(depth):
        x = dense(p, f"{name}.mlp_{i}.layer_0", x)
        x = torch.where(x >= 0, x, p[f"{name}.mlp_{i}.act_0.negative_slope"] * x)
        if i < depth - 1:
            half = x.shape[-1] // 2
            parts.append(x[..., :half])
            x = x[..., half:]
        else:
            parts.append(x)
    return torch.cat(parts, dim=-1)


def rnd(p, cfg, x):
    """The RND predictor's and the frozen target's embeddings of ``x``."""
    depth = int(math.log2(cfg["rnd_embed"] // 16))
    with torch.no_grad():
        target = pscn(p, "rnd.target", x, depth)
    return pscn(p, "rnd.predictor", x, depth), target


def policy_step(p, cfg, h, obs):
    """One step of the cell from ``h``: ``(h', logits, value)``."""
    h = gru_step(p, h, backbone(p, cfg, obs))
    return h, head(p, "actor", h), head(p, "critic", h).squeeze(-1)


def logp_entropy(logits, action):
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action.long()[..., None]).squeeze(-1)
    return logp, -(torch.exp(logp_all) * logp_all).sum(dim=-1)


# -- advantages, loss, optimizer ----------------------------------------------------
def gae(rewards, values, next_values, done, gamma, lam):
    """Advantages cutting bootstrap and trace at ``done``."""
    deltas = rewards + gamma * next_values * (1.0 - done) - values
    decay = gamma * lam * (1.0 - done)
    advantages = torch.empty_like(deltas)
    adv = torch.zeros_like(deltas[0])
    for t in reversed(range(deltas.shape[0])):
        adv = deltas[t] + decay[t] * adv
        advantages[t] = adv
    return advantages


def masked_mean(x, mask):
    return (x * mask).sum() / (mask.sum() + 1e-8)


def loss_of(p, cfg, mb: dict, ent_coef: float):
    """The loss of a minibatch of chunks re-unrolled from their stored hiddens
    and its metrics, in ``METRICS``' order."""
    n_seq, L = mb["obs"].shape[:2]
    flat = mb["obs"].reshape(n_seq * L, -1)
    predict, target = rnd(p, cfg, flat)
    outs = gru_unroll(p, mb["h0"], backbone(p, cfg, flat).reshape(n_seq, L, -1))
    logits, values = head(p, "actor", outs), head(p, "critic", outs).squeeze(-1)
    logp, entropy = logp_entropy(logits, mb["action"])
    entropy_ratio = entropy / (mb["old_entropy"] + 1e-8)
    corr = ((entropy_ratio > 1.0 - cfg["erc_beta_low"])
            & (entropy_ratio < 1.0 + cfg["erc_beta_high"])).float()
    ratio = torch.exp(logp - mb["logp"])
    adv = mb["adv"]
    surr1 = torch.clamp(ratio, 0.0, cfg["dual_clip"]) * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg["clip_eps_min"], 1.0 + cfg["clip_eps_max"]) * adv
    policy_loss = masked_mean(-torch.minimum(surr1, surr2), corr)
    old = mb["old_value"]
    v_clip = old + torch.clamp(values - old, -cfg["clip_eps_min"], cfg["clip_eps_max"])
    vl = torch.maximum(torch.square(values - mb["ret"]), torch.square(v_clip - mb["ret"]))
    value_loss = 0.5 * masked_mean(vl, corr)
    entropy_term = masked_mean(entropy, corr)
    rnd_loss = torch.square(predict.reshape(n_seq, L, -1) - target.reshape(n_seq, L, -1)).mean()
    loss = policy_loss + value_loss - ent_coef * entropy_term + rnd_loss
    clipped = (ratio < 1.0 - cfg["clip_eps_min"]) | (ratio > 1.0 + cfg["clip_eps_max"])
    return loss, torch.stack([policy_loss, value_loss, entropy_term, rnd_loss,
                              (mb["logp"] - logp).mean(), masked_mean(clipped.float(), corr),
                              1.0 - corr.mean()]).detach()


def clip_by_global_norm_(grads, max_norm: float) -> None:
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


def annealed(cfg: dict, env_steps: int) -> tuple[float, float]:
    """``(lr, entropy coefficient)``, each times ``1 − progress``, in float32."""
    lr, ent = np.float32(cfg["lr"]), np.float32(cfg["entropy_coef"])
    if cfg["anneal"]:
        progress = np.clip(np.float32(env_steps) / np.float32(cfg["max_train_steps"]),
                           np.float32(0.0), np.float32(1.0))
        lr, ent = lr * (np.float32(1.0) - progress), ent * (np.float32(1.0) - progress)
    return float(lr), float(ent)


def chunks(x, L: int, B: int):
    """``[T, B, ...]`` → ``[T/L · B, L, ...]``: each env column cut into
    ``L``-step chunks, chunk-major."""
    n_chunks = x.shape[0] // L
    x = x.reshape((n_chunks, L) + tuple(x.shape[1:])).movedim(2, 1)
    return x.reshape((n_chunks * B, L) + tuple(x.shape[3:]))


class Reference:
    """The reference's train state from ``seed``, stepped one iteration at a
    time by ``iterate``."""

    METRICS = METRICS

    def __init__(self, cfg: dict, seed: int, device: torch.device, f32_matmul: str, env):
        if not cfg["use_mhc"] or cfg["rnn_cell"] != "gru":
            raise ValueError("the reference runs the mHC backbone and the GRU cell, as its "
                             "configuration does")
        if cfg["rollout_steps"] % cfg["seq_len"]:
            raise ValueError("seq_len must divide rollout_steps")
        self.cfg, self.device, self.f32_matmul = cfg, device, f32_matmul
        self.obs_dim = env.obs_dim
        self.params = {k: v.to(device).requires_grad_()
                       for k, v in init_params(cfg, env.obs_dim, env.n_actions, seed).items()}
        leaves = list(self.params.values())
        self.opt = torch.optim.Adam(leaves, lr=cfg["lr"], eps=cfg["adam_eps"],
                                    foreach=cfg["flat_optimizer"])
        for v in leaves:
            self.opt.state[v] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(v),
                                 "exp_avg_sq": torch.zeros_like(v)}
        self.draws = Draws(device, seed)
        self.env = env(cfg["num_envs"], self.draws)
        with f32_products(f32_matmul):
            self.carry = self.env.reset()
        self.hidden = torch.zeros(cfg["num_envs"], cfg["rnn_hidden"], device=device)
        self.env_steps = 0

    @torch.no_grad()
    def _collect(self):
        p, cfg = self.params, self.cfg
        steps = []
        for _ in range(cfg["rollout_steps"]):
            obs, h_pre = self.carry[1], self.hidden
            predict, target = rnd(p, cfg, obs)
            h, logits, value = policy_step(p, cfg, h_pre, obs)
            action = torch.argmax(logits + self.draws.gumbel(logits.shape), dim=-1).to(torch.int32)
            logp, entropy = logp_entropy(logits, action)
            self.carry, (reward, next_obs, _, done, fret, _) = self.env.step(self.carry, action)
            reward = reward + torch.square(predict - target).mean(dim=-1)
            self.hidden = torch.where(done[:, None], 0.0, h)
            steps.append((obs, action, logp, value, entropy, reward, next_obs, h_pre, h,
                          done.float(), fret, done))
        return [torch.stack(f) for f in zip(*steps)]

    def iterate(self) -> dict:
        with f32_products(self.f32_matmul):
            return self._iterate()

    def _iterate(self) -> dict:
        p, cfg = self.params, self.cfg
        (obs, action, logp, value, entropy, reward, next_obs, h_pre, h_post, done, fret,
         done_b) = self._collect()
        T, B, L = cfg["rollout_steps"], cfg["num_envs"], cfg["seq_len"]
        with torch.no_grad():
            _, _, next_values = policy_step(p, cfg, h_post.reshape(T * B, -1),
                                            next_obs.reshape(T * B, -1))
            next_values = next_values.reshape(value.shape)
            adv = gae(reward, value, next_values, done, cfg["gamma"], cfg["lam_actor"])
            returns = gae(reward, value, next_values, done, cfg["gamma"],
                          cfg["lam_critic"]) + value
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
            rows = {"obs": chunks(obs, L, B), "action": chunks(action, L, B),
                    "logp": chunks(logp, L, B), "old_entropy": chunks(entropy, L, B),
                    "old_value": chunks(value, L, B), "adv": chunks(adv, L, B),
                    "ret": chunks(returns, L, B), "h0": chunks(h_pre, L, B)[:, 0]}
        lr, ent_coef = annealed(cfg, self.env_steps)
        for group in self.opt.param_groups:
            group["lr"] = lr
        n_seq = rows["obs"].shape[0]
        mb = min(cfg["minibatch_size"] // L, n_seq)
        perms = self.draws.permutations(cfg["num_epochs"], n_seq)
        leaves = list(p.values())
        history = []
        for perm in perms:
            for idx in perm.reshape(n_seq // mb, mb):
                loss, metrics = loss_of(p, cfg, {k: v[idx] for k, v in rows.items()}, ent_coef)
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                for v in leaves:
                    if v.grad is None:  # the frozen RND target
                        v.grad = torch.zeros_like(v)
                clip_by_global_norm_([v.grad for v in leaves], cfg["max_grad_norm"])
                self.opt.step()
                history.append(metrics)
        self.env_steps += T * B
        finals = fret[done_b].double()
        return {"metrics": torch.stack(history).mean(dim=0).tolist(),
                "episodes": (int(done_b.sum()), float(finals.sum())),
                "rows": {**{k: v.cpu() for k, v in rows.items()},
                         "done": chunks(done, L, B).cpu()}}

    @staticmethod
    def loss(cfg: dict, metrics) -> float:
        """An iteration's loss from its metrics in ``METRICS``' order, with the
        configuration's entropy coefficient."""
        m = dict(zip(METRICS, metrics))
        return m["policy_loss"] + m["value_loss"] - cfg["entropy_coef"] * m["entropy"] \
            + m["rnd_loss"]

    @torch.no_grad()
    def judge_rows(self, rows: dict) -> float:
        """The widest gap between the log-prob each row records for its action
        and the one this reference's net gives it, each chunk re-unrolled from
        its stored hidden. Step by step as the rollout stepped, in its batches
        (the chunks of one time window, one per env, in env order) and with the
        hidden reset to zero after a step that ended an episode, so each
        product has the rollout's shape."""
        p, cfg, B = self.params, self.cfg, self.cfg["num_envs"]
        r = {k: v.to(self.device) for k, v in rows.items()}
        gap = torch.zeros((), device=self.device)
        with f32_products(self.f32_matmul):
            for c in range(0, r["obs"].shape[0], B):
                h = r["h0"][c:c + B]
                for t in range(r["obs"].shape[1]):
                    h, logits, _ = policy_step(p, cfg, h, r["obs"][c:c + B, t])
                    logp = logp_entropy(logits, r["action"][c:c + B, t])[0]
                    gap = torch.maximum(gap, (logp - r["logp"][c:c + B, t]).abs().max())
                    h = torch.where(r["done"][c:c + B, t, None] > 0, 0.0, h)
        return float(gap)

    def leaves(self) -> dict[str, torch.Tensor]:
        return self.params

    def moments(self) -> dict[str, torch.Tensor]:
        """Adam's first moment by leaf name."""
        return {k: self.opt.state[v]["exp_avg"] for k, v in self.params.items()}
