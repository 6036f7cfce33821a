"""The port's full-tricks PPO and recurrent full-tricks PPO with RND, their
eval, CLI workloads, checkpoints and the interop of their train states,
against the JAX reference.

Both packages run on the CPU at the JAX tests' narrow widths (mHC dim 32 with
5 Sinkhorn iterations; URNN hidden 64, RND embed 64), on CartPole and (the
ppo_full preset) on LunarLander. Each iteration starts from the reference's state, carried
across with ``interop.train_state_from_reference`` (params, the flat or
per-leaf Adam state, env batch, packed hidden); the port's noise source
replays the reference's ``jax.random`` key splits (``FullReplayNoise``,
``RNNReplayNoise``), so both draw the same Gumbels, env noise, epoch
permutations and clip-cov uniforms.

Tolerances, each with its reason (the shared rules are those of
``test_torch_dqn.py`` and ``test_torch_ppo_rnn_ppg.py``):
  * the rollout, a free run of T steps with no observation normalization:
    actions, dones and the packed integer fields exact; observations,
    values, log-probs, entropies, hiddens and the packed rows atol
    ``TRAJ_ATOL`` = 1e-5 (the largest differences are printed by
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ppo_full_lstm.py``).
    Rewards (RND's included) ``REWARD_ATOL`` = 1e-5 + 1e-6·300, as in
    ``test_torch_ppo.py``: a lander reward is the difference of two shaping
    values of up to ~300, whose float32 spacing is 3e-5; returns rtol 1e-5
    plus ``REWARD_ATOL``; standardized advantages ``TRAJ_ATOL`` plus the
    returns' tolerance over the raw advantages' std; episode returns
    ``REWARD_ATOL`` per step.
  * every gradient step, held from the same state (``FullLockstep``):
    metrics rtol 1e-5, params atol 1e-5 under the Adam-sign and tie rules
    (``TieLog``: a gradient below 1e-6 of its tensor's largest or below
    1e-6 moves its entry by up to 2·lr; ppo_full's Adam eps is optax's
    1e-8, and the mHC's ``w`` starts at zero behind α = 0.01, so its first
    gradients are small; a PReLU pre-activation within 1e-5 of its kink,
    the RND pair's and the PSCN fallback's, moves its unit's row and its
    consumers' column by 2·lr). Two step functions of each sample join
    these rules:
      - ERC: a sample whose entropy ratio lies within ``ERC_TIE`` = 1e-5 of
        ``1 ± 0.06`` may fall on either side in the two frameworks. Where
        their masks differ, the reference's step gets the port's side by
        moving that sample's old entropy by 2·``ERC_TIE`` relative; a
        differing sample farther from the edges fails the test.
      - clip-cov: a covariance that the two frameworks put on different
        sides of a band edge changes the in-band count; the reference's
        step then takes the port's keep mask, and the two covariances must
        agree to ``COV_TIE`` = 1e-5. Where every sample is on the same
        side, the reference's mask from the same key must equal the
        port's exactly.
    A step with an ERC or clip-cov tie counts one tie for every entry at
    the iteration's end.
  * the iteration as a whole: params under the same rules, counted over the
    iteration; the RND target equal to the bit; hidden and env obs
    ``TRAJ_ATOL``; metrics rtol 1e-5 + ``TRAJ_ATOL``; lr and the entropy
    coefficient exact (the same float32 arithmetic); Adam counts, env steps
    and episode flags exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gymrl_tpu.algos import base as ref_base
from gymrl_tpu.algos import ppo_full as RF
from gymrl_tpu.algos import ppo_lstm as RL
from gymrl_tpu.core.gae import compute_gae_dual_lambda as ref_dual_gae
from gymrl_tpu.core.gae import standardize as ref_standardize
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos import ppo_full as PF
from gymrl_tpu_torch.algos import ppo_lstm as PL
from gymrl_tpu_torch.algos.base import unpack_fields
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.nn.layers import MLP
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_dqn import RELU_TIE, assert_params_close, env_step_draws, tiny_grad
from test_torch_dqn_variants import FamilyGradLog
from test_torch_lunarlander import SHAPING_RTOL
from test_torch_ppo_rnn_ppg import RNNReplayNoise, _EvalReplay, _record

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
TRAJ_ATOL = 1e-5
REWARD_ATOL = TRAJ_ATOL + SHAPING_RTOL * 300.0
ERC_TIE = 1e-5
COV_TIE = 1e-5
LR = 3e-4

# -- the cases, at the JAX tests' narrow widths -------------------------------------------
_FULL = dict(env_name="CartPole-v1", num_envs=8, rollout_steps=16, minibatch_size=32,
             num_epochs=2, mhc_dim=32, mhc_sk_it=5, max_train_steps=100_000)
_LSTM = dict(env_name="CartPole-v1", num_envs=8, rollout_steps=16, seq_len=4, seq_minibatch=16,
             num_epochs=2, mhc_dim=32, mhc_sk_it=5, rnn_hidden=64, rnd_embed=64,
             max_train_steps=100_000)
CASES = {
    # the ppo_full_lunarlander preset (mHC, clip-cov off) on LunarLander, flat Adam
    "full_mhc": ("full", dict(_FULL, env_name="LunarLander-v3", flat_optimizer=True)),
    # clip-cov on; the band (0, 5) holds about half the samples from the start
    "full_clipcov": ("full", dict(_FULL, clip_cov_ratio=0.2, clip_cov_min=0.0)),
    "full_pscn": ("full", dict(_FULL, use_mhc=False)),
    "lstm_gru": ("lstm", dict(_LSTM)),
    "lstm_lstm": ("lstm", dict(_LSTM, rnn_cell="lstm", flat_optimizer=True)),
}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


def _ref_trainer(case):
    kind, kw = CASES[case]
    return (RF.PPOFullTrainer(RF.PPOFullConfig(**kw)) if kind == "full"
            else RL.PPOLSTMTrainer(RL.PPOLSTMConfig(**kw)))


@pytest.fixture(scope="module")
def refs():
    """One reference trainer per case for the file (each jitted function
    compiles once), made on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _ref_trainer(case)
        return cache[case]

    return get


_INITS: dict = {}


def _init(rt):
    """The reference's state from ``PRNGKey(0)``, made once per trainer."""
    if rt not in _INITS:
        _INITS[rt] = jax.jit(rt.init)(jax.random.PRNGKey(0))
    return _INITS[rt]


# -- replaying the reference's draws ---------------------------------------------------
class FullReplayNoise(RNNReplayNoise):
    """``RNNReplayNoise`` with ppo_full's epoch keys: after collection
    ``split(key)`` into (key, epochs), one key per epoch, each split into
    (permutation, clip-cov); a clip-cov key splits into one key per
    minibatch, whose ``uniform`` scores the samples. ``mb_keys`` keeps
    those keys in order for the lockstep's reference step."""

    def permutations(self, count, n):
        self.calls.append("permutations")
        self.key, k_epochs = jax.random.split(self.key)
        pairs = [jax.random.split(k) for k in jax.random.split(k_epochs, count)]
        self.cov_keys = [k_cov for _, k_cov in pairs]
        return torch.stack([_t(jax.random.permutation(k_perm, n)) for k_perm, _ in pairs]).long()

    def cov_uniforms(self, epochs, minibatches, size):
        self.calls.append("cov_uniforms")
        self.mb_keys = [k for k_cov in self.cov_keys for k in jax.random.split(k_cov, minibatches)]
        return torch.stack([_t(jax.random.uniform(k, (size,))) for k in self.mb_keys]).reshape(
            epochs, minibatches, size)


def _port(case, jts):
    """The port trainer of the case and the reference state carried across."""
    kind, kw = CASES[case]
    trainer = (PF.PPOFullTrainer(PF.PPOFullConfig(**kw), device="cpu") if kind == "full"
               else PL.PPOLSTMTrainer(PL.PPOLSTMConfig(**kw), device="cpu"))
    noise = (FullReplayNoise if kind == "full" else RNNReplayNoise)(jts.key)
    return trainer, interop.train_state_from_reference(trainer, jax.device_get(jts), noise), noise


# -- the reference's pieces, jitted once per trainer -------------------------------------
_REF_FNS: dict = {}


def _ref_fns(rt):
    """The reference's collection and packed training rows (its
    ``_train_iter`` up to ``pack_fields``), its minibatch step, its
    entropies of a minibatch, and (ppo_full) its clip-cov mask."""
    if rt in _REF_FNS:
        return _REF_FNS[rt]
    cfg = rt.cfg
    full = isinstance(rt, RF.PPOFullTrainer)

    @jax.jit
    def prep(jts):
        out = rt._collect(jts)
        roll = out[-2]
        obs_dim = roll.next_obs.shape[-1]
        if full:
            _, next_values = rt.net.apply(jts.params, roll.next_obs.reshape(-1, obs_dim))
        else:
            flat_h = roll.h_post.reshape(-1, roll.h_post.shape[-1])
            next_values = rt.net.apply(jts.params, flat_h, roll.next_obs.reshape(-1, obs_dim))[2]
        adv, returns = ref_dual_gae(roll.reward, roll.value, next_values.reshape(roll.value.shape),
                                    roll.done, roll.done, cfg.gamma, cfg.lam_actor, cfg.lam_critic)
        std_adv = ref_standardize(adv)
        if full:
            data = {"obs": roll.obs.reshape(cfg.batch_total, -1), "action": roll.action.reshape(-1),
                    "logp": roll.logp.reshape(-1), "old_entropy": roll.entropy.reshape(-1),
                    "adv": std_adv.reshape(-1), "ret": returns.reshape(-1)}
        else:
            L, n_chunks = cfg.seq_len, cfg.rollout_steps // cfg.seq_len

            def to_seq(x):
                x = jnp.moveaxis(x.reshape((n_chunks, L) + x.shape[1:]), 2, 1)
                return x.reshape((n_chunks * cfg.num_envs, L) + x.shape[3:])

            data = {"obs": to_seq(roll.obs), "action": to_seq(roll.action),
                    "logp": to_seq(roll.logp), "old_entropy": to_seq(roll.entropy),
                    "old_value": to_seq(roll.value), "adv": to_seq(std_adv),
                    "ret": to_seq(returns), "h0": to_seq(roll.h_pre)[:, 0]}
        return roll, ref_base.pack_fields(data)[0], jnp.std(adv)

    @jax.jit
    def step(params, opt_state, mb, ent_coef):
        p0, unravel = ref_base.flat_params_repr(params, cfg.flat_optimizer)
        (_, metrics), grads = jax.value_and_grad(
            lambda p: rt._loss(unravel(p), mb, ent_coef), has_aux=True)(p0)
        updates, opt_state = rt.tx.update(grads, opt_state, p0)
        return unravel(optax.apply_updates(p0, updates)), opt_state, metrics

    @jax.jit
    def entropy(params, mb):
        logits = (rt.net.apply(params, mb["obs"])[0] if full
                  else rt._seq_forward(params, mb["h0"], mb["obs"])[0])
        logp_all = jax.nn.log_softmax(logits)
        return -jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1)

    @jax.jit
    def cov_keep(params, mb, key):
        # the reference's clip-cov block of its minibatch scan (ppo_full.py:341-351)
        logits, _ = rt.net.apply(params, mb["obs"])
        lp = jnp.take_along_axis(jax.nn.log_softmax(logits), mb["action"][:, None], -1)[:, 0]
        covs = (lp - jnp.mean(lp)) * (mb["adv"] - jnp.mean(mb["adv"]))
        return covs, RF.cov_drop_mask(key, covs, cfg.clip_cov_ratio, cfg.clip_cov_min,
                                      cfg.clip_cov_max)

    _REF_FNS[rt] = (prep, step, entropy, cov_keep)
    return _REF_FNS[rt]


_OPT_TEMPLATES: dict = {}


def _jax_opt(rt, net, opt, lr):
    """The port's Adam as the reference's optax state (clip, injected
    hyperparameters with this step's lr, Adam moments and count), on a
    template of its structure made once per trainer."""
    flat = rt.cfg.flat_optimizer
    if rt not in _OPT_TEMPLATES:
        params = interop.params_to_flax(dict(net.named_parameters()))
        _OPT_TEMPLATES[rt] = rt.tx.init(jnp.asarray(interop.ravel_flax(params)) if flat
                                        else params)
    clip, inject = _OPT_TEMPLATES[rt]
    count, mu, nu = interop.adam_state_to_flax(opt, net, flat)
    adam, *rest = inject.inner_state
    inner = (adam._replace(count=jnp.asarray(count), mu=mu, nu=nu), *rest)
    hyper = dict(inject.hyperparams, learning_rate=jnp.asarray(lr, jnp.float32))
    return (clip, inject._replace(hyperparams=hyper, inner_state=inner))


def _prelu_producers(net):
    """Every layer whose output passes a PReLU (each MLP's ``layer_i`` with
    an ``act_i``), the RND pair's last blocks included."""
    return [f"{name}.layer_{i}" for name, m in net.named_modules() if isinstance(m, MLP)
            for i in range(m.n) if hasattr(m, f"act_{i}")]


class TieLog(FamilyGradLog):
    """``FamilyGradLog`` watching every PReLU producer: the RND pair's last
    blocks feed only the RND loss, so no edge names them, and a tie there
    moves the unit's own row. ``tie_everywhere`` counts one more update for
    every entry (a step with an ERC or clip-cov tie)."""

    def __init__(self, net, opt):
        self.counts: dict[str, np.ndarray] = {}
        self.ties = 0
        self.shapes = {n: p.shape for n, p in net.named_parameters()}
        self.noisy = set()
        self.edges = net.activation_edges()
        modules = dict(net.named_modules())
        pending = []
        for name in _prelu_producers(net):
            def hook(mod, args, out, name=name):
                if torch.is_grad_enabled():
                    pending.append((name, out.detach().reshape(-1, out.shape[-1])))
            modules[name].register_forward_hook(hook)
        named = list(net.named_parameters())
        step = opt.step

        def logged(*args, **kw):
            for n, p in named:
                self._add(n, tiny_grad(p.grad))
            for name, out in pending:
                units = (out.abs() < RELU_TIE).any(dim=0).numpy()
                if units.any():
                    self.ties += 1
                    self._mark_units(name, units)
            pending.clear()
            return step(*args, **kw)

        opt.step = logged

    def tie_everywhere(self):
        for n, shape in self.shapes.items():
            self._add(n, np.ones(shape, bool))


def _erc_side(ratio, cfg):
    return (ratio > np.float32(1.0 - cfg.erc_beta_low)) & (ratio < np.float32(1.0 + cfg.erc_beta_high))


class FullLockstep:
    """Holds every gradient step of a port ``train_iter`` (ppo_full's or
    ppo_lstm's) to the reference's minibatch step (its loss, ``tx.update``
    and ``apply_updates``) from the same params, Adam state (lr included)
    and minibatch: metrics rtol 1e-5, params under the Adam-sign and tie
    rules of that step, the Adam count; the ERC and clip-cov masks with
    the tie rules of the module docstring."""

    def __init__(self, rt, trainer, log: TieLog, noise, ent_coef: float):
        self.steps = 0
        self.erc_ties = self.cov_ties = self.cov_dropped = 0
        self.log = log
        _, step_fn, ref_entropy, ref_cov_keep = _ref_fns(rt)
        cfg = trainer.cfg
        grad_step = trainer._grad_step
        full = isinstance(trainer, PF.PPOFullTrainer)

        def checked(ts, *args):
            net, opt = ts.params, ts.opt_state
            mb = args[0] if full else unpack_fields(args[0], args[1])
            where = f"step {self.steps}"
            params_j = interop.params_to_flax(dict(net.named_parameters()))
            mb_j = {k: np.array(v.numpy()) for k, v in mb.items()}
            # ERC: each framework's mask from the same params
            with torch.no_grad():
                logits = net(mb["obs"])[0] if full else trainer._seq_forward(
                    net, mb["h0"], mb["obs"])[0]
                logp_all = torch.log_softmax(logits, -1)
                ent_p = -(torch.exp(logp_all) * logp_all).sum(-1).numpy()
            ent_j = np.asarray(ref_entropy(params_j, mb_j))
            old = mb_j["old_entropy"]
            r_p, r_j = ent_p / (old + np.float32(1e-8)), ent_j / (old + np.float32(1e-8))
            differ = _erc_side(r_p, cfg) != _erc_side(r_j, cfg)
            if differ.any():
                edge_dist = np.minimum(np.abs(r_p - (1.0 - cfg.erc_beta_low)),
                                       np.abs(r_p - (1.0 + cfg.erc_beta_high)))
                assert (edge_dist[differ] < ERC_TIE).all(), f"ERC masks differ off the edges, {where}"
                # move the reference's ratio to the port's side of the edge
                inside = _erc_side(r_p, cfg)[differ]
                near_low = r_p[differ] < 1.0
                grow = np.where(inside, near_low, ~near_low)  # a larger ratio needs less old entropy
                old[differ] *= np.where(grow, 1.0 - 2 * ERC_TIE, 1.0 + 2 * ERC_TIE).astype(np.float32)
                r_j = ent_j / (old + np.float32(1e-8))
                assert (_erc_side(r_j, cfg) == _erc_side(r_p, cfg)).all(), where
                self.erc_ties += 1
                self.log.tie_everywhere()
            if full and cfg.clip_cov_ratio > 0:
                key = noise.mb_keys[self.steps]
                with torch.no_grad():
                    lp = logp_all.gather(-1, mb["action"].long()[:, None])[:, 0]
                    covs_p = ((lp - lp.mean()) * (mb["adv"] - mb["adv"].mean())).numpy()
                covs_j, keep_j = map(np.asarray, ref_cov_keep(params_j, mb_j, key))
                band_p = (covs_p > cfg.clip_cov_min) & (covs_p < cfg.clip_cov_max)
                band_j = (covs_j > cfg.clip_cov_min) & (covs_j < cfg.clip_cov_max)
                np.testing.assert_allclose(covs_p, covs_j, rtol=0, atol=COV_TIE, err_msg=where)
                if (band_p != band_j).any():
                    self.cov_ties += 1
                    self.log.tie_everywhere()
                else:
                    np.testing.assert_array_equal(mb_j["cov_keep"], keep_j, err_msg=where)
                self.cov_dropped += int((mb_j["cov_keep"] == 0).sum())
            opt_j = _jax_opt(rt, net, opt, opt.param_groups[0]["lr"])
            counts0 = {k: np.array(v, copy=True) for k, v in self.log.counts.items()}
            metrics = grad_step(ts, *args)
            params, opt_state, ref_metrics = jax.device_get(step_fn(params_j, opt_j, mb_j,
                                                                   np.float32(ent_coef)))
            assert set(metrics) == set(ref_metrics), where
            for k, v in ref_metrics.items():
                np.testing.assert_allclose(float(metrics[k]), float(v), rtol=RTOL, atol=1e-7,
                                           err_msg=f"{k} {where}")
            this_step = {k: v - counts0.get(k, 0) for k, v in self.log.counts.items()}
            assert_params_close(net.state_dict(), _flax(params), LR, this_step, where)
            count = int(interop._scale_by_adam_state(opt_state).count)
            assert {int(s["step"]) for s in opt.state.values()} == {count}, where
            self.steps += 1
            return metrics

        trainer._grad_step = checked


def _assert_rollout_close(roll, packed, spec, ref, where):
    """The port's rollout and packed rows against the reference's (``prep``)."""
    roll_ref, packed_ref, adv_std = jax.device_get(ref)
    for f in ("action", "done"):
        np.testing.assert_array_equal(getattr(roll, f).numpy(), getattr(roll_ref, f),
                                      err_msg=f"{f} {where}")
    for f in set(roll._fields) - {"action", "done", "reward"}:
        np.testing.assert_allclose(getattr(roll, f).numpy(), getattr(roll_ref, f), rtol=0,
                                   atol=TRAJ_ATOL, err_msg=f"{f} {where}")
    np.testing.assert_allclose(roll.reward.numpy(), roll_ref.reward, rtol=0, atol=REWARD_ATOL,
                               err_msg=f"reward {where}")
    got, want = packed.numpy(), np.asarray(packed_ref)
    assert got.shape == want.shape, where
    ret_tol = RTOL * np.abs(want[:, slice(*spec["ret"][:2])]).max() + REWARD_ATOL
    for k, (a, b, _, dtype) in spec.items():
        g, w = got[:, a:b], want[:, a:b]
        if dtype != torch.float32:
            np.testing.assert_array_equal(g, w, err_msg=f"packed {k} {where}")
        elif k == "ret":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=REWARD_ATOL,
                                       err_msg=f"packed {k} {where}")
        else:
            atol = TRAJ_ATOL + (ret_tol / adv_std if k == "adv" else 0.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"packed {k} {where}")


def _target_state(net):
    return {k: v.clone() for k, v in net.state_dict().items() if k.startswith("rnd.target.")}


# -- the slice as a whole --------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_iters_match_reference(refs, case):
    """Two iterations from the reference's init with its noise replayed.
    Each starts from the reference's state; the port asks for its draws in
    the reference's order; the rollout, the packed rows and every gradient
    step (``FullLockstep``) are held to the reference's from the same state;
    the iteration ends with the reference's params, Adam count, hidden, env
    batch and metrics; lr and the entropy coefficient follow the anneal
    exactly; the RND target never moves, to the bit."""
    rt = refs(case)
    prep = _ref_fns(rt)[0]
    jts = _init(rt)
    kind = CASES[case][0]
    target0 = None
    for it in range(2):
        trainer, ts, noise = _port(case, jts)
        cfg = trainer.cfg
        if target0 is None and kind == "lstm":
            target0 = _target_state(ts.params)
        log = TieLog(ts.params, ts.opt_state)
        lr, ent_coef = PF.annealed(cfg, ts.env_steps)
        lockstep = FullLockstep(rt, trainer, log, noise, ent_coef)
        collected, trained = [], []
        _record(trainer, "_collect", collected)
        sgd = getattr(trainer, "_sgd" if kind == "full" else "_epochs")

        def keep_args(*args, _sgd=sgd):
            trained.append(args)
            return _sgd(*args)

        setattr(trainer, "_sgd" if kind == "full" else "_epochs", keep_args)
        ref = prep(jts)
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"{case} iteration {it}"

        _, roll, _ = collected[-1]
        _, packed, spec = trained[0][:3]
        _assert_rollout_close(roll, packed, spec, ref, where)
        if lockstep.erc_ties or lockstep.cov_ties:
            log.tie_everywhere()  # the free run may have taken the other side

        jts_np = jax.device_get(jts)
        assert ts.env_steps == int(jts_np.env_steps) == (it + 1) * cfg.batch_total, where
        assert_params_close(ts.params.state_dict(), _flax(jts_np.params), LR, log.counts, where)
        count = int(np.asarray(interop._scale_by_adam_state(jts_np.opt_state).count))
        assert {int(s["step"]) for s in ts.opt_state.state.values()} == {count}, where
        assert count == (it + 1) * cfg.num_epochs * cfg.num_minibatches == \
            (it + 1) * lockstep.steps, where
        np.testing.assert_allclose(ts.vec_state.obs.numpy(), jts_np.vec_state.obs, rtol=0,
                                   atol=TRAJ_ATOL, err_msg=where)
        for f in ("ep_done", "ep_length"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                          err_msg=f"{f} {where}")
        np.testing.assert_allclose(out.ep_return.numpy(), np.asarray(jout.ep_return), rtol=0,
                                   atol=REWARD_ATOL * float(out.ep_length.max()), err_msg=where)
        assert set(out.metrics) == set(jout.metrics), where
        for k, v in jout.metrics.items():
            np.testing.assert_allclose(float(out.metrics[k]), float(v), rtol=RTOL, atol=TRAJ_ATOL,
                                       err_msg=f"{k} {where}")
        # the anneal, in the reference's float32 arithmetic
        assert (float(out.metrics["lr"]), float(out.metrics["ent_coef"])) == (lr, ent_coef) == \
            (float(jout.metrics["lr"]), float(jout.metrics["ent_coef"])), where
        progress = np.float32(it * cfg.batch_total) / np.float32(cfg.max_train_steps)
        assert lr == float(np.float32(cfg.lr) * (np.float32(1) - progress)), where

        steps = {"gumbel": cfg.rollout_steps, "env_step": cfg.rollout_steps,
                 "env_reset": cfg.rollout_steps}
        assert {k: noise.calls.count(k) for k in steps} == steps, where
        tail = ["permutations"] + (["cov_uniforms"] if getattr(cfg, "clip_cov_ratio", 0) else [])
        assert noise.calls[-len(tail):] == tail and noise.calls.count("permutations") == 1, where
        if kind == "full" and cfg.clip_cov_ratio > 0:
            assert lockstep.cov_dropped > 0, "clip-cov should drop samples in the test"
        if kind == "lstm":
            np.testing.assert_allclose(ts.hidden.numpy(), jts_np.hidden, rtol=0, atol=TRAJ_ATOL,
                                       err_msg=where)
            # the hidden restarts at zero exactly where the last step ended an episode
            last_done = roll.done[-1].bool()
            assert not ts.hidden[last_done].any()
            assert ts.hidden[~last_done].abs().sum(-1).gt(0).all()
            for k, v in _target_state(ts.params).items():
                assert torch.equal(v, target0[k]), f"{k} moved, {where}"
                np.testing.assert_array_equal(v.numpy(), _flax(jts_np.params)[k].numpy(), k)
            assert float(out.metrics["rnd_loss"]) > 0


# -- policy surface ------------------------------------------------------------------------
def test_lstm_policy_step_carries_hidden(refs):
    """``test_lstm_policy_step_carries_hidden`` against the reference: the
    packed ``[h | c]`` carry evolves and equals the reference's, and
    ``policy`` is the memoryless view (a fresh carry every call)."""
    rt = refs("lstm_lstm")
    jts, _ = rt.train_iter(_init(rt))
    trainer, ts, _ = _port("lstm_lstm", jts)
    obs = np.asarray(jts.vec_state.obs[:2])
    c0 = trainer.policy_reset(2)
    assert c0.shape == (2, 128) and not c0.any()
    c1, a1 = trainer.policy_step(ts, c0, _t(obs), Noise("cpu", 0))
    c2, a2 = trainer.policy_step(ts, c1, _t(obs), Noise("cpu", 0))
    assert not torch.allclose(c1, c0) and not torch.allclose(c2, c1)
    key = jax.random.PRNGKey(1)
    j1, ja1 = rt.policy_step(jts, jnp.zeros((2, 128)), jnp.asarray(obs), key)
    j2, ja2 = rt.policy_step(jts, j1, jnp.asarray(obs), key)
    np.testing.assert_allclose(c2.numpy(), np.asarray(j2), rtol=0, atol=ATOL)
    assert a1.tolist() == np.asarray(ja1).tolist() and a2.tolist() == np.asarray(ja2).tolist()
    assert trainer.policy(ts, _t(obs), Noise("cpu", 0)).tolist() == a1.tolist()
    _, a = trainer.policy_step(ts, c1[:1].repeat(256, 1), _t(obs[:1]).repeat(256, 1),
                               Noise("cpu", 3), False)
    assert 0 < a.float().mean() < 3


class _FullEvalReplay(_EvalReplay):
    """The feed-forward ``eval_episodes``' key splits: each step's key is
    split into (action, env step) first."""

    def env_step(self, env, num):
        return env_step_draws(env, jax.random.split(next(self.step_keys))[1], num)


@pytest.mark.parametrize("case", ["full_clipcov", "lstm_gru"])
def test_eval_episodes_match_reference(refs, case):
    """Deterministic eval with the hidden carried through each episode
    (ppo_lstm) or feed-forward (ppo_full): the reference's returns and
    lengths (it scans to max_steps with rewards masked after done; the port
    stops once every episode is done)."""
    rt = refs(case)
    jts = _init(rt)
    trainer, ts, _ = _port(case, jts)
    key = jax.random.PRNGKey(4)
    want_ret, want_len = rt.eval_episodes(jts, key, 3)
    replay = (_FullEvalReplay if case.startswith("full") else _EvalReplay)(
        key, trainer.venv.env.max_steps)
    ret, length = trainer.eval_episodes(ts, replay, 3)
    np.testing.assert_array_equal(length.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), rtol=1e-5, atol=1e-3)


# -- interop ----------------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["full_mhc", "full_pscn", "lstm_lstm"])
def test_train_state_interop_round_trips(refs, case):
    """A reference ``FullTrainState`` / ``LSTMTrainState`` after an iteration
    (per-leaf Adam, or the flat optimizer's raveled vectors) carried into
    the port and back to numpy is the reference's to the bit: params (the
    mHC's ``w`` and the RND target included), Adam moments and count, env
    batch, hidden and env steps."""
    rt = refs(case)
    jts = jax.device_get(rt.train_iter(_init(rt))[0])
    _, ts, _ = _port(case, jts)
    back = interop.params_to_flax(ts.params.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jts.params):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))
    adam = interop._scale_by_adam_state(jts.opt_state)
    count, mu, nu = interop.adam_state_to_flax(ts.opt_state, ts.params, rt.cfg.flat_optimizer)
    assert count == int(adam.count) == rt.cfg.num_epochs * rt.cfg.num_minibatches
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w)
    assert (np.ndim(adam.mu) == 1) == rt.cfg.flat_optimizer
    vs = interop.vec_state_to_numpy(ts.vec_state)
    for f in type(ts.vec_state.env_state)._fields:
        np.testing.assert_array_equal(vs["env_state"][f], getattr(jts.vec_state.env_state, f))
    for f in ("obs", "ep_return", "ep_length"):
        np.testing.assert_array_equal(vs[f], getattr(jts.vec_state, f))
    if hasattr(jts, "hidden"):
        np.testing.assert_array_equal(ts.hidden.numpy(), jts.hidden)
        assert ts.hidden.abs().sum() > 0
    assert ts.env_steps == int(jts.env_steps) == rt.cfg.batch_total


# -- CLI, loop, checkpoints ---------------------------------------------------------------------
_TINY = {"PPO_FULL": dict(num_envs=2, rollout_steps=16, minibatch_size=16, num_epochs=1,
                          mhc_dim=16, mhc_sk_it=3),
         "PPO_LSTM": dict(num_envs=2, rollout_steps=16, seq_len=8, seq_minibatch=2, num_epochs=1,
                          mhc_dim=16, mhc_sk_it=3, rnn_hidden=16, rnd_embed=32)}


@pytest.mark.parametrize("name", ["ppo_full_lunarlander", "ppo_lstm_lunarlander"])
def test_cli_workload_trains_in_train_loop_on_cpu(name, tmp_path, monkeypatch, capsys):
    """The workload's trainer, config (``flat_optimizer=True``) and solve bar
    are the reference CLI's; a tiny config of the same trainer trains two
    iterations in TrainLoop with eval and a final checkpoint, and ``test``
    runs (carrying the hidden for ppo_lstm)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([]) == 1
    assert name in capsys.readouterr().out
    trainer, algo, solve = cli.WORKLOADS[name]("cpu")
    ref_trainer, ref_algo, ref_solve = ref_cli.WORKLOADS[name]()
    assert (algo, solve) == (ref_algo, ref_solve) == (algo, 200.0)
    assert type(trainer).__name__ == type(ref_trainer).__name__
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(ref_trainer.cfg)
    assert trainer.cfg.flat_optimizer and trainer.device == torch.device("cpu")

    small = type(trainer)(dataclasses.replace(trainer.cfg, **_TINY[algo]), device="cpu")
    loop = TrainLoop(small, algo, log_metrics=False, log_every=1, eval_every=32,
                     save_every=10 ** 9, eval_episodes=1)
    ts, stats = loop.train(64, solve_threshold=solve)
    assert stats["env_steps"] == ts.env_steps == 64
    assert len(stats["curve"]) == 2 and not stats["solved"]
    assert {int(s["step"]) for s in ts.opt_state.state.values()} == {2 * small.cfg.num_minibatches}
    assert (tmp_path / "checkpoints" / f"{algo}_{small.venv.env.name}.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


@pytest.mark.parametrize("kind", ["full", "lstm"])
def test_checkpoint_round_trip_and_mismatch_raises(kind, tmp_path):
    """Strict round trip of the whole state (params, Adam, env batch, the
    packed hidden, noise), then mismatches that raise."""
    base = dict(_FULL, clip_cov_ratio=0.2) if kind == "full" else dict(_LSTM, rnn_cell="lstm")
    classes = {"full": (PF.PPOFullTrainer, PF.PPOFullConfig),
               "lstm": (PL.PPOLSTMTrainer, PL.PPOLSTMConfig)}

    def make(kind, **o):
        trainer_cls, cfg_cls = classes[kind]
        kw = {k: v for k, v in {**base, **o}.items() if k in cfg_cls.__dataclass_fields__}
        return trainer_cls(cfg_cls(**kw), device="cpu")

    trainer = make(kind)
    ts, _ = trainer.train_iter(trainer.init(0))
    path = save_checkpoint(str(tmp_path / f"{kind}.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    assert restored.env_steps == ts.env_steps
    if kind == "lstm":
        assert torch.equal(restored.hidden, ts.hidden) and ts.hidden.abs().sum() > 0
    # the whole state came back: the next iteration is the same on both
    ts, out = trainer.train_iter(ts)
    restored, out_r = trainer.train_iter(restored)
    for k, v in ts.params.state_dict().items():
        torch.testing.assert_close(restored.params.state_dict()[k], v, rtol=0, atol=0)
    for k in out.metrics:
        torch.testing.assert_close(out_r.metrics[k], out.metrics[k], rtol=0, atol=0)

    with pytest.raises(ValueError, match="shared"):
        restore_checkpoint(path, make(kind, mhc_dim=16).init(0))
    with pytest.raises(ValueError, match="vec_state"):
        restore_checkpoint(path, make(kind, num_envs=4).init(0))
    with pytest.raises(ValueError, match="hidden"):
        restore_checkpoint(path, make("lstm" if kind == "full" else "full").init(0))
    if kind == "lstm":
        with pytest.raises(ValueError, match="rnn"):
            restore_checkpoint(path, make(kind, rnn_cell="gru").init(0))


@pytest.mark.parametrize("name", ["ppo_full_lunarlander", "ppo_lstm_lunarlander"])
def test_default_device_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cls = PF.PPOFullTrainer if name == "ppo_full_lunarlander" else PL.PPOLSTMTrainer
    cfg = (PF.PPOFullConfig if name == "ppo_full_lunarlander" else PL.PPOLSTMConfig)(num_envs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(cfg)
    with pytest.raises(ValueError, match="cell_type"):
        PL.PPOLSTMTrainer(PL.PPOLSTMConfig(num_envs=2, rnn_cell="rnn"), device="cpu").init(0)


def test_annealed_lr_and_entropy_coef():
    """lr and the entropy coefficient scale by ``1 − progress`` in float32,
    progress clipped to [0, 1], or stay fixed without ``anneal``
    (``test_anneal_moves_lr_and_ent_coef``)."""
    cfg = PF.PPOFullConfig(max_train_steps=8 * 16 * 4)
    for steps, frac in ((0, 1.0), (128, 0.75), (256, 0.5), (512, 0.0), (1024, 0.0)):
        lr, ent = PF.annealed(cfg, steps)
        assert (lr, ent) == (float(np.float32(3e-4) * np.float32(frac)),
                             float(np.float32(0.01) * np.float32(frac))), steps
    assert PF.annealed(dataclasses.replace(cfg, anneal=False), 512) == (
        float(np.float32(3e-4)), float(np.float32(0.01)))
    assert PF.annealed(PL.PPOLSTMConfig(max_train_steps=100), 50)[1] == float(
        np.float32(0.015) * np.float32(0.5))


def free_run_divergence(case: str) -> list[dict]:
    """Largest differences from the reference at the end of each iteration
    of ``test_train_iters_match_reference``'s schedule, and in its rollout:
    the numbers behind ``TRAJ_ATOL``."""
    rt = _ref_trainer(case)
    prep = _ref_fns(rt)[0]
    jts = _init(rt)
    rows = []
    for it in range(2):
        trainer, ts, _ = _port(case, jts)
        collected = []
        _record(trainer, "_collect", collected)
        roll_ref = jax.device_get(prep(jts)[0])
        jts, _ = rt.train_iter(jts)
        ts, _ = trainer.train_iter(ts)
        roll = collected[-1][1]
        ref = jax.device_get(jts)
        got, want = ts.params.state_dict(), _flax(ref.params)
        row = {"case": case, "iteration": it}
        for f in roll._fields:
            row[f"rollout_{f}"] = float(np.abs(getattr(roll, f).numpy().astype(np.float64)
                                               - getattr(roll_ref, f)).max())
        row.update(
            params=max(float(np.abs(got[k].numpy() - want[k].numpy()).max()) for k in want),
            obs=float(np.abs(ts.vec_state.obs.numpy() - ref.vec_state.obs).max()),
        )
        rows.append(row)
    return rows


if __name__ == "__main__":
    for case in sorted(CASES):
        for row in free_run_divergence(case):
            print(row)
