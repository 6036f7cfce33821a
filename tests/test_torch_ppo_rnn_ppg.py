"""The port's recurrent PPO and PPG trainers, their eval, CLI workloads,
checkpoints and the interop of their train state, against the JAX reference.

Both packages run on the CPU at narrow width (feature 32, GRU hidden 8). Each
iteration starts from the reference's state, carried across with
``interop.train_state_from_reference`` (params, the flat or per-leaf Adam
state, env batch, GRU hidden, obs statistics, reward scaler); the port's
noise source replays the reference's ``jax.random`` key splits
(``RNNReplayNoise``), so both trainers draw the same Gumbels, env noise and
epoch permutations.

Tolerances, each with its reason (the shared rules are those of
``test_torch_dqn.py`` and ``test_torch_dqn_variants.py``):
  * the rollout, a free run of T steps: actions, dones and the packed
    layout (mask, episode rows) exact; observations, values, log-probs and
    hiddens atol ``TRAJ_ATOL`` = 1e-4. The observations are normalized by
    running stds that start small (4 envs: the lander's first y-position
    std is 3.7e-3), which turns the physics' float32 rounding into up to
    2.4e-5 in the normalized obs and 1.9e-5 in the values (measured, printed
    by ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ppo_rnn_ppg.py``).
    Scaled rewards and value targets rtol 1e-5 + ``TRAJ_ATOL`` (a fresh
    CartPole batch's first scaled rewards are 5e7: the reward scaler's first
    std is 1e-8, as in the reference); standardized advantages
    ``TRAJ_ATOL`` plus the value targets' tolerance over the raw
    advantages' std.
  * every gradient step, held from the same state by ``RNNLockstep``:
    metrics rtol 1e-5, params atol 1e-5 under the Adam-sign and tie rules
    (``FamilyGradLog``: a pre-activation within 1e-5 of a PReLU kink moves
    its unit's row and the consumers' column, along
    ``RecurrentActorCritic.activation_edges``, by up to 2·lr per step).
  * the iteration as a whole: params under the same rules, counted over the
    iteration; hidden, env obs and statistics ``TRAJ_ATOL`` (rtol 1e-5
    for the statistics); metrics rtol 1e-5 + ``TRAJ_ATOL``; Adam counts,
    env steps and episode flags exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gymrl_tpu.algos import base as ref_base
from gymrl_tpu.algos import ppg as RG
from gymrl_tpu.algos import ppo_rnn as RP
from gymrl_tpu.core.gae import compute_gae as ref_compute_gae
from gymrl_tpu.core.gae import standardize as ref_standardize
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos import ppg as PG
from gymrl_tpu_torch.algos import ppo_rnn as PP
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_dqn import EnvReplay, assert_params_close, env_reset_draws, env_step_draws
from test_torch_dqn_variants import FamilyGradLog

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
TRAJ_ATOL = 1e-4
LR = 1e-3

# -- the cases, at narrow width ----------------------------------------------------------
_BASE = dict(feature_dim=32, num_envs=4, seq_minibatch=4, num_epochs=2)
CASES = {
    # chunks of 8 on LunarLander, per-leaf Adam
    "ppo_rnn_chunk": ("ppo", dict(_BASE, env_name="LunarLander-v3", rollout_steps=16, seq_len=8)),
    # whole episodes on CartPole (random episodes of ~20 steps overflow R=2), flat Adam
    "ppo_rnn_episode": ("ppo", dict(_BASE, env_name="CartPole-v1", rollout_steps=32,
                                    whole_episode_bptt=True, episode_rows_per_env=2,
                                    flat_optimizer=True)),
    # canonical PPG: aux skipped in iteration 0, run in iteration 1
    "ppg_current": ("ppg", dict(_BASE, env_name="CartPole-v1", rollout_steps=32,
                                whole_episode_bptt=True, episode_rows_per_env=2,
                                flat_optimizer=True, aux_epochs=2, aux_every=2)),
    # the reference script's PPG: behaviour clone every iteration, chunks
    # that cross episode boundaries
    "ppg_behavior": ("ppg", dict(_BASE, env_name="CartPole-v1", rollout_steps=16, seq_len=8,
                                 aux_epochs=2, clone_target="behavior", aux_every=1)),
}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


@pytest.fixture(scope="module")
def refs():
    """One reference trainer per case for the file (each jitted function
    compiles once), made on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            kind, kw = CASES[case]
            cache[case] = (RP.PPORNNTrainer(RP.PPORNNConfig(**kw)) if kind == "ppo"
                           else RG.PPGTrainer(RG.PPGConfig(**kw)))
        return cache[case]

    return get


_INITS: dict = {}


def _init(rt):
    """The reference's state from ``PRNGKey(0)``, made once per trainer
    (jitted: its eager env reset is thousands of tiny dispatches)."""
    if rt not in _INITS:
        _INITS[rt] = jax.jit(rt.init)(jax.random.PRNGKey(0))
    return _INITS[rt]


# -- replaying the reference's draws ---------------------------------------------------
class RNNReplayNoise(EnvReplay):
    """Replays the recurrent trainers' key tree: per rollout step
    ``split(key, 3)`` into (key, action, env step), asked for by the
    action's ``gumbel``; ``VecEnv.step`` splits the env step key into (step,
    reset). After collection recurrent PPO splits ``(key, epochs)`` and
    PPG ``(key, phase 1, phase 2)``, each then one permutation key per epoch.
    ``calls`` records the order."""

    def __init__(self, key):
        self.key = key
        self.calls: list[str] = []

    def gumbel(self, shape):
        self.calls.append("gumbel")
        self.key, k_act, self.k_step = jax.random.split(self.key, 3)
        return _t(jax.random.gumbel(k_act, tuple(shape), jnp.float32))

    def env_step(self, env, num):
        self.calls.append("env_step")
        return super().env_step(env, num)

    def env_reset(self, env, num):
        self.calls.append("env_reset")
        return super().env_reset(env, num)

    @staticmethod
    def _perms(key, count, n):
        return torch.stack([_t(jax.random.permutation(k, n))
                            for k in jax.random.split(key, count)]).long()

    def permutations(self, count, n):
        self.calls.append("permutations")
        self.key, k = jax.random.split(self.key)
        return self._perms(k, count, n)

    def ppg_permutations(self, count1, count2, n):
        self.calls.append("ppg_permutations")
        self.key, k1, k2 = jax.random.split(self.key, 3)
        return self._perms(k1, count1, n), self._perms(k2, count2, n)


def _port(case, jts):
    """The port trainer of the case and the reference state carried across."""
    kind, kw = CASES[case]
    trainer = (PP.PPORNNTrainer(PP.PPORNNConfig(**kw), device="cpu") if kind == "ppo"
               else PG.PPGTrainer(PG.PPGConfig(**kw), device="cpu"))
    noise = RNNReplayNoise(jts.key)
    return trainer, interop.train_state_from_reference(trainer, jax.device_get(jts), noise), noise


# -- the reference's pieces, jitted once per trainer ---------------------------------------
_REF_FNS: dict = {}


def _ref_fns(rt):
    """The reference's collection and training rows (its ``_train_iter`` up
    to ``pack_fields``) and its minibatch step, phase 1 or 2, for a spec."""
    if rt in _REF_FNS:
        return _REF_FNS[rt]
    cfg = rt.cfg

    @jax.jit
    def prep(jts):
        _, _, _, _, _, roll, _ = rt._collect(jts)
        flat_h = roll.h_post.reshape(-1, roll.h_post.shape[-1])
        flat_next = roll.next_obs.reshape(-1, roll.next_obs.shape[-1])
        next_values = rt._apply_cell(jts.params, flat_h, flat_next)[2].reshape(roll.value.shape)
        adv, v_target = ref_compute_gae(roll.reward, roll.value, next_values, roll.terminated,
                                        roll.done, cfg.gamma, cfg.gae_lambda)
        data, _, _ = rt._training_data(roll, ref_standardize(adv), v_target)
        return roll, ref_base.pack_fields(data)[0], jnp.std(adv)

    steps = {}

    def step(spec, aux):
        key = (tuple((k, v[:3]) for k, v in spec.items()), aux)
        if key not in steps:
            ref_spec = {k: (a, b, shape, {torch.float32: jnp.float32, torch.int32: jnp.int32,
                                          torch.bool: jnp.bool_}[dt])
                        for k, (a, b, shape, dt) in spec.items()}

            def one(params, opt_state, rows):
                p0, unravel = ref_base.flat_params_repr(params, cfg.flat_optimizer)
                loss = rt._aux_loss if aux else rt._loss
                (_, metrics), grads = jax.value_and_grad(
                    lambda p, mb: loss(unravel(p), mb), has_aux=True)(
                        p0, ref_base.unpack_fields(rows, ref_spec))
                updates, opt_state = rt.tx.update(grads, opt_state, p0)
                return unravel(optax.apply_updates(p0, updates)), opt_state, metrics

            steps[key] = jax.jit(one)
        return steps[key]

    _REF_FNS[rt] = (prep, step)
    return _REF_FNS[rt]


_OPT_TEMPLATES: dict = {}


def _jax_opt(rt, net, opt):
    """The port's Adam as the reference's optax state, on a template of its
    structure made once per trainer."""
    flat = rt.cfg.flat_optimizer
    if rt not in _OPT_TEMPLATES:
        params = interop.params_to_flax(dict(net.named_parameters()))
        _OPT_TEMPLATES[rt] = rt.tx.init(jnp.asarray(interop.ravel_flax(params)) if flat
                                        else params)
    clip, (adam, *rest) = _OPT_TEMPLATES[rt]
    count, mu, nu = interop.adam_state_to_flax(opt, net, flat)
    return (clip, (adam._replace(count=jnp.asarray(count), mu=mu, nu=nu), *rest))


class RNNLockstep:
    """Holds every gradient step of a port ``train_iter`` to the reference's
    minibatch step (its loss, ``tx.update`` and ``apply_updates``) from the
    same params, Adam state and packed rows: metrics rtol 1e-5, params
    under the Adam-sign and tie rules of that step, the Adam count."""

    def __init__(self, rt, trainer, log: FamilyGradLog):
        self.steps = {"phase1": 0, "aux": 0}
        self.log = log
        _, step_fn = _ref_fns(rt)
        grad_step = trainer._grad_step

        def checked(ts, rows, spec, loss_fn):
            aux = loss_fn == trainer._aux_loss if hasattr(trainer, "_aux_loss") else False
            net, opt = ts.params, ts.opt_state
            ref_in = (interop.params_to_flax(dict(net.named_parameters())),
                      _jax_opt(rt, net, opt), jnp.asarray(rows.numpy().copy()))
            counts0 = {k: np.array(v, copy=True) for k, v in self.log.counts.items()}
            metrics = grad_step(ts, rows, spec, loss_fn)
            params, opt_state, ref_metrics = jax.device_get(step_fn(spec, aux)(*ref_in))
            phase = "aux" if aux else "phase1"
            where = f"{phase} step {self.steps[phase]}"
            assert set(metrics) == set(ref_metrics), where
            for k, v in ref_metrics.items():
                np.testing.assert_allclose(float(metrics[k]), float(v), rtol=RTOL, atol=1e-7,
                                           err_msg=f"{k} {where}")
            this_step = {k: v - counts0.get(k, 0) for k, v in self.log.counts.items()}
            assert_params_close(net.state_dict(), _flax(params), LR, this_step, where)
            count = int(opt_state[1][0].count)
            assert {int(s["step"]) for s in opt.state.values()} == {count}, where
            self.steps[phase] += 1
            return metrics

        trainer._grad_step = checked


def _record(obj, name, calls):
    """Wrap method ``name`` of ``obj`` to append its result to ``calls``."""
    method = getattr(obj, name)

    def wrapped(*args):
        out = method(*args)
        calls.append(out)
        return out

    setattr(obj, name, wrapped)


def _assert_rollout_close(trainer, roll, packed, spec, ref, where):
    """The port's rollout and packed rows against the reference's (``prep``)."""
    roll_ref, packed_ref, adv_std = jax.device_get(ref)
    np.testing.assert_array_equal(roll.action.numpy(), roll_ref.action, err_msg=where)
    for f in ("terminated", "done"):
        np.testing.assert_array_equal(getattr(roll, f).numpy(), getattr(roll_ref, f),
                                      err_msg=f"{f} {where}")
    for f in ("obs", "next_obs", "value", "logp", "h_pre", "h_post"):
        np.testing.assert_allclose(getattr(roll, f).numpy(), getattr(roll_ref, f), rtol=0,
                                   atol=TRAJ_ATOL, err_msg=f"{f} {where}")
    np.testing.assert_allclose(roll.reward.numpy(), roll_ref.reward, rtol=RTOL, atol=TRAJ_ATOL,
                               err_msg=f"reward {where}")
    got, want = packed.numpy(), np.asarray(packed_ref)
    assert got.shape == want.shape, where
    v_target_tol = RTOL * np.abs(want[:, slice(*spec["v_target"][:2])]).max() + TRAJ_ATOL
    for k, (a, b, _, dtype) in spec.items():
        g, w = got[:, a:b], want[:, a:b]
        if dtype != torch.float32 or k == "mask":
            np.testing.assert_array_equal(g, w, err_msg=f"packed {k} {where}")
        elif k == "v_target":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=TRAJ_ATOL,
                                       err_msg=f"packed {k} {where}")
        elif k == "adv":
            np.testing.assert_allclose(g, w, rtol=0, atol=TRAJ_ATOL + v_target_tol / adv_std,
                                       err_msg=f"packed {k} {where}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TRAJ_ATOL, err_msg=f"packed {k} {where}")


def _assert_state_close(ts, out, jts, jout, log, where):
    jts = jax.device_get(jts)
    assert ts.env_steps == int(jts.env_steps), where
    assert_params_close(ts.params.state_dict(), _flax(jts.params), LR, log.counts, where)
    count = int(np.asarray(interop._scale_by_adam_state(jts.opt_state).count))
    assert {int(s["step"]) for s in ts.opt_state.state.values()} == {count}, where
    np.testing.assert_allclose(ts.hidden.numpy(), jts.hidden, rtol=0, atol=TRAJ_ATOL,
                               err_msg=where)
    np.testing.assert_allclose(ts.vec_state.obs.numpy(), jts.vec_state.obs, rtol=0,
                               atol=TRAJ_ATOL, err_msg=where)
    for f, x in zip(ts.obs_rms._fields, ts.obs_rms):
        np.testing.assert_allclose(x.numpy(), getattr(jts.obs_rms, f), rtol=RTOL, atol=1e-6,
                                   err_msg=f"obs_rms {f} {where}")
    for f, x in zip(ts.reward_scaler.rms._fields, ts.reward_scaler.rms):
        np.testing.assert_allclose(x.numpy(), getattr(jts.reward_scaler.rms, f), rtol=RTOL,
                                   atol=1e-6, err_msg=f"reward_scaler {f} {where}")
    np.testing.assert_allclose(ts.reward_scaler.ret.numpy(), jts.reward_scaler.ret, rtol=RTOL,
                               atol=TRAJ_ATOL, err_msg=where)
    for f in ("ep_done", "ep_length"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                      err_msg=f"{f} {where}")
    np.testing.assert_allclose(out.ep_return.numpy(), np.asarray(jout.ep_return), rtol=RTOL,
                               atol=1e-4, err_msg=where)
    assert set(out.metrics) == set(jout.metrics), where
    for k, v in jout.metrics.items():
        np.testing.assert_allclose(float(out.metrics[k]), float(v), rtol=RTOL, atol=TRAJ_ATOL,
                                   err_msg=f"{k} {where}")


# -- the slice as a whole --------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_iters_match_reference(refs, case):
    """Two iterations from the reference's init with its noise replayed.
    Each starts from the reference's state; the port asks for its draws in
    the reference's order; the rollout, the packed rows and every gradient
    step (``RNNLockstep``) are held to the reference's from the same state;
    the iteration ends with the reference's params, Adam count, hidden, env
    batch, statistics and metrics. PPG's auxiliary phase runs exactly where
    the cadence says, and its metrics are zero where it is skipped."""
    rt = refs(case)
    prep, _ = _ref_fns(rt)
    jts = _init(rt)
    episodes = 0
    for it in range(2):
        trainer, ts, noise = _port(case, jts)
        log = FamilyGradLog(ts.params, ts.opt_state)
        lockstep = RNNLockstep(rt, trainer, log)
        collected, prepared = [], []
        _record(trainer, "_collect", collected)
        _record(trainer, "_rollout_and_data", prepared)
        ref = prep(jts)
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"{case} iteration {it}"
        cfg = trainer.cfg

        _, roll, _ = collected[-1]
        _, _, data, packed, spec, _ = prepared[-1]
        _assert_rollout_close(trainer, roll, packed, spec, ref, where)
        _assert_state_close(ts, out, jts, jout, log, where)

        aux = isinstance(trainer, PG.PPGTrainer) and trainer.aux_runs(it * cfg.batch_total)
        per_phase = cfg.num_minibatches
        assert lockstep.steps == {"phase1": cfg.num_epochs * per_phase,
                                  "aux": cfg.aux_epochs * per_phase if aux else 0}, where
        steps = {"gumbel": cfg.rollout_steps, "env_step": cfg.rollout_steps,
                 "env_reset": cfg.rollout_steps}
        assert {k: noise.calls.count(k) for k in steps} == steps, where
        assert noise.calls[-1] == ("ppg_permutations" if isinstance(trainer, PG.PPGTrainer)
                                   else "permutations"), where
        if isinstance(trainer, PG.PPGTrainer):
            assert (float(out.metrics["aux_value_loss"]) != 0.0) == aux, where
            assert aux == (cfg.aux_every == 1 or it == 1), where
        # the hidden restarts at zero exactly where the last step ended an episode
        last_done = roll.done[-1].bool()
        assert not ts.hidden[last_done].any() and ts.hidden[~last_done].abs().sum(-1).gt(0).all()
        if cfg.whole_episode_bptt:
            R = cfg.episode_rows_per_env
            np.testing.assert_array_equal(data["h0"][::R].numpy(), roll.h_pre[0].numpy())
            fresh = np.ones(len(data["h0"]), bool)
            fresh[::R] = False
            assert not data["h0"][fresh].any(), "a fresh episode's row starts from zero"
            episodes += int(out.metrics["dropped_episodes"])
        episodes += int(out.ep_done.sum())
    if trainer.cfg.env_name == "CartPole-v1":
        assert episodes > 0, "episodes should end inside the test"


# -- policy surface ------------------------------------------------------------------------
def test_policy_step_carries_hidden(refs):
    """``tests/test_ppo_rnn.py::test_policy_step_carries_hidden`` against the
    reference: the carry evolves, equals the reference's, and ``policy``
    is the memoryless view (a fresh carry every call)."""
    rt = refs("ppo_rnn_chunk")
    jts, _ = rt.train_iter(_init(rt))  # obs statistics in use
    trainer, ts, _ = _port("ppo_rnn_chunk", jts)
    obs = np.asarray(jts.vec_state.obs[:1])  # a lander state the statistics have seen
    c0 = trainer.policy_reset(1)
    assert c0.shape == (1, 8) and not c0.any()
    c1, a1 = trainer.policy_step(ts, c0, _t(obs), Noise("cpu", 0))
    c2, a2 = trainer.policy_step(ts, c1, _t(obs), Noise("cpu", 0))
    assert not torch.allclose(c1, c0) and not torch.allclose(c2, c1)
    key = jax.random.PRNGKey(1)
    j1, ja1 = rt.policy_step(jts, jnp.zeros((1, 8)), jnp.asarray(obs), key)
    j2, ja2 = rt.policy_step(jts, j1, jnp.asarray(obs), key)
    np.testing.assert_allclose(c2.numpy(), np.asarray(j2), rtol=0, atol=ATOL)
    assert (int(a1), int(a2)) == (int(ja1[0]), int(ja2[0]))
    a_stateless = trainer.policy(ts, _t(obs), Noise("cpu", 0))
    assert int(a_stateless) == int(a1)
    # stochastic: Gumbel-max on the same logits
    _, a = trainer.policy_step(ts, c1, _t(obs).repeat(256, 1), Noise("cpu", 3), False)
    assert 0 < a.float().mean() < 3


class _EvalReplay(EnvReplay):
    """Replays the recurrent ``eval_episodes``' key splits: ``split(key)``
    into (reset, roll) keys, then ``split(roll, max_steps)``, one env step
    key per step."""

    def __init__(self, key, max_steps):
        self.k_reset, k_roll = jax.random.split(key)
        self.step_keys = iter(jax.random.split(k_roll, max_steps))

    def env_step(self, env, num):
        return env_step_draws(env, next(self.step_keys), num)

    def env_reset(self, env, num):
        return env_reset_draws(env, self.k_reset, num)


@pytest.mark.parametrize("case", ["ppo_rnn_episode", "ppg_current"])
def test_recurrent_eval_episodes_match_reference(refs, case):
    """The hidden carried through each episode: the reference's returns and
    lengths (it scans to max_steps with rewards masked after done; the port
    stops once every episode is done)."""
    rt = refs(case)
    jts = _init(rt)
    trainer, ts, _ = _port(case, jts)
    key = jax.random.PRNGKey(4)
    want_ret, want_len = rt.eval_episodes(jts, key, 3)
    ret, length = trainer.eval_episodes(ts, _EvalReplay(key, trainer.venv.env.max_steps), 3)
    np.testing.assert_array_equal(length.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), rtol=1e-5, atol=1e-3)


# -- interop ----------------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["ppo_rnn_chunk", "ppg_current"])
def test_train_state_interop_round_trips(refs, case):
    """A reference ``RNNTrainState`` after an iteration (per-leaf Adam, or
    the flat optimizer's raveled vectors) carried into the port and back to
    numpy is the reference's to the bit: params, Adam moments and count,
    env batch, hidden, obs statistics, reward scaler and env steps."""
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
    assert count == int(adam.count) > 0
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w)
    assert (np.ndim(adam.mu) == 1) == rt.cfg.flat_optimizer
    vs = interop.vec_state_to_numpy(ts.vec_state)
    for f in type(ts.vec_state.env_state)._fields:
        np.testing.assert_array_equal(vs["env_state"][f], getattr(jts.vec_state.env_state, f))
    for f in ("obs", "ep_return", "ep_length"):
        np.testing.assert_array_equal(vs[f], getattr(jts.vec_state, f))
    np.testing.assert_array_equal(ts.hidden.numpy(), jts.hidden)
    assert ts.hidden.abs().sum() > 0
    for f, x in zip(ts.obs_rms._fields, ts.obs_rms):
        np.testing.assert_array_equal(x.numpy(), getattr(jts.obs_rms, f), err_msg=f)
    for f, x in zip(ts.reward_scaler.rms._fields, ts.reward_scaler.rms):
        np.testing.assert_array_equal(x.numpy(), getattr(jts.reward_scaler.rms, f), err_msg=f)
    np.testing.assert_array_equal(ts.reward_scaler.ret.numpy(), jts.reward_scaler.ret)
    assert np.float32(ts.reward_scaler.gamma) == jts.reward_scaler.gamma
    assert ts.env_steps == int(jts.env_steps) == rt.cfg.num_envs * rt.cfg.rollout_steps


# -- CLI, loop, checkpoints ---------------------------------------------------------------------
_TINY = dict(num_envs=2, rollout_steps=16, feature_dim=32, episode_rows_per_env=2,
             seq_minibatch=2, num_epochs=1)


@pytest.mark.parametrize("name", ["ppo_rnn_lunarlander", "ppo_rnn_flappybird",
                                  "ppg_rnn_lunarlander"])
def test_cli_workload_trains_in_train_loop_on_cpu(name, tmp_path, monkeypatch, capsys):
    """The workload's trainer, config and solve bar are the reference CLI's;
    a tiny config of the same trainer trains two iterations in TrainLoop
    with eval and a final checkpoint, and ``test`` carries the hidden."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([]) == 1
    assert name in capsys.readouterr().out
    trainer, algo, solve = cli.WORKLOADS[name]("cpu")
    ref_trainer, ref_algo, ref_solve = ref_cli.WORKLOADS[name]()
    assert (algo, solve) == (ref_algo, ref_solve)
    assert type(trainer).__name__ == type(ref_trainer).__name__
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(ref_trainer.cfg)
    assert trainer.device == torch.device("cpu")

    tiny = dict(_TINY, aux_epochs=1, aux_every=2) if algo == "PPG_RNN" else _TINY
    small = type(trainer)(dataclasses.replace(trainer.cfg, **tiny), device="cpu")
    loop = TrainLoop(small, algo, log_metrics=False, log_every=1, eval_every=32,
                     save_every=10 ** 9, eval_episodes=1)
    ts, stats = loop.train(64, solve_threshold=solve)
    assert stats["env_steps"] == ts.env_steps == 64
    assert len(stats["curve"]) == 2 and not stats["solved"]
    steps = 2 * 1 * small.cfg.num_minibatches + (small.cfg.num_minibatches
                                                 if algo == "PPG_RNN" else 0)
    assert {int(s["step"]) for s in ts.opt_state.state.values()} == {steps}
    assert (tmp_path / "checkpoints" / f"{algo}_{small.venv.env.name}.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


@pytest.mark.parametrize("kind", ["ppo", "ppg"])
def test_checkpoint_round_trip_and_mismatch_raises(kind, tmp_path):
    """Strict round trip of the whole recurrent state (hidden, reward scaler,
    obs statistics, Adam, noise), then mismatches that raise."""
    ppg_only = ("aux_epochs", "aux_every", "clone_target")
    kw = {k: v for k, v in CASES["ppg_current"][1].items() if k not in ppg_only}
    classes = {"ppo": (PP.PPORNNTrainer, PP.PPORNNConfig, {}),
               "ppg": (PG.PPGTrainer, PG.PPGConfig, dict(aux_epochs=2, aux_every=1))}

    def make(kind, **o):
        trainer_cls, cfg_cls, extra = classes[kind]
        return trainer_cls(cfg_cls(**{**kw, **extra, **o}), device="cpu")

    trainer = make(kind)
    ts, _ = trainer.train_iter(trainer.init(0))
    path = save_checkpoint(str(tmp_path / "rnn.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    assert restored.env_steps == ts.env_steps
    for part in ("hidden", "obs_rms", "reward_scaler"):
        for x, y in zip(jax.tree_util.tree_leaves(getattr(restored, part)),
                        jax.tree_util.tree_leaves(getattr(ts, part))):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=part)
    assert ts.hidden.abs().sum() > 0
    # the whole state came back: the next iteration is the same on both
    ts, out = trainer.train_iter(ts)
    restored, out_r = trainer.train_iter(restored)
    for k, v in ts.params.state_dict().items():
        torch.testing.assert_close(restored.params.state_dict()[k], v, rtol=0, atol=0)
    for k in out.metrics:
        torch.testing.assert_close(out_r.metrics[k], out.metrics[k], rtol=0, atol=0)

    with pytest.raises(ValueError, match="fc_head"):
        restore_checkpoint(path, make(kind, feature_dim=16).init(0))
    with pytest.raises(ValueError, match="vec_state"):
        restore_checkpoint(path, make(kind, num_envs=8).init(0))
    with pytest.raises(ValueError, match="aux_critic_fc"):
        restore_checkpoint(path, make("ppg" if kind == "ppo" else "ppo").init(0))


@pytest.mark.parametrize("name", ["ppo_rnn_lunarlander", "ppg_rnn_lunarlander"])
def test_default_device_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from gymrl_tpu_torch.algos.ppg import ppg_rnn_lunarlander_config
    from gymrl_tpu_torch.algos.ppo_rnn import ppo_rnn_lunarlander_config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if name == "ppo_rnn_lunarlander":
            PP.PPORNNTrainer(ppo_rnn_lunarlander_config(num_envs=2))
        else:
            PG.PPGTrainer(ppg_rnn_lunarlander_config(num_envs=2))
    with pytest.raises(ValueError, match="clone_target"):
        PG.PPGTrainer(PG.PPGConfig(clone_target="kl"), device="cpu")


def free_run_divergence(case: str) -> list[dict]:
    """Largest differences from the reference at the end of each iteration
    of ``test_train_iters_match_reference``'s schedule, and in its rollout:
    the numbers behind ``TRAJ_ATOL``."""
    kind, kw = CASES[case]
    rt = RP.PPORNNTrainer(RP.PPORNNConfig(**kw)) if kind == "ppo" else RG.PPGTrainer(
        RG.PPGConfig(**kw))
    prep, _ = _ref_fns(rt)
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
        for f in ("obs", "value", "logp", "reward", "h_post"):
            row[f"rollout_{f}"] = float(np.abs(getattr(roll, f).numpy()
                                               - getattr(roll_ref, f)).max())
        row.update(
            params=max(float(np.abs(got[k].numpy() - want[k].numpy()).max()) for k in want),
            hidden=float(np.abs(ts.hidden.numpy() - ref.hidden).max()),
            obs=float(np.abs(ts.vec_state.obs.numpy() - ref.vec_state.obs).max()),
        )
        rows.append(row)
    return rows


if __name__ == "__main__":
    for case in sorted(CASES):
        for row in free_run_divergence(case):
            print(row)
