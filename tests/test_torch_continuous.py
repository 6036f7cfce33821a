"""The port's Pendulum, continuous LunarLander, DDPG, TD3, SAC and discrete
SAC, and the interop of their states, against the JAX reference.

Both packages run on the CPU. Weights, targets, Adam states, replay contents
and env batches start from the reference's own, carried across with
``interop.train_state_from_reference``; the port's noise source replays the
reference's ``jax.random`` key splits (``OffPolicyReplayNoise``), so both
trainers draw the same numbers.

Tolerances, each with its reason (the shared rules are those of
``test_torch_dqn.py``):
  * Pendulum state and observations: atol 1e-6 (O(1)-O(10) float32; the
    frameworks round ``sin``/``cos`` and fused ``a*b + c`` differently);
    rewards atol 1e-5 (a cost of up to ~16, whose float32 spacing is 1e-6).
  * network outputs, ``squashed_sample`` values and log-probs, losses,
    metrics, continuous actions: atol 1e-5 / rtol 1e-5.
  * gradients, read from Adam's first moment after one step from zero
    (``mu = 0.1·g``) and second (``nu = 0.001·g²``): rtol 1e-5 plus an atol
    of 1e-5 of each tensor's largest entry.
  * params after Adam (eps 1e-8): atol 1e-5, with the Adam-sign and ReLU-tie
    rules of ``test_torch_dqn.py`` (entries whose update float32 agreement
    does not fix are held to 2·lr per such update).
  * episode returns: the reward tolerance times the episode's length.
  * integer and boolean data (discrete actions, flags, counters, replay
    pos/size, Adam counts): exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.algos import continuous as R
from gymrl_tpu.envs.lunarlander import LunarLander as RefLander
from gymrl_tpu.envs.pendulum import Pendulum as RefPendulum
from gymrl_tpu.envs.pendulum import PendulumState as RefPendulumState
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos import continuous as C
from gymrl_tpu_torch.envs.lunarlander import LunarLander
from gymrl_tpu_torch.envs.pendulum import Pendulum, PendulumState
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_dqn import (
    ATOL, ENV_ATOL, RTOL, EnvReplay, GradLog, assert_params_close, assert_state_close,
    env_reset_draws, tiny_grad,
)
from test_torch_lunarlander import assert_step_close, jax_step_draws

torch.set_num_threads(1)

REWARD_ATOL = 1e-5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class OffPolicyReplayNoise(EnvReplay):
    """Replays ``OffPolicyContinuousTrainer``'s key tree: per env step
    ``split(key, 4)`` into (key, act, env step, updates), the act key giving
    the exploration normals or the categorical's Gumbels; then
    ``split(k_upd, n_updates)`` and per update ``split`` into (replay
    sample, update), the update key giving TD3's smoothing normals or
    SAC's ``split`` into (next, new) samples."""

    def __init__(self, key, n_updates: int):
        self.key = key
        self.n_updates = n_updates
        self.upd_keys = iter(())
        self.k_u = None
        self.calls: list[str] = []  # the order the port asked for its draws

    def __getattribute__(self, name):
        if name in ("action_noise", "gumbel", "env_step", "env_reset", "replay_indices",
                    "target_noise", "sac_update_noise"):
            object.__getattribute__(self, "calls").append(name)
        return object.__getattribute__(self, name)

    def _act_key(self):
        self.key, self.k_act, self.k_step, k_upd = jax.random.split(self.key, 4)
        self.upd_keys = iter(jax.random.split(k_upd, self.n_updates))
        return self.k_act

    def action_noise(self, shape):
        return _t(jax.random.normal(self._act_key(), tuple(shape)))

    def gumbel(self, shape):
        return _t(jax.random.gumbel(self._act_key(), tuple(shape)))

    def replay_indices(self, batch_size, high):
        k_s, self.k_u = jax.random.split(next(self.upd_keys))
        return _t(jax.random.randint(k_s, (batch_size,), 0, high)).long()

    def target_noise(self, shape):
        return _t(jax.random.normal(self.k_u, tuple(shape)))

    def sac_update_noise(self, shape):
        k_next, k_new = jax.random.split(self.k_u)
        return (_t(jax.random.normal(k_next, tuple(shape))),
                _t(jax.random.normal(k_new, tuple(shape))))


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


# -- Pendulum -----------------------------------------------------------------------
_REF_PD = RefPendulum()


def test_pendulum_reset_matches_reference():
    env = Pendulum()
    key = jax.random.PRNGKey(5)
    ref_state, ref_obs = jax.jit(_REF_PD.reset_batch, static_argnums=2)(
        _REF_PD.default_params(), key, 16)
    state, obs = env.reset_from(env.default_params(), env_reset_draws(env, key, 16))
    assert_state_close(state, ref_state, where="reset")
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=0, atol=ENV_ATOL)
    assert np.abs(state.theta.numpy()).max() <= np.pi


def test_pendulum_step_matches_reference():
    """B=16 states with angles far past ±π (the floor modulo of the cost
    takes the divisor's sign) and speeds at and beyond the ±8 clip, driven
    30 steps with torques beyond the ±2 clip. Each step starts from the
    reference's state, so the tolerance bounds one step's rounding (at
    |θ̇| near 8 one float32 step is 4.8e-7; over many steps they add up)."""
    rng = np.random.default_rng(0)
    theta = np.array([-10.0, -7.0, -4.0, -np.pi - 1e-3, -3.0, -1.0, 0.0, 0.5, 2.0, np.pi + 1e-3,
                      4.0, 7.0, 10.0, -5.5, 5.5, 12.0], np.float32)
    theta_dot = np.array([8.0, -8.0, 7.99, -7.99, 0.0, 1.0, -1.0, 3.0, -3.0, 6.0, -6.0, 7.5,
                          -7.5, 2.0, -2.0, 0.5], np.float32)
    t = np.zeros(16, np.int32)
    t[:2] = 199  # these two truncate on the first step
    ref_state = RefPendulumState(jnp.asarray(theta), jnp.asarray(theta_dot), jnp.asarray(t))
    env, params, ref_params = Pendulum(), Pendulum().default_params(), _REF_PD.default_params()
    step = jax.jit(_REF_PD.step_batch)
    for i in range(30):
        a = rng.uniform(-3.0, 3.0, (16, 1)).astype(np.float32)
        ref_sr = step(ref_params, ref_state, jnp.asarray(a), jax.random.PRNGKey(i))
        state = interop.state_from_numpy(jax.device_get(ref_state), PendulumState)
        sr = env.step_from(params, state, torch.from_numpy(a), None)
        assert_state_close(sr.state, ref_sr.state, where=f"step {i}")
        np.testing.assert_allclose(sr.obs.numpy(), np.asarray(ref_sr.obs), rtol=0, atol=ENV_ATOL)
        np.testing.assert_allclose(sr.reward.numpy(), np.asarray(ref_sr.reward), rtol=0,
                                   atol=REWARD_ATOL, err_msg=f"reward step {i}")
        for f in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(sr, f).numpy(), np.asarray(getattr(ref_sr, f)))
        if i == 0:
            assert sr.truncated.numpy()[:2].all() and not sr.truncated.numpy()[2:].any()
            assert np.abs(sr.state.theta_dot.numpy()).max() == 8.0  # the clip acted
        ref_state = ref_sr.state
    assert not sr.terminated.any()


# -- continuous LunarLander (mirrors tests/test_lunarlander.py:181-199) -------------
def test_continuous_lander_action_mapping_matches_reference():
    """Throttles in every band: main off (a0 ≤ 0), on in (0, 1] and clipped
    above 1; side off (|a1| ≤ 0.5), on in (0.5, 1] on both sides and
    clipped beyond ±1. Both engines, the same states and dispersion draws."""
    ref_env = RefLander(continuous=True)
    env = LunarLander(continuous=True)
    assert (env.act_dim, env.action_bound, env.n_actions) == (2, 1.0, None)
    ref_params, params = ref_env.default_params(), env.default_params()
    main = [-1.0, -0.2, 0.0, 0.3, 0.8, 1.0, 1.5, 0.6]
    side = [0.0, 0.5, -0.5, 0.51, -0.7, 0.9, -1.0, 1.4, -2.0, 0.2]
    actions = np.array([(m, s) for m in main for s in side], np.float32)  # 80 pairs
    num = len(actions)
    key = jax.random.PRNGKey(2)
    ref_state, _ = jax.jit(ref_env.reset_batch, static_argnums=2)(ref_params, key, num)
    state, _ = env.reset_from(params, env_reset_draws(env, key, num))
    step = jax.jit(ref_env.step_batch)
    for i in range(12):
        a = np.roll(actions, i, axis=0)
        k = jax.random.PRNGKey(100 + i)
        ref_sr = step(ref_params, ref_state, jnp.asarray(a), k)
        sr = env.step_from(params, state, torch.from_numpy(a), jax_step_draws(k, num))
        assert_step_close(sr, ref_sr, f"step {i}")
        ref_state, state = ref_sr.state, sr.state


# -- networks and squashed_sample ---------------------------------------------------------
def _ref_net_and_port(kind, rng):
    obs_dim, act_dim, n_act, hid = 3, 2, 3, 32
    k = jax.random.PRNGKey(1)
    s = jnp.asarray(rng.normal(size=(64, obs_dim)).astype(np.float32))
    a = jnp.asarray(rng.uniform(-2, 2, size=(64, act_dim)).astype(np.float32))
    table = {
        "DeterministicActor": (R.DeterministicActor(act_dim, 2.0, hid),
                               C.DeterministicActor(obs_dim, act_dim, 2.0, hid), (s,)),
        "QCritic": (R.QCritic(hid), C.QCritic(obs_dim, act_dim, hid), (s, a)),
        "TwinQCritic": (R.TwinQCritic(hid), C.TwinQCritic(obs_dim, act_dim, hid), (s, a)),
        "SquashedGaussianActor": (R.SquashedGaussianActor(act_dim, 2.0, hid),
                                  C.SquashedGaussianActor(obs_dim, act_dim, hid), (s,)),
        "SoftmaxActor": (R.SoftmaxActor(n_act, hid), C.SoftmaxActor(obs_dim, n_act, hid), (s,)),
        "PerActionQ": (R.PerActionQ(n_act, hid), C.PerActionQ(obs_dim, n_act, hid), (s,)),
    }
    ref_net, net, args = table[kind]
    variables = ref_net.init(k, *args)
    # nonzero biases, so the bias mapping is checked too
    variables = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(scale=0.1, size=p.shape), jnp.float32), variables)
    net.load_state_dict(_flax(variables))
    return ref_net.apply(variables, *args), net(*map(_t, args)), variables, net


@pytest.mark.parametrize("kind", ["DeterministicActor", "QCritic", "TwinQCritic",
                                  "SquashedGaussianActor", "SoftmaxActor", "PerActionQ"])
def test_networks_match_flax(kind, rng):
    want, got, variables, net = _ref_net_and_port(kind, rng)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)
    # names map one to one, nested modules by dotted path, both ways
    back = interop.params_to_flax(net.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(variables)):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_squashed_sample_matches_reference(rng):
    mean = rng.normal(size=(256, 2)).astype(np.float32)
    log_std = rng.uniform(-5.0, 2.0, size=(256, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_a, want_logp = R.squashed_sample(jnp.asarray(mean), jnp.asarray(log_std), 2.0, key)
    a, logp = C.squashed_sample(_t(mean), _t(log_std), 2.0,
                                _t(jax.random.normal(key, mean.shape)))
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=0, atol=ATOL)
    # The tanh correction log(bound·(1 − tanh²) + 1e-6) is ill-conditioned
    # where tanh saturates: one float32 rounding of tanh (ε = 6e-8 relative)
    # moves it by about 2ε/(1 − tanh² + 1e-6/bound). Held to atol 1e-5 plus
    # four times that, summed over the action dims.
    t = np.tanh(mean.astype(np.float64) + np.exp(log_std) * np.asarray(
        jax.random.normal(key, mean.shape), np.float64))
    cond = (8 * 6e-8 / (1 - t ** 2 + 1e-6 / 2.0)).sum(axis=-1)
    err = np.abs(logp.numpy().astype(np.float64) - np.asarray(want_logp))
    assert (err <= ATOL + RTOL * np.abs(np.asarray(want_logp)) + cond).all(), err.max()
    well = cond < 1e-5  # unsaturated samples: the plain tolerance
    assert well.sum() > 30 and err[well].max() <= ATOL
    assert np.abs(a.numpy()).max() <= 2.0


# -- trainers: shared reference fixtures -------------------------------------------------
PENDULUM = dict(num_envs=4, steps_per_iter=16, batch_size=32, updates_per_step=2,
                memory_capacity=4096)
ALGOS = {
    "ddpg": (R.DDPGTrainer, R.ddpg_config, C.DDPGTrainer, C.ddpg_config),
    "td3": (R.TD3Trainer, R.td3_config, C.TD3Trainer, C.td3_config),
    "sac": (R.SACTrainer, R.sac_config, C.SACTrainer, C.sac_config),
    "sacd": (R.DiscreteSACTrainer, R.sac_discrete_config, C.DiscreteSACTrainer,
             C.sac_discrete_config),
}


@pytest.fixture(scope="module")
def refs():
    """One reference trainer per algorithm for the file: each train_iter
    compiles once. Made on first use."""
    cache = {}

    def get(algo):
        if algo not in cache:
            ref_cls, ref_cfg = ALGOS[algo][:2]
            cache[algo] = ref_cls(ref_cfg(**PENDULUM))
        return cache[algo]

    return get


def _port(algo, jts):
    cls, cfg = ALGOS[algo][2:]
    trainer = cls(cfg(**PENDULUM), device="cpu")
    ts = interop.train_state_from_reference(
        trainer, jax.device_get(jts), OffPolicyReplayNoise(jts.key, trainer.cfg.n_updates))
    return trainer, ts


def _named(ts):
    return {f"{k}.": v for k, v in ts.nets.items()}


def _grad_log(ts):
    return GradLog(_named(ts), {f"{k}.": opt for k, opt in ts.opts.items()})


def _net_state(ts, where="nets"):
    """Every online (or target) param of a port state, by flax-style path."""
    out = {}
    for k, v in getattr(ts, where).items():
        if isinstance(v, torch.nn.Module):
            out.update({f"{k}.{n}": p for n, p in v.state_dict().items()})
        else:
            out[f"{k}."] = v.detach()
    return out


def _ref_net_state(jts_nets):
    out = {}
    for k, v in jax.device_get(jts_nets).items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": p for n, p in _flax(v).items()})
        else:
            out[f"{k}."] = torch.tensor(np.asarray(v))
    return out


def _adam(ref_opt):
    return interop._scale_by_adam_state(jax.device_get(ref_opt))


def _assert_adam_counts(ts, jts, where):
    for k, opt in ts.opts.items():
        counts = {int(s["step"]) for s in opt.state.values()}
        assert counts == {int(np.asarray(_adam(jts.opts[k]).count))}, f"{k} Adam count {where}"


# -- one update ---------------------------------------------------------------------------
def _fixed_batch(algo, rng, n=32):
    obs_dim = 4 if algo == "sacd" else 3
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    action = (rng.integers(0, 2, n).astype(np.int32) if algo == "sacd"
              else rng.uniform(-2, 2, (n, 1)).astype(np.float32))
    reward = (-rng.uniform(0, 16, n)).astype(np.float32)
    next_obs = (obs + rng.normal(scale=0.1, size=obs.shape)).astype(np.float32)
    done = (rng.random(n) < 0.25).astype(np.float32)
    return obs, action, reward, next_obs, done


class _UpdateKey(OffPolicyReplayNoise):
    def __init__(self, k_u):
        super().__init__(None, 1)
        self.k_u = k_u


def _expected_calls(algo: str, sizes: list[int], cfg) -> list[str]:
    """The reference's order of draws for env steps whose replay holds
    ``sizes[t]`` transitions after its push: act, env step, env reset, then
    per update the replay sample and the update's own draws."""
    act = "gumbel" if algo == "sacd" else "action_noise"
    upd = {"td3": ["target_noise"], "sac": ["sac_update_noise"]}.get(algo, [])
    calls = []
    for size in sizes:
        calls += [act, "env_step", "env_reset"]
        if size >= cfg.batch_size:
            calls += (["replay_indices"] + upd) * cfg.n_updates
    return calls


@pytest.mark.parametrize("algo,learn_step", [("ddpg", 0), ("td3", 0), ("td3", 1), ("sac", 0),
                                             ("sacd", 0)],
                         ids=["ddpg", "td3_policy_step", "td3_off_step", "sac", "sacd"])
def test_update_matches_reference(refs, algo, learn_step, rng):
    """One ``_update`` from the reference's init with perturbed targets, on a
    fixed batch, with the reference's draws: the losses, the gradients (read
    from Adam's moments), params under the Adam-sign rule, targets and Adam
    counts. On TD3's off-step the actor, its Adam and the targets stay."""
    rt = refs(algo)
    jts = rt.init(jax.random.PRNGKey(0))
    targets = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(scale=0.05, size=p.shape), jnp.float32), jts.targets)
    jts = jts._replace(targets=targets)
    trainer, ts = _port(algo, jts)
    batch = _fixed_batch(algo, rng)
    k_u = jax.random.PRNGKey(7)
    ref_batch = R.Transition(*map(jnp.asarray, batch))
    nets, new_targets, opts, metrics = jax.device_get(jax.jit(rt._update)(
        jts.nets, jts.targets, jts.opts, ref_batch, jnp.asarray(learn_step), k_u))

    got = trainer._update(ts, C.Transition(*map(_t, batch)), learn_step, _UpdateKey(k_u))
    got = dict(zip(trainer.metric_names, got))
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL, atol=1e-6, err_msg=k)

    # gradients: after one step from zero moments, mu = 0.1·g and nu = 0.001·g²
    tiny = {}
    for k, opt in ts.opts.items():
        ref_adam = _adam(opts[k])
        net = ts.nets[k]
        if isinstance(net, torch.nn.Module):
            mu, nu = _flax(ref_adam.mu), _flax(ref_adam.nu)
            named = list(net.named_parameters())
        else:
            mu, nu = {"": _t(ref_adam.mu)}, {"": _t(ref_adam.nu)}
            named = [("", net)]
        for n, p in named:
            state = opt.state[p]
            for got_m, want_m in ((state["exp_avg"], mu[n]), (state["exp_avg_sq"], nu[n])):
                w = want_m.numpy()
                np.testing.assert_allclose(got_m.numpy(), w, rtol=RTOL,
                                           atol=1e-5 * np.abs(w).max(), err_msg=f"{k}.{n}")
            tiny[f"{k}.{n}"] = tiny_grad(mu[n] / 0.1).astype(np.int64)
    lr = max(trainer.cfg.lr_actor, trainer.cfg.lr_critic, trainer.cfg.lr_alpha)
    assert_params_close(_net_state(ts), _ref_net_state(nets), lr, tiny, "nets")
    assert_params_close(_net_state(ts, "targets"), _ref_net_state(new_targets), lr, None,
                        "targets")
    _assert_adam_counts(ts, R.OffPolicyTrainState(nets, new_targets, opts, *jts[3:]), "")
    if algo == "td3":
        want = {k: int(np.asarray(_adam(opts[k]).count)) for k in ("actor", "critic")}
        assert want == {"actor": 1 - learn_step, "critic": 1}


# -- the slice as a whole --------------------------------------------------------------------
# A free run carries Adam's amplification forward: an entry whose step
# float32 agreement does not fix (the Adam-sign and ReLU-tie rules) may end
# up to 2·lr apart, and that shifts every later action, forward pass and
# update. In the two iterations from the reference's init (each started
# from the reference's state), where Adam's steps are still sign-like, one
# iteration moved continuous actions by up to 2.6e-2 (SAC), 1.5e-2 (TD3)
# and 2.9e-3 (DDPG), and params by up to 2.8e-3; from a late start by at
# most 5.4e-5 (on the CPU; ``PYTHONPATH=. python tests/test_torch_continuous.py``
# prints them, see ``free_run_divergence``).
# So a free run is held to the reference by
# exact quantities (episode flags and lengths, discrete actions, the order
# of every draw, replay fill, learn steps, Adam counts) and its floats only
# to TRAJ_ATOL; every single act and update along it is held to 1e-5 from
# the same state and draws by ``Lockstep``.
TRAJ_ATOL = 5e-2
STEP_LOSS_ATOL = 1e-4


def _jax_nets(modules: dict) -> dict:
    """Port nets (modules, or a bare 0-dim parameter) → a reference nets tree."""
    return {k: interop.params_to_flax(v.state_dict()) if isinstance(v, torch.nn.Module)
            else jnp.asarray(v.detach().numpy().copy()) for k, v in modules.items()}


def _jax_opts(ts) -> dict:
    """Port Adams → the reference's ``optax.adam`` states."""
    import optax

    out = {}
    for k, net in ts.nets.items():
        opt = ts.opts[k]
        if isinstance(net, torch.nn.Module):
            named = list(net.named_parameters())
            mu, nu = ({n: opt.state[p][f] for n, p in named} for f in ("exp_avg", "exp_avg_sq"))
            mu, nu = interop.params_to_flax(mu), interop.params_to_flax(nu)
            count = opt.state[named[0][1]]["step"]
        else:
            mu, nu = (jnp.asarray(opt.state[net][f].numpy().copy())
                      for f in ("exp_avg", "exp_avg_sq"))
            count = opt.state[net]["step"]
        out[k] = (optax.ScaleByAdamState(count=jnp.asarray(int(count), jnp.int32), mu=mu, nu=nu),
                  optax.EmptyState())
    return out


class Lockstep:
    """Holds every act and every update of a port ``train_iter`` to the
    reference's same function from the same state and draws: the action
    (atol 1e-5, or exact for discrete SAC), and after each update the nets
    under the Adam-sign and ReLU-tie rules of that update, the targets
    (atol 1e-5) and the metrics (rtol 1e-5; the actor and α losses within
    STEP_LOSS_ATOL)."""

    def __init__(self, rt, trainer):
        self.rt, self.log, self.acts, self.updates = rt, None, 0, 0
        self.update_fn = jax.jit(rt._update)
        act, update = trainer._act, trainer._update
        lr = max(trainer.cfg.lr_actor, trainer.cfg.lr_critic, trainer.cfg.lr_alpha)

        def checked_act(nets, obs, noise, deterministic):
            a = act(nets, obs, noise, deterministic)
            if not deterministic:
                want = np.asarray(rt._act(_jax_nets(nets), jnp.asarray(obs.numpy()),
                                          noise.k_act, False))
                if a.dtype == torch.int32:
                    np.testing.assert_array_equal(a.numpy(), want, err_msg=f"act {self.acts}")
                else:
                    np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=ATOL,
                                               err_msg=f"act {self.acts}")
                self.acts += 1
            return a

        def checked_update(ts_, batch, learn_step, noise):
            ref_in = (_jax_nets(ts_.nets), _jax_nets(ts_.targets), _jax_opts(ts_))
            log = self.log
            counts0 = {k: np.array(v, copy=True) for k, v in log.counts.items()}
            metrics = update(ts_, batch, learn_step, noise)
            nets, targets, _, ref_metrics = jax.device_get(self.update_fn(
                *ref_in, R.Transition(*(jnp.asarray(x.numpy()) for x in batch)),
                jnp.asarray(learn_step), noise.k_u))
            where = f"update {self.updates} (learn step {learn_step})"
            this_step = {k: v - counts0.get(k, 0) for k, v in log.counts.items()}
            assert_params_close(_net_state(ts_), _ref_net_state(nets), lr, this_step, where)
            assert_params_close(_net_state(ts_, "targets"), _ref_net_state(targets), lr,
                                this_step, f"targets {where}")
            for name, m in zip(trainer.metric_names, metrics):
                # the actor loss reads the critic this update just stepped, whose
                # Adam-sign entries may sit up to 2·lr apart; SAC's α-loss reads
                # logπ, ill-conditioned where tanh saturates (test_squashed_sample)
                atol = STEP_LOSS_ATOL if name in ("actor_loss", "alpha_loss") else 1e-6
                np.testing.assert_allclose(float(m), float(ref_metrics[name]), rtol=RTOL,
                                           atol=atol, err_msg=f"{name} {where}")
            self.updates += 1
            return metrics

        trainer._act, trainer._update = checked_act, checked_update


def _assert_replay_close(st, ref_st, where, atol=REWARD_ATOL):
    assert (st.pos, st.size) == (int(ref_st.pos), int(ref_st.size)), where
    for f, got, want in zip(st.data._fields, st.data, ref_st.data):
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                                       err_msg=f"replay {f} {where}")
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"replay {f} {where}")


def _assert_state_close(trainer, ts, jts, log, where):
    jts = jax.device_get(jts)
    assert ts.env_steps == int(jts.env_steps) and ts.learn_steps == int(jts.learn_steps), where
    _assert_replay_close(ts.replay, jts.replay, where, TRAJ_ATOL)
    lr = max(trainer.cfg.lr_actor, trainer.cfg.lr_critic, trainer.cfg.lr_alpha)
    for nets in ("nets", "targets"):
        got, want = _net_state(ts, nets), _ref_net_state(getattr(jts, nets))
        assert set(got) == set(want), where
        for k in want:
            atol = np.maximum(TRAJ_ATOL, 2.0 * lr * np.asarray(log.counts.get(k, 0)))
            err = np.abs(got[k].numpy().astype(np.float64) - want[k].numpy())
            assert (err <= atol).all(), f"{nets} {k} {where}: worst {err.max():.3g}"
    _assert_adam_counts(ts, jts, where)
    np.testing.assert_allclose(ts.vec_state.obs.numpy(), jts.vec_state.obs, rtol=0,
                               atol=TRAJ_ATOL, err_msg=where)
    np.testing.assert_array_equal(ts.vec_state.ep_length.numpy(), jts.vec_state.ep_length)


def _assert_iter_out_close(out, jout, where):
    np.testing.assert_array_equal(out.ep_done.numpy(), np.asarray(jout.ep_done), err_msg=where)
    np.testing.assert_array_equal(out.ep_length.numpy(), np.asarray(jout.ep_length))
    length = np.maximum(np.asarray(jout.ep_length), 1)
    err = np.abs(out.ep_return.numpy().astype(np.float64) - np.asarray(jout.ep_return))
    assert (err <= TRAJ_ATOL * length).all(), f"episode returns {where}: {err.max()}"
    assert set(out.metrics) == set(jout.metrics)
    for k, v in jout.metrics.items():
        np.testing.assert_allclose(float(out.metrics[k]), float(v), rtol=TRAJ_ATOL,
                                   atol=TRAJ_ATOL, err_msg=f"{k} {where}")


# Reference iterations before a late start: 12 × 16 steps bring Pendulum to
# t=192, so the compared iteration truncates every episode at t=200 and
# autoresets; CartPole episodes have ended many times by then.
LATE_WARMUP = 12


@pytest.mark.parametrize("start", ["reset", "late"])
@pytest.mark.parametrize("algo", ["ddpg", "td3", "sac", "sacd"])
def test_train_iters_match_reference(refs, algo, start):
    """Whole iterations at width 256 with the reference's noise replayed.
    Along the port's trajectory every act and update is held to the
    reference's from the same state (``Lockstep``: atol 1e-5 and the Adam
    rules). Each iteration starts from the reference's state; the port asks
    for its draws in the reference's order, and the two free runs end with
    the same episode flags and lengths, discrete actions, replay fill,
    learn steps and Adam counts (TD3's actor on every second learn step
    only), and with transitions, params, targets and metrics within
    TRAJ_ATOL. ``reset``: two iterations from the reference's init.
    ``late``: one iteration after LATE_WARMUP reference iterations — a
    non-empty replay, non-zero Adam moments, truncations
    (Pendulum) or terminations (CartPole) and autoresets."""
    rt = refs(algo)
    jts = rt.init(jax.random.PRNGKey(0))
    if start == "late":
        for _ in range(LATE_WARMUP):
            jts, _ = rt.train_iter(jts)
    trainer, _ = _port(algo, jts)
    lockstep = Lockstep(rt, trainer)
    done = updates = 0
    iters = 2 if start == "reset" else 1
    for it in range(iters):
        noise = OffPolicyReplayNoise(jts.key, trainer.cfg.n_updates)
        ts = interop.train_state_from_reference(trainer, jax.device_get(jts), noise)
        learn_steps0, size0 = ts.learn_steps, ts.replay.size
        lockstep.log = log = _grad_log(ts)
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"{algo} {start} iteration {it}"
        sizes = [min(size0 + (t + 1) * trainer.cfg.num_envs, trainer.cfg.memory_capacity)
                 for t in range(trainer.cfg.steps_per_iter)]
        assert noise.calls == _expected_calls(algo, sizes, trainer.cfg), where
        _assert_iter_out_close(out, jout, where)
        _assert_state_close(trainer, ts, jts, log, where)
        done += int(np.asarray(jout.ep_done).sum())
        updates += ts.learn_steps - learn_steps0
    assert lockstep.acts == trainer.cfg.steps_per_iter * iters
    assert lockstep.updates == updates > 0
    if start == "late":
        assert done > 0, "episodes should end inside the compared iteration"
        if algo != "sacd":
            assert done == trainer.cfg.num_envs  # every Pendulum episode truncates at 200
    if algo == "td3":
        actor_count = int(ts.opts["actor"].state[ts.nets["actor"].fc1.weight]["step"])
        assert actor_count == (ts.learn_steps + 1) // 2


def test_train_state_interop_round_trips(refs):
    """The whole reference state carried across is the reference's, to the
    bit: nested params, the 0-dim log_alpha, targets, Adam moments and
    counts, replay contents and counters, the Pendulum batch."""
    rt = refs("sac")
    jts = rt.init(jax.random.PRNGKey(0))
    for _ in range(3):
        jts, _ = rt.train_iter(jts)
    jts = jax.device_get(jts)
    trainer, ts = _port("sac", jts)
    assert ts.nets["log_alpha"].shape == () and isinstance(ts.nets["log_alpha"],
                                                           torch.nn.Parameter)
    for where in ("nets", "targets"):
        got, want = _net_state(ts, where), _ref_net_state(getattr(jts, where))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    critic = ts.nets["critic"]
    back = interop.params_to_flax(critic.state_dict())["params"]
    np.testing.assert_array_equal(back["q2"]["fc1"]["kernel"],
                                  jts.nets["critic"]["params"]["q2"]["fc1"]["kernel"])
    for k, opt in ts.opts.items():
        ref_adam = _adam(jts.opts[k])
        net = ts.nets[k]
        if isinstance(net, torch.nn.Module):
            mu = _flax(ref_adam.mu)
            for n, p in net.named_parameters():
                np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), mu[n].numpy())
        else:
            np.testing.assert_array_equal(opt.state[net]["exp_avg_sq"].numpy(), ref_adam.nu)
    _assert_adam_counts(ts, jts, "interop")
    _assert_replay_close(ts.replay, jts.replay, "interop")
    for f, x in zip(ts.replay.data._fields, ts.replay.data):
        np.testing.assert_array_equal(x.numpy(), getattr(jts.replay.data, f))
    back = interop.vec_state_to_numpy(ts.vec_state)
    for f in PendulumState._fields:
        np.testing.assert_array_equal(back["env_state"][f], getattr(jts.vec_state.env_state, f))
    assert (ts.env_steps, ts.learn_steps) == (int(jts.env_steps), int(jts.learn_steps))


# -- plumbing -------------------------------------------------------------------------------
_TINY = dict(num_envs=4, hidden_dim=32, steps_per_iter=8, batch_size=16, updates_per_step=1,
             memory_capacity=256)


@pytest.mark.parametrize("name", ["sac_pendulum", "sac_cartpole", "td3_pendulum",
                                  "ddpg_pendulum"])
def test_cli_workload_trains_in_train_loop_on_cpu(name, tmp_path, monkeypatch, capsys):
    """The workload's trainer, config and solve bar are the reference CLI's;
    a tiny config of the same trainer trains two iterations in TrainLoop
    with eval and a final checkpoint."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([]) == 1
    assert name in capsys.readouterr().out
    trainer, algo, solve = cli.WORKLOADS[name]("cpu")
    ref_trainer, ref_algo, ref_solve = ref_cli.WORKLOADS[name]()
    assert (algo, solve) == (ref_algo, ref_solve)
    assert type(trainer).__name__ == type(ref_trainer).__name__
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(ref_trainer.cfg)
    assert trainer.device == torch.device("cpu")

    small = type(trainer)(dataclasses.replace(trainer.cfg, **_TINY), device="cpu")
    loop = TrainLoop(small, algo, log_metrics=False, log_every=1, eval_every=10 ** 9,
                     save_every=10 ** 9, eval_episodes=1)
    ts, stats = loop.train(64, solve_threshold=solve)
    assert stats["env_steps"] == ts.env_steps == 64 and ts.learn_steps == 16 - 3
    assert len(stats["curve"]) == 2 and not stats["solved"]
    assert (tmp_path / "checkpoints" / f"{algo}_{small.venv.env.name}.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


def test_sac_checkpoint_round_trip_and_mismatch_raises(tmp_path):
    cfg = C.sac_config(**_TINY)
    trainer = C.SACTrainer(cfg, device="cpu")
    ts, _ = trainer.train_iter(trainer.init(0))
    ts, _ = trainer.train_iter(ts)
    path = save_checkpoint(str(tmp_path / "sac.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    # the replay is not saved (the reference's _strip_replay): it comes back fresh
    fresh = trainer.init(1).replay
    assert torch.load(path, weights_only=True)["replay"] is None and ts.replay.size == 64
    assert (restored.replay.size, restored.learn_steps, restored.env_steps) == \
        (fresh.size, ts.learn_steps, ts.env_steps) == (0, 13, 64)
    for a, b in zip(restored.replay.data, fresh.data):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # log_alpha is loaded in place: its optimizer still steps the same tensor
    la = restored.nets["log_alpha"]
    assert la is next(iter(restored.opts["log_alpha"].state)) and float(la.detach()) == float(
        ts.nets["log_alpha"].detach())
    # every other field came back: the next iteration from the same fresh replay is the same
    ts, out = trainer.train_iter(ts._replace(replay=fresh))
    restored, out_r = trainer.train_iter(restored)
    for where in ("nets", "targets"):
        got, want = _net_state(restored, where), _net_state(ts, where)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for k in out.metrics:
        torch.testing.assert_close(out_r.metrics[k], out.metrics[k], rtol=0, atol=0)

    with pytest.raises(ValueError, match="actor.fc1.weight"):
        restore_checkpoint(path, C.SACTrainer(dataclasses.replace(cfg, hidden_dim=16),
                                              device="cpu").init(0))
    with pytest.raises(ValueError, match="log_alpha"):
        restore_checkpoint(path, C.DDPGTrainer(C.ddpg_config(**_TINY), device="cpu").init(0))


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_default_device_without_cuda_raises(algo):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cls, cfg = ALGOS[algo][2:]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(cfg(num_envs=2))


def free_run_divergence(algo: str, start: str) -> list[dict]:
    """Largest free-run differences from the reference, per iteration of
    ``test_train_iters_match_reference``'s schedule: the numbers behind
    TRAJ_ATOL. ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_continuous.py``
    prints them."""
    rt = ALGOS[algo][0](ALGOS[algo][1](**PENDULUM))
    jts = rt.init(jax.random.PRNGKey(0))
    for _ in range(LATE_WARMUP if start == "late" else 0):
        jts, _ = rt.train_iter(jts)
    trainer, _ = _port(algo, jts)
    rows = []
    for it in range(2 if start == "reset" else 1):
        ts = interop.train_state_from_reference(
            trainer, jax.device_get(jts), OffPolicyReplayNoise(jts.key, trainer.cfg.n_updates))
        jts, _ = rt.train_iter(jts)
        ts, _ = trainer.train_iter(ts)
        ref = jax.device_get(jts)
        got, want = _net_state(ts), _ref_net_state(ref.nets)
        rows.append({
            "algo": algo, "start": start, "iteration": it,
            "action": float(np.abs(ts.replay.data.action.numpy().astype(np.float64)
                                   - ref.replay.data.action).max()),
            "obs": float(np.abs(ts.replay.data.obs.numpy() - ref.replay.data.obs).max()),
            "params": max(float(np.abs(got[k].numpy() - want[k].numpy()).max()) for k in want),
        })
    return rows


if __name__ == "__main__":
    for algo in ("ddpg", "td3", "sac", "sacd"):
        for start in ("reset", "late"):
            for row in free_run_divergence(algo, start):
                print(row)
