"""The port's CartPole, schedules, uniform replay, DQN and PPO on CartPole
against the JAX reference.

Both packages run on the CPU. Weights, Adam states and replay contents start
from the reference's own and are carried across with ``interop``; the
port's noise source replays the reference's ``jax.random`` key splits
(``DQNReplayNoise``), so both trainers draw the same numbers.

Tolerances, each with its reason:
  * CartPole state and observations: atol 1e-6. They are O(1) float32 and
    the two frameworks round ``sin``/``cos`` and fused ``a*b + c``
    differently (XLA on the CPU contracts it into one rounding).
  * schedules: rtol 1e-6, a few float32 steps (``exp`` may differ by one).
  * Q-values, losses, params: atol 1e-5 / rtol 1e-5; grads: rtol 1e-5 plus
    an atol of 1e-5 of each tensor's largest entry (a sum of terms that
    cancel keeps the rounding of the terms, not its own size).
  * params after Adam (eps 1e-8), the Adam-sign rule: the first Adam step
    moves an entry by about ``lr·g/(|g| + 1e-8)``, so an entry whose true
    gradient sits at rounding level moves +lr on one side and −lr on the
    other although both are right; and where |g| is within ~100 of eps the
    step ``lr·|g|/(|g| + eps)`` still turns the gradient's own rounding into
    up to ~1e-4. Entries whose gradient was below 1e-6·max|g| of its tensor,
    or below 1e-6 (100·eps), are held to 2·lr per such update; all others to
    atol 1e-5. Over whole iterations the same holds for a ReLU tie: a
    hidden unit whose pre-activation for a sampled transition sits within
    1e-5 of zero (the params' own tolerance) passes that sample's gradient
    on one side only; its row and column are held to 2·lr per such update
    (``GradLog``).
  * integer and boolean data (actions, flags, counters, replay pos/size):
    exact. Rewards of CartPole are exactly 1.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.algos.dqn import DQNConfig as RefConfig
from gymrl_tpu.algos.dqn import DQNTrainer as RefTrainer
from gymrl_tpu.algos.dqn import Transition as RefTransition
from gymrl_tpu.algos.ppo import PPOConfig as RefPPOConfig
from gymrl_tpu.algos.ppo import PPOTrainer as RefPPOTrainer
from gymrl_tpu.core import schedules as ref_schedules
from gymrl_tpu.envs.cartpole import CartPole as RefCartPole
from gymrl_tpu.envs.rollout import VecEnv as RefVecEnv
from gymrl_tpu.replay import uniform as ref_replay
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos.base import clip_grads_by_value_, hard_update, soft_update
from gymrl_tpu_torch.algos.dqn import DQNConfig, DQNTrainer, Transition
from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
from gymrl_tpu_torch.core import schedules
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs.cartpole import CartPole, CartPoleState
from gymrl_tpu_torch.envs.lunarlander import LunarLander
from gymrl_tpu_torch.envs.pendulum import Pendulum, PendulumResetDraws
from gymrl_tpu_torch.envs.registry import make, make_vec
from gymrl_tpu_torch.replay import uniform as replay
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_lunarlander import JaxReplayNoise, jax_reset_draws, jax_step_draws

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
ENV_ATOL = 1e-6
# The Adam-sign rule: a gradient below TINY_GRAD·max|g| of its tensor, or
# below TINY_GRAD_ABS = 100·eps, does not fix Adam's first update to 1e-5.
TINY_GRAD = 1e-6
TINY_GRAD_ABS = 1e-6
RELU_TIE = 1e-5  # a pre-activation this close to 0 may switch sides: the ReLU-tie rule


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- replaying the reference's draws ------------------------------------------
@jax.jit
def _cartpole_reset_u(keys):
    return jax.vmap(lambda k: jax.random.uniform(k, (4,), jnp.float32, -0.05, 0.05))(keys)


@jax.jit
def _pendulum_reset_u(keys):
    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
                jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0))
    return jax.vmap(one)(keys)


def env_reset_draws(env, key, num: int):
    """The draws the reference engine of ``env``'s kind makes in
    ``reset_batch(params, key, num)``, as the port env takes them."""
    keys = jax.random.split(key, num)
    if isinstance(env, CartPole):
        return _t(_cartpole_reset_u(keys))
    if isinstance(env, Pendulum):
        return PendulumResetDraws(*map(_t, _pendulum_reset_u(keys)))
    assert isinstance(env, LunarLander)
    return jax_reset_draws(key, num)


def env_step_draws(env, key, num: int):
    """CartPole and Pendulum draw nothing in a step; the lander its dispersion."""
    return jax_step_draws(key, num) if isinstance(env, LunarLander) else None


class EnvReplay:
    """The env part of a replaying noise: ``VecEnv.step`` splits its key
    into (step, reset) and the reset draws come from the reset key."""

    k_step = None
    k_reset = None

    def env_step(self, env, num):
        k_env_step, self.k_reset = jax.random.split(self.k_step)
        return env_step_draws(env, k_env_step, num)

    def env_reset(self, env, num):
        return env_reset_draws(env, self.k_reset, num)


class DQNReplayNoise(EnvReplay):
    """Replays ``DQNTrainer``'s key tree: per env step ``split(key, 5)`` into
    (key, ε, random action, env step, updates), then ``split(k_upd,
    n_updates)`` with one replay ``randint`` per update."""

    def __init__(self, key, n_updates: int):
        self.key = key
        self.n_updates = n_updates
        self.upd_keys = iter(())

    def explore(self, num, n_actions):
        self.key, k_eps, k_rand, self.k_step, k_upd = jax.random.split(self.key, 5)
        self.upd_keys = iter(jax.random.split(k_upd, self.n_updates))
        return (_t(jax.random.uniform(k_eps, (num,))),
                _t(jax.random.randint(k_rand, (num,), 0, n_actions)))

    def replay_indices(self, batch_size, high):
        return _t(jax.random.randint(next(self.upd_keys), (batch_size,), 0, high)).long()


class CartPolePPOReplay(JaxReplayNoise):
    """PR 1's PPO replay with the env draws of any engine."""

    env_step = EnvReplay.env_step
    env_reset = EnvReplay.env_reset


# -- comparisons -----------------------------------------------------------------
def assert_state_close(state, ref, atol=ENV_ATOL, where="", rows=slice(None)):
    ref = jax.device_get(ref)
    for f in ref._fields:
        got = getattr(state, f).numpy()[rows]
        want = np.asarray(getattr(ref, f)).reshape(getattr(state, f).shape)[rows]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{f} {where}")


def tiny_grad(g: torch.Tensor) -> np.ndarray:
    """The entries of one gradient tensor that the Adam-sign rule exempts."""
    a = g.abs()
    return (a < torch.clamp(TINY_GRAD * a.max(), min=TINY_GRAD_ABS)).numpy()


def tiny_grad_mask(grads: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: tiny_grad(g) for k, g in grads.items()}


def assert_params_close(got: dict, want: dict, lr: float, tiny_counts=None, where=""):
    """atol 1e-5, except the entries that ``tiny_counts[k]`` counts: the
    updates in which float32 agreement did not fix the entry's step (the
    Adam-sign and ReLU-tie rules); such an entry is held to 2·lr per
    counted update."""
    assert set(got) == set(want), where
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        atol = np.full(w.shape, ATOL)
        if tiny_counts is not None and k in tiny_counts:
            atol = np.maximum(atol, 2.0 * lr * tiny_counts[k])
        err = np.abs(g - w)
        bad = err > atol
        assert not bad.any(), (f"{k} {where}: {int(bad.sum())} entries off, worst "
                               f"{err.max():.3g} (tiny-grad entries: "
                               f"{int((atol > ATOL).sum())})")


class GradLog:
    """Counts, per parameter entry, the optimizer steps whose update is not
    fixed by float32 agreement, for ``assert_params_close``:

      * the Adam-sign rule: the entry's gradient was below TINY_GRAD of its
        tensor's largest, or below TINY_GRAD_ABS;
      * the ReLU-tie rule: in the loss forward of that step, a hidden unit's
        pre-activation for some sample lay within RELU_TIE of zero. One
        framework then passes that sample's gradient through the unit and
        the other does not, so the unit's row (weights and bias) and the
        next layers' column of it get a gradient that differs by one
        sample's term, and Adam turns that into up to ~lr.

    It wraps each optimizer's ``step``; ``named`` maps a prefix to the
    module or parameter the optimizer of that prefix steps."""

    def __init__(self, named: dict, opts: dict):
        self.counts: dict[str, np.ndarray] = {}
        self.ties = 0
        for prefix, opt in opts.items():
            target = named[prefix]
            if isinstance(target, torch.nn.Module):
                params = list(target.named_parameters())
                pending = self._watch_relus(target)
            else:
                params, pending = [("", target)], []
            self._wrap(opt, prefix, [(f"{prefix}{n}", p) for n, p in params], target, pending)

    @staticmethod
    def _watch_relus(module):
        """Record the outputs of every Linear layer that feeds a ReLU (one
        with a later sibling reading its width), in grad-enabled forwards."""
        pending = []
        for parent_name, parent in module.named_modules():
            layers = [(n, m) for n, m in parent.named_children() if isinstance(m, torch.nn.Linear)]
            for i, (name, layer) in enumerate(layers):
                consumers = [f"{parent_name}.{n}".lstrip(".") for n, m in layers[i + 1:]
                             if m.in_features == layer.out_features]
                if not consumers:
                    continue
                full = f"{parent_name}.{name}".lstrip(".")

                def hook(mod, args, out, full=full, consumers=consumers):
                    if torch.is_grad_enabled() and mod.weight.requires_grad:
                        pending.append((full, consumers, out.detach().reshape(-1, out.shape[-1])))

                layer.register_forward_hook(hook)
        return pending

    def _add(self, name, mask):
        self.counts[name] = self.counts.get(name, 0) + mask.astype(np.int64)

    def _wrap(self, opt, prefix, named_params, target, pending):
        step = opt.step
        shapes = {n: p.shape for n, p in named_params}

        def logged(*args, **kw):
            for name, p in named_params:
                self._add(name, tiny_grad(p.grad))
            for layer, consumers, out in pending:
                units = (out.abs() < RELU_TIE).any(dim=0).numpy()
                if not units.any():
                    continue
                self.ties += 1
                w = f"{prefix}{layer}.weight"
                self._add(w, np.broadcast_to(units[:, None], shapes[w]))
                self._add(f"{prefix}{layer}.bias", units)
                for c in consumers:
                    cw = f"{prefix}{c}.weight"
                    self._add(cw, np.broadcast_to(units[None, :], shapes[cw]))
            pending.clear()
            return step(*args, **kw)

        opt.step = logged


# -- CartPole ---------------------------------------------------------------------
_REF_CP = RefCartPole()


@pytest.mark.parametrize("seed", [0, 3])
def test_cartpole_reset_and_step_match_reference(seed):
    """B=16 envs from the reference's reset draws, stepped with random
    actions. Each env is compared up to the step that terminates it: past
    it the pole swings on without a reset and its speed grows to where
    1e-6 is one float32 step."""
    params = CartPole().default_params()
    ref_params = _REF_CP.default_params()
    env = CartPole()
    key = jax.random.PRNGKey(seed)
    ref_state, ref_obs = jax.jit(_REF_CP.reset_batch, static_argnums=2)(ref_params, key, 16)
    state, obs = env.reset_from(params, env_reset_draws(env, key, 16))
    assert_state_close(state, ref_state, where="reset")
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=0, atol=ENV_ATOL)

    step = jax.jit(_REF_CP.step_batch)
    actions = np.random.default_rng(seed).integers(0, 2, (40, 16)).astype(np.int32)
    ever_terminated = np.zeros(16, bool)
    for i, a in enumerate(actions):
        ref_sr = step(ref_params, ref_state, jnp.asarray(a), jax.random.PRNGKey(i))
        sr = env.step_from(params, state, torch.from_numpy(a), None)
        live = ~ever_terminated
        assert_state_close(sr.state, ref_sr.state, where=f"step {i}", rows=live)
        np.testing.assert_allclose(sr.obs.numpy()[live], np.asarray(ref_sr.obs)[live], rtol=0,
                                   atol=ENV_ATOL)
        np.testing.assert_array_equal(sr.reward.numpy(), np.asarray(ref_sr.reward))
        for f in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(sr, f).numpy()[live],
                                          np.asarray(getattr(ref_sr, f))[live])
        ever_terminated |= sr.terminated.numpy()
        ref_state, state = ref_sr.state, sr.state
    assert ever_terminated.sum() >= 4, "random actions should drop several poles"
    assert float(sr.reward.min()) == 1.0


def test_cartpole_truncates_at_500():
    env = CartPole()
    state = CartPoleState(*(torch.zeros(2) for _ in range(4)),
                          torch.tensor([499, 498], dtype=torch.int32))
    sr = env.step_from(env.default_params(), state, torch.tensor([0, 1]), None)
    assert sr.truncated.tolist() == [True, False] and not sr.terminated.any()


def test_vecenv_autoreset_cartpole_matches_reference():
    """Mirrors tests/test_envs_classic.py:153 (random policy, 300 steps, B=8)
    on both packages with the same keys and actions: transitions, finished
    episodes and the carried (post-reset) observations agree."""
    num, steps = 8, 300
    ref_venv = RefVecEnv(_REF_CP, _REF_CP.default_params(), num)

    @jax.jit
    def roll(vstate, keys):
        def body(vs, k):
            a = jax.random.randint(k, (num,), 0, 2)
            vs, tr = ref_venv.step(vs, a, k)
            return vs, tr
        return jax.lax.scan(body, vstate, keys)

    vs0 = ref_venv.reset(jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.PRNGKey(1), steps)
    ref_vs, ref_trs = jax.device_get(roll(vs0, keys))

    venv = make_vec("CartPole-v1", num)
    vs = interop.vec_state_from_numpy(jax.device_get(vs0), state_cls=CartPoleState)
    noise = EnvReplay()
    trs = []
    for k in keys:
        noise.k_step = k
        a = _t(jax.random.randint(k, (num,), 0, 2))
        vs, tr = venv.step(vs, a, noise)
        trs.append(tr)
    # Along an episode of up to ~100 steps the pole's dynamics amplify the
    # frameworks' one-step rounding differences (1e-6) to a few 1e-6.
    for f in ("obs", "next_obs"):
        np.testing.assert_allclose(torch.stack([getattr(t, f) for t in trs]).numpy(),
                                   getattr(ref_trs, f), rtol=0, atol=ATOL, err_msg=f)
    for f in ("action", "reward", "terminated", "truncated", "done", "final_return",
              "final_length"):
        np.testing.assert_array_equal(torch.stack([getattr(t, f) for t in trs]).numpy(),
                                      getattr(ref_trs, f), err_msg=f)
    done = np.asarray(ref_trs.done)
    assert done.any(), "random CartPole episodes must end within 300 steps"
    finals = np.asarray(ref_trs.final_return)[done]
    assert np.all(finals == np.asarray(ref_trs.final_length)[done])  # reward == steps survived
    np.testing.assert_allclose(vs.obs.numpy(), ref_vs.obs, rtol=0, atol=ATOL)
    t, b = np.argwhere(done)[0]
    assert np.all(np.abs(trs[t + 1].obs[b].numpy()) <= 0.05 + 1e-6)  # a fresh reset


def test_registry_makes_cartpole_and_pendulum():
    cp, pd = make("CartPole-v1"), make("Pendulum-v1")
    assert (cp.n_actions, cp.obs_dim, cp.max_steps) == (2, 4, 500)
    assert (pd.act_dim, pd.action_bound, pd.obs_dim, pd.max_steps) == (1, 2.0, 3, 200)
    with pytest.raises(KeyError, match="CartPole-v1"):
        make("Acrobot-v1")


# -- schedules ----------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("exp_epsilon_decay", (0.95, 0.01, 800.0)),
    ("linear_anneal", (1000, 3e-4)),
    ("linear_anneal", (1000, 1.0, 0.1)),
    ("ref_lr_decay", (1000, 1e-3)),
    ("per_beta_anneal", (1000,)),
    ("per_beta_anneal", (1000, 0.5)),
])
def test_schedules_match_reference(name, args):
    """Float32 values at the reference's own points (tests/test_core.py:166)
    and across the schedule, past its end included."""
    for step in (0, 1, 16, 50, 100, 333, 800, 999, 1000, 1600, 2500, 123_456):
        got = getattr(schedules, name)(step, *args)
        want = getattr(ref_schedules, name)(step, *args)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0,
                                   err_msg=f"{name}{args} at {step}")
    # a tensor step stays on its device and gives the same value
    torch.testing.assert_close(getattr(schedules, name)(torch.tensor(50), *args),
                               getattr(schedules, name)(50, *args), rtol=0, atol=0)


def test_schedule_formulas():
    np.testing.assert_allclose(float(schedules.exp_epsilon_decay(800, 0.95, 0.01, 800.0)),
                               0.01 + 0.94 * np.exp(-1.0), rtol=1e-6)
    assert float(schedules.linear_anneal(200, 100, 3e-4)) == 0.0
    np.testing.assert_allclose(float(schedules.linear_anneal(50, 100, 1.0, final_frac=0.1)), 0.55,
                               rtol=1e-6)
    np.testing.assert_allclose(float(schedules.ref_lr_decay(100, 100, 1e-3)), 1e-4, rtol=1e-6)
    assert float(schedules.per_beta_anneal(10 ** 6, 100)) == 1.0


# -- replay (mirrors tests/test_replay.py) ----------------------------------------------
def _example(obs_dim=3):
    return Transition(obs=torch.zeros(obs_dim), action=torch.zeros((), dtype=torch.int32),
                      reward=torch.zeros(()), next_obs=torch.zeros(obs_dim), done=torch.zeros(()))


def _batch(lo, hi, jax_side=False):
    x = np.arange(lo, hi, dtype=np.float32)[:, None].repeat(3, 1)
    a = np.arange(lo, hi, dtype=np.int32)
    f = np.arange(lo, hi, dtype=np.float32)
    leaves = (x, a, f, x + 0.5, f % 2)
    if jax_side:
        return RefTransition(*map(jnp.asarray, leaves))
    return Transition(*map(torch.from_numpy, leaves))


def _ref_example(obs_dim=3):
    return RefTransition(jnp.zeros(obs_dim), jnp.zeros((), jnp.int32), jnp.zeros(()),
                         jnp.zeros(obs_dim), jnp.zeros(()))


def _assert_replay_equal(st, ref_st):
    ref_st = jax.device_get(ref_st)
    assert (st.pos, st.size) == (int(ref_st.pos), int(ref_st.size))
    for got, want in zip(st.data, ref_st.data):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype


def test_replay_push_and_wraparound_match_reference():
    st = replay.replay_init(_example(), capacity=10)
    ref_st = ref_replay.replay_init(_ref_example(), capacity=10)
    for lo, hi in ((0, 4), (4, 8), (8, 14), (14, 17)):  # the third push wraps
        st = replay.replay_push_batch(st, _batch(lo, hi))
        ref_st = ref_replay.replay_push_batch(ref_st, _batch(lo, hi, jax_side=True))
        _assert_replay_equal(st, ref_st)
        assert isinstance(st.pos, int) and isinstance(st.size, int)
    np.testing.assert_array_equal(st.data.action.numpy(), [10, 11, 12, 13, 14, 15, 16, 7, 8, 9])


class _KeyReplay:
    """Replays a single reference key for one sampling call."""

    def __init__(self, key):
        self.key = key

    def replay_indices(self, batch_size, high):
        return _t(jax.random.randint(self.key, (batch_size,), 0, high)).long()

    def gumbel(self, shape):
        return _t(jax.random.gumbel(self.key, tuple(shape)))


@pytest.mark.parametrize("filled", [0, 20, 100], ids=["empty", "partial", "full"])
def test_replay_sample_matches_reference(filled):
    st = replay.replay_init(_example(), capacity=100)
    ref_st = ref_replay.replay_init(_ref_example(), capacity=100)
    if filled:
        st = replay.replay_push_batch(st, _batch(0, filled))
        ref_st = ref_replay.replay_push_batch(ref_st, _batch(0, filled, jax_side=True))
    key = jax.random.PRNGKey(filled)
    got = replay.replay_sample(st, _KeyReplay(key), 512)
    want = jax.device_get(ref_replay.replay_sample(ref_st, key, 512))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got.obs.shape == (512, 3)
    assert int(got.action.max()) < max(filled, 1)


def test_replay_sample_no_replacement_matches_reference():
    st = replay.replay_push_batch(replay.replay_init(_example(), capacity=64), _batch(0, 40))
    ref_st = ref_replay.replay_push_batch(ref_replay.replay_init(_ref_example(), capacity=64),
                                          _batch(0, 40, jax_side=True))
    key = jax.random.PRNGKey(1)
    got = replay.replay_sample_no_replacement(st, _KeyReplay(key), 32)
    want = jax.device_get(ref_replay.replay_sample_no_replacement(ref_st, key, 32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    a = got.action.numpy()
    assert len(np.unique(a)) == 32 and a.max() < 40


def test_replay_with_noise_samples_valid_slots_only():
    st = replay.replay_push_batch(replay.replay_init(_example(), capacity=100), _batch(0, 20))
    noise = Noise("cpu", 0)
    a = replay.replay_sample(st, noise, 512).action.numpy()
    assert a.min() >= 0 and a.max() < 20 and len(np.unique(a)) == 20
    b = replay.replay_sample_no_replacement(st, noise, 20).action.numpy()
    assert sorted(b.tolist()) == list(range(20))


# -- target updates and clipping (algos/base.py) -------------------------------------
def test_target_updates_and_value_clip_match_reference(rng):
    from gymrl_tpu.algos import base as ref_base

    t = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=4).astype(np.float32)]
    o = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=4).astype(np.float32)]
    got = [torch.from_numpy(x.copy()) for x in t]
    soft_update(got, [torch.from_numpy(x) for x in o], 0.005)
    want = ref_base.soft_update([jnp.asarray(x) for x in t], [jnp.asarray(x) for x in o], 0.005)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)
    hard_update(got, [torch.from_numpy(x) for x in o])
    for g, x in zip(got, o):
        np.testing.assert_array_equal(g.numpy(), x)
    grads = [torch.from_numpy(x * 3) for x in o]
    clip_grads_by_value_(grads, 1.0)
    for g, w in zip(grads, ref_base.clip_grads_by_value([jnp.asarray(x * 3) for x in o], 1.0)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- DQN -------------------------------------------------------------------------------
SLICE = dict(num_envs=4, steps_per_iter=16, batch_size=32, updates_per_step=2,
             memory_capacity=4096)


@pytest.fixture(scope="module")
def ref():
    """One reference trainer for the file: its train_iter compiles once."""
    return RefTrainer(RefConfig(**SLICE))


@pytest.fixture(scope="module")
def ref_ts0(ref):
    return ref.init(jax.random.PRNGKey(0))


def _port(ref_ts, **overrides):
    trainer = DQNTrainer(DQNConfig(**{**SLICE, **overrides}), device="cpu")
    ts = interop.train_state_from_reference(
        trainer, jax.device_get(ref_ts),
        DQNReplayNoise(ref_ts.key, trainer.cfg.n_updates))
    return trainer, ts


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


def test_qnetwork_matches_flax(ref, ref_ts0, rng):
    trainer, ts = _port(ref_ts0)
    assert [n for n, _ in ts.params.named_children()] == ["fc1", "fc2", "head"]
    obs = (rng.normal(size=(64, 4)) * 2).astype(np.float32)
    want = np.asarray(ref.net.apply(ref_ts0.params, jnp.asarray(obs)))
    with torch.no_grad():
        got = ts.params(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert not any(p.requires_grad for p in ts.target_params.parameters())


def _filled_replays(rng, n=200):
    """The same n transitions in a reference and a port replay."""
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    leaves = (obs, rng.integers(0, 2, n).astype(np.int32), np.ones(n, np.float32),
              (obs + rng.normal(scale=0.1, size=(n, 4))).astype(np.float32),
              (rng.random(n) < 0.2).astype(np.float32))
    ref_st = ref_replay.replay_push_batch(
        ref_replay.replay_init(_ref_example(4), 256), RefTransition(*map(jnp.asarray, leaves)))
    st = replay.replay_push_batch(replay.replay_init(_example(4), 256),
                                  Transition(*map(torch.from_numpy, leaves)))
    return ref_st, st


def test_dqn_update_matches_reference(ref, ref_ts0, rng):
    """One ``_update`` from the reference's init, with a target net that
    differs from the online one: the sampled batch, loss, gradients, and
    params after clip ±1 + Adam(eps=1e-8) under the Adam-sign rule."""
    trainer, ts = _port(ref_ts0)
    rt = ref
    target = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(scale=0.05, size=p.shape), jnp.float32),
        ref_ts0.params)
    ts.target_params.load_state_dict(_flax(target))
    ref_st, st = _filled_replays(rng)
    key = jax.random.PRNGKey(9)

    batch = ref_replay.replay_sample(ref_st, key, trainer.cfg.batch_size)
    want_loss, want_grads = jax.value_and_grad(rt._loss)(ref_ts0.params, target, batch)
    want_params, want_opt, want_loss2 = jax.jit(rt._update)(
        ref_ts0.params, target, ref_ts0.opt_state, ref_st, key)

    net = ts.params
    params = list(net.parameters())
    loss = trainer._loss(net, ts.target_params, Transition(*map(_t, jax.device_get(batch))))
    grads = dict(zip((n for n, _ in net.named_parameters()), torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    want_g = _flax(want_grads)
    for k, g in grads.items():
        w = want_g[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)

    got_loss = trainer._update(net, ts.target_params, ts.opt_state, params, st,
                               _KeyReplay(key))
    np.testing.assert_allclose(float(got_loss), float(want_loss2), rtol=RTOL)
    clipped = {k: g.clamp(-1, 1) for k, g in want_g.items()}
    assert_params_close(net.state_dict(), _flax(want_params), trainer.cfg.lr,
                        tiny_grad_mask(clipped), "after one update")
    steps = {int(s["step"]) for s in ts.opt_state.state.values()}
    assert steps == {1}


def _assert_dqn_state_close(ts, jts, lr, grad_log, where):
    jts = jax.device_get(jts)
    assert ts.env_steps == int(jts.env_steps), where
    assert int(ts.episodes) == int(jts.episodes), where
    assert int(ts.target_syncs) == int(jts.target_syncs), where
    _assert_replay_close(ts.replay, jts.replay, where)
    assert_params_close(ts.params.state_dict(), _flax(jts.params), lr, grad_log.counts, where)
    assert_params_close(ts.target_params.state_dict(), _flax(jts.target_params), lr,
                        grad_log.counts, f"target {where}")
    np.testing.assert_allclose(ts.vec_state.obs.numpy(), jts.vec_state.obs, rtol=0,
                               atol=ENV_ATOL, err_msg=where)
    np.testing.assert_array_equal(ts.vec_state.ep_length.numpy(), jts.vec_state.ep_length)
    count = int(np.asarray(jts.opt_state[0].count))
    assert {int(s["step"]) for s in ts.opt_state.state.values()} == {count}, where


def _assert_replay_close(st, ref_st, where):
    assert (st.pos, st.size) == (int(ref_st.pos), int(ref_st.size)), where
    for f, got, want in zip(st.data._fields, st.data, ref_st.data):
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENV_ATOL,
                                       err_msg=f"replay {f} {where}")
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"replay {f} {where}")


def _assert_iter_out_equal(out, jout, where):
    for f in ("ep_done", "ep_length", "ep_return"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                      err_msg=f"{f} {where}")
    assert set(out.metrics) == set(jout.metrics)
    for k, v in jout.metrics.items():
        np.testing.assert_allclose(float(out.metrics[k]), float(v), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{k} {where}")


@pytest.mark.parametrize("start", ["reset", "late"])
def test_two_train_iters_match_reference(ref, ref_ts0, start):
    """DQN on CartPole at width 256 with the reference's noise replayed:
    the same actions and transitions (the replay contents), episode stats,
    metrics, params, target syncs and Adam counts. ``late`` carries the
    whole state across after four reference iterations: episodes have
    ended, the target has synced, the replay is partly full and Adam's
    moments are non-zero."""
    jts = ref_ts0
    if start == "late":
        for _ in range(4):
            jts, _ = ref.train_iter(jts)
        assert int(jts.target_syncs) >= 1 and int(jts.replay.size) == 256
    trainer, ts = _port(jts)
    log = GradLog({"": ts.params}, {"": ts.opt_state})
    episodes = 0
    for it in range(2 if start == "reset" else 1):
        jts, jout = ref.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"{start} iteration {it}"
        _assert_iter_out_equal(out, jout, where)
        _assert_dqn_state_close(ts, jts, trainer.cfg.lr, log, where)
        episodes += int(np.asarray(jout.ep_done).sum())
    assert int(ts.opt_state.state[ts.params.fc1.weight]["step"]) > 0
    if start == "late":
        assert episodes > 0, "episodes should end inside the compared iteration"


# -- PPO on CartPole ----------------------------------------------------------------------
PPO_SLICE = dict(env_name="CartPole-v1", num_envs=8, rollout_steps=16, minibatch_size=32,
                 num_epochs=2, solve_threshold=495.0)


def test_ppo_cartpole_train_iter_matches_reference():
    """One PPO iteration on CartPole from the reference's init with its noise
    replayed (PR 1's replay, CartPole's draws): the same actions, episode
    stats, metrics and params."""
    rt = RefPPOTrainer(RefPPOConfig(**PPO_SLICE))
    jts = rt.init(jax.random.PRNGKey(0))
    trainer = PPOTrainer(PPOConfig(**PPO_SLICE), device="cpu")
    ts = trainer.init(0)
    ts.params.load_state_dict(_flax(jts.params))
    ts = ts._replace(
        vec_state=interop.vec_state_from_numpy(jax.device_get(jts.vec_state),
                                               state_cls=CartPoleState),
        noise=CartPolePPOReplay(jts.key))
    actions = []
    step = trainer.venv.step

    def recording_step(vs, a, noise):
        actions.append(a.clone())
        return step(vs, a, noise)

    trainer.venv.step = recording_step
    ref_roll = jax.jit(lambda t: rt._collect(t)[3])(jts)
    jts, jout = rt.train_iter(jts)
    ts, out = trainer.train_iter(ts)
    np.testing.assert_array_equal(torch.stack(actions).numpy(), np.asarray(ref_roll.action))
    _assert_iter_out_equal(out, jout, "ppo_cartpole")
    for k, v in _flax(jts.params).items():
        np.testing.assert_allclose(ts.params.state_dict()[k].numpy(), v.numpy(), rtol=0,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(ts.vec_state.obs.numpy(), np.asarray(jts.vec_state.obs), rtol=0,
                               atol=ENV_ATOL)


# -- plumbing ---------------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dqn_cartpole", "ppo_cartpole"])
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
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(ref_trainer.cfg)
    assert trainer.device == torch.device("cpu")

    tiny = dict(num_envs=4, hidden_dim=32)
    tiny.update(dict(steps_per_iter=8, batch_size=16, updates_per_step=1,
                     memory_capacity=256) if name == "dqn_cartpole"
                else dict(rollout_steps=8, minibatch_size=16, num_epochs=1))
    small = type(trainer)(dataclasses.replace(trainer.cfg, **tiny), device="cpu")
    loop = TrainLoop(small, algo, log_metrics=False, log_every=1, eval_every=10 ** 9,
                     save_every=10 ** 9, eval_episodes=1)
    per_iter = 32
    ts, stats = loop.train(2 * per_iter, solve_threshold=solve)
    assert stats["env_steps"] == ts.env_steps == 2 * per_iter
    assert len(stats["curve"]) == 2 and not stats["solved"]
    assert (tmp_path / "checkpoints" / f"{algo}_CartPole-v1.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


def test_dqn_checkpoint_round_trip_and_mismatch_raises(tmp_path):
    cfg = DQNConfig(num_envs=4, steps_per_iter=8, batch_size=16, updates_per_step=1,
                    memory_capacity=64, hidden_dim=32)
    trainer = DQNTrainer(cfg, device="cpu")
    ts, _ = trainer.train_iter(trainer.init(0))
    ts, _ = trainer.train_iter(ts)
    path = save_checkpoint(str(tmp_path / "dqn.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    # the replay is not saved (the reference's _strip_replay): it comes back fresh
    fresh = trainer.init(1).replay
    assert torch.load(path, weights_only=True)["replay"] is None
    assert (ts.replay.pos, ts.replay.size) == (0, 64)
    assert (restored.replay.pos, restored.replay.size, restored.env_steps) == \
        (fresh.pos, fresh.size, ts.env_steps) == (0, 0, 64)
    for a, b in zip(restored.replay.data, fresh.data):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(restored.episodes) == int(ts.episodes)
    assert int(restored.target_syncs) == int(ts.target_syncs)
    # every other field came back: the next iteration is the same on both, from
    # the same fresh replay
    ts, out = trainer.train_iter(ts._replace(replay=fresh))
    restored, out_r = trainer.train_iter(restored)
    for net in ("params", "target_params"):
        for k, v in getattr(ts, net).state_dict().items():
            torch.testing.assert_close(getattr(restored, net).state_dict()[k], v, rtol=0, atol=0)
    torch.testing.assert_close(out_r.metrics["loss"], out.metrics["loss"], rtol=0, atol=0)

    with pytest.raises(ValueError, match="fc1.weight"):
        restore_checkpoint(path, DQNTrainer(dataclasses.replace(cfg, hidden_dim=16),
                                            device="cpu").init(0))
    with pytest.raises(ValueError, match="vec_state"):
        restore_checkpoint(path, DQNTrainer(dataclasses.replace(cfg, num_envs=8),
                                            device="cpu").init(0))
    # a replay of another capacity is no mismatch: the example's fresh one is kept
    smaller = restore_checkpoint(path, DQNTrainer(dataclasses.replace(cfg, memory_capacity=32),
                                                  device="cpu").init(0))
    assert smaller.replay.data.obs.shape[0] == 32 and smaller.replay.size == 0


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DQNTrainer(DQNConfig(num_envs=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOTrainer(PPOConfig(**PPO_SLICE))
