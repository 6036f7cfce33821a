"""The port's tabular slice against the JAX reference: FrozenLake,
CliffWalking and MountainCar step for step, ``VecEnv``'s autoreset for an
observation of rank 0 (and ``tree_select`` at any rank and nesting), tabular
Q-learning in lockstep and on its solve configs, the MountainCar rule
policy, the interop and checkpoint of the Q-learning state, and the CLI.

Both packages run on the CPU. The port's noise replays the reference's
``jax.random`` key splits (``TabularReplayNoise``, ``EvalReplay``), so both
draw the same numbers: FrozenLake's slip per env and step, MountainCar's
reset positions, Q-learning's ε-greedy pair.

Tolerances, each with its reason:
  * the grid engines, the Q-learning counters, ε, actions, episode stats,
    the rule policy's actions: exact (integer arithmetic, or the same
    float32 operations on the same inputs).
  * MountainCar: one step 1e-6, a 200-step free run 1e-5 (``cos`` and a
    fused ``a*b + c`` round differently in the two frameworks).
  * the Q-table: rtol 1e-6 (float32 TD sums of duplicate (s, a) pairs; the
    CPU scatters add in the same order in both frameworks).
  * ε: one float32 ulp. The port computes the reference's eager
    ``exp_epsilon_decay`` to the bit, but inside the reference's compiled
    scan XLA rounds ``exp(-t/decay)`` differently by up to one ulp. A
    uniform falling between the two values would flip an action, which the
    exact checks of the episodes and the Q-table would catch.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.algos import tabular as R
from gymrl_tpu.envs import rollout as ref_rollout
from gymrl_tpu.envs.cliffwalking import CliffWalking as RefCliffWalking
from gymrl_tpu.envs.frozenlake import FrozenLake as RefFrozenLake
from gymrl_tpu.envs.mountaincar import MountainCar as RefMountainCar
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos import tabular as T
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs.cliffwalking import CliffWalking, CliffWalkingState
from gymrl_tpu_torch.envs.frozenlake import FrozenLake, FrozenLakeState
from gymrl_tpu_torch.envs.mountaincar import MountainCar, MountainCarState
from gymrl_tpu_torch.envs.registry import make, make_vec
from gymrl_tpu_torch.envs.rollout import VecEnv, tree_select
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

torch.set_num_threads(1)

MC_STEP_ATOL = 1e-6
MC_RUN_ATOL = 1e-5
Q_RTOL = 1e-6


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- replaying the reference's draws ---------------------------------------------
@functools.partial(jax.jit, static_argnums=1)
def _slips(key, num):
    return jax.vmap(lambda k: jax.random.randint(k, (), -1, 2))(jax.random.split(key, num))


@functools.partial(jax.jit, static_argnums=1)
def _mc_reset_u(key, num):
    return jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32, -0.6, -0.4))(
        jax.random.split(key, num))


def reset_draws(env, key, num):
    """What the reference engine of ``env``'s kind draws in a batched reset."""
    if isinstance(env, MountainCar):
        return _t(_mc_reset_u(key, num))
    return torch.zeros(num, dtype=torch.int32)  # the grids draw nothing


def step_draws(env, key, num):
    return _t(_slips(key, num)) if isinstance(env, FrozenLake) else None


class TabularReplayNoise:
    """Replays ``QLearningTrainer``'s key tree: per vector step ``split(key,
    4)`` into (key, ε, random action, env step), asked for by ``explore``;
    ``VecEnv.step`` splits the env-step key into (step, reset)."""

    def __init__(self, key):
        self.key = key
        self.calls: list[str] = []

    def explore(self, num, n_actions):
        self.calls.append("explore")
        self.key, k_eps, k_rand, self.k_step = jax.random.split(self.key, 4)
        return (_t(jax.random.uniform(k_eps, (num,))),
                _t(jax.random.randint(k_rand, (num,), 0, n_actions)))

    def env_step(self, env, num):
        self.calls.append("env_step")
        k_env, self.k_reset = jax.random.split(self.k_step)
        return step_draws(env, k_env, num)

    def env_reset(self, env, num):
        self.calls.append("env_reset")
        return reset_draws(env, self.k_reset, num)


class EvalReplay:
    """Replays the reference ``eval_episodes``: ``split(key)`` into reset and
    roll keys, one roll key per step, each split into (action, env step)."""

    def __init__(self, key, max_steps):
        self.k_reset, k_roll = jax.random.split(key)
        self.step_keys = iter(jax.random.split(k_roll, max_steps))

    def env_reset(self, env, num):
        return reset_draws(env, self.k_reset, num)

    def env_step(self, env, num):
        return step_draws(env, jax.random.split(next(self.step_keys))[1], num)


def _assert_fields(got, want, where, atol=0.0):
    want = jax.device_get(want)
    for f in got._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{f} {where}")


def _ref_step(env, params, state, actions, key):
    return jax.jit(env.step_batch)(params, state, jnp.asarray(actions), key)


# -- engines ---------------------------------------------------------------------------
@pytest.mark.parametrize("slippery", [True, False])
def test_frozenlake_steps_match_reference(slippery, rng):
    """Every cell × every action, at t = 0 and t = 99 (the limit), slipping
    with the reference's draws: cells, flags and rewards exact. Without a
    slip the slip is still drawn, and ignored."""
    ref, env = RefFrozenLake(slippery), FrozenLake(slippery)
    rp, p = ref.default_params(), env.default_params()
    pos = np.repeat(np.arange(16, dtype=np.int32), 4 * 2)
    action = np.tile(np.repeat(np.arange(4, dtype=np.int32), 2), 16)
    t = np.tile(np.array([0, 99], np.int32), 64)
    key = jax.random.PRNGKey(3)
    ref_state = jax.vmap(ref.reset, in_axes=(None, 0))(rp, jax.random.split(key, 128))[0]
    want = _ref_step(ref, rp, ref_state._replace(pos=jnp.asarray(pos), t=jnp.asarray(t)),
                     action, key)
    got = env.step_from(p, FrozenLakeState(_t(pos), _t(t)), _t(action), step_draws(env, key, 128))
    _assert_fields(got.state, want.state, "state")
    for f in ("obs", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    assert got.terminated.any() and got.truncated.any() and (got.reward == 1.0).any()
    assert not (got.terminated & got.truncated).any()
    if not slippery:  # the plain move: LEFT from cell 1 is cell 0
        assert int(got.obs[(pos == 1) & (action == 0)][0]) == 0
    state, obs = env.reset_from(p, env.reset_draws(Noise("cpu", 0), 3))
    ref_state, ref_obs = jax.vmap(ref.reset, in_axes=(None, 0))(rp, jax.random.split(key, 3))
    _assert_fields(state, ref_state, "reset")
    np.testing.assert_array_equal(obs.numpy(), np.asarray(ref_obs))


def test_cliffwalking_steps_match_reference():
    """Every cell × every action (UP=0, RIGHT=1, DOWN=2, LEFT=3): a cliff
    cell gives −100 and sends the agent to 36 without ending the episode;
    only the goal terminates; the 1000-step cap truncates."""
    ref, env = RefCliffWalking(), CliffWalking()
    rp, p = ref.default_params(), env.default_params()
    pos = np.repeat(np.arange(48, dtype=np.int32), 4 * 2)
    action = np.tile(np.repeat(np.arange(4, dtype=np.int32), 2), 48)
    t = np.tile(np.array([5, 999], np.int32), 192)
    key = jax.random.PRNGKey(0)
    ref_state = jax.vmap(ref.reset, in_axes=(None, 0))(rp, jax.random.split(key, 384))[0]
    want = _ref_step(ref, rp, ref_state._replace(pos=jnp.asarray(pos), t=jnp.asarray(t)),
                     action, key)
    got = env.step_from(p, CliffWalkingState(_t(pos), _t(t)), _t(action), None)
    _assert_fields(got.state, want.state, "state")
    for f in ("obs", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    fall = (pos == 36) & (action == 1)  # RIGHT from the start: into the cliff
    assert (got.reward[fall] == -100.0).all() and (got.obs[fall] == 36).all()
    assert not got.terminated[fall].any()
    assert got.terminated[(pos == 35) & (action == 2)].all()  # DOWN onto the goal
    state, obs = env.reset_from(p, env.reset_draws(Noise("cpu", 0), 2))
    assert obs.tolist() == [36, 36] and state.t.tolist() == [0, 0]


def test_mountaincar_step_and_free_run_match_reference(rng):
    """One step from 4096 states (at both walls, the goal, the speed
    limits) at 1e-6; then a 200-step free run from the reference's reset
    draws with the same random actions at 1e-5, flags exact."""
    ref, env = RefMountainCar(), MountainCar()
    rp, p = ref.default_params(), env.default_params()
    n = 4096
    position = rng.uniform(-1.25, 0.65, n).astype(np.float32)
    position[:8] = [-1.2, -1.2, 0.5, 0.6, -1.19, 0.499, -0.5, 0.5]
    velocity = rng.uniform(-0.075, 0.075, n).astype(np.float32)
    velocity[:8] = [-0.07, 0.0, 0.0, 0.07, -0.01, 0.002, 0.07, -0.001]
    action = rng.integers(0, 3, n).astype(np.int32)
    key = jax.random.PRNGKey(1)
    ref_state = jax.vmap(ref.reset, in_axes=(None, 0))(rp, jax.random.split(key, n))[0]
    ref_state = ref_state._replace(position=jnp.asarray(position),
                                   velocity=jnp.asarray(velocity))
    want = _ref_step(ref, rp, ref_state, action, key)
    got = env.step_from(p, interop.state_from_numpy(jax.device_get(ref_state),
                                                    MountainCarState), _t(action))
    _assert_fields(got.state, want.state, "step", MC_STEP_ATOL)
    np.testing.assert_array_equal(got.terminated.numpy(), np.asarray(want.terminated))
    assert got.terminated.any() and (got.state.velocity[got.state.position == -1.2] >= 0).all()

    b = 256
    key = jax.random.PRNGKey(2)
    ref_state, ref_obs = jax.vmap(ref.reset, in_axes=(None, 0))(rp, jax.random.split(key, b))
    state, obs = env.reset_from(p, reset_draws(env, key, b))
    _assert_fields(state, ref_state, "reset")
    step = jax.jit(ref.step_batch)
    for i in range(200):
        a = rng.integers(0, 3, b).astype(np.int32)
        want = step(rp, ref_state, jnp.asarray(a), key)
        got = env.step_from(p, state, _t(a))
        _assert_fields(got.state, want.state, f"run step {i}", MC_RUN_ATOL)
        for f in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        ref_state, state = want.state, got.state
    assert bool(got.truncated.all())  # random pushes never reach the flag


def test_registry_makes_the_tabular_envs():
    fl, cw, mc = make("FrozenLake-v1"), make("CliffWalking-v0"), make("MountainCar-v0")
    assert (fl.n_actions, fl.obs_shape, fl.max_steps, fl.n_states) == (4, (), 100, 16)
    assert (cw.n_actions, cw.obs_shape, cw.max_steps, cw.n_states) == (4, (), 1000, 48)
    assert (mc.n_actions, mc.obs_dim, mc.max_steps) == (3, 2, 200)
    assert make_vec("FrozenLake-v1", 2, {"is_slippery": False}).params.is_slippery is False
    with pytest.raises(KeyError, match="FrozenLake-v1"):
        make("Acrobot-v1")


# -- VecEnv autoreset: rank-0 observations ------------------------------------------
def test_tree_select_matches_reference_at_any_rank_and_nesting(rng):
    """``tree_select`` against the reference's ``_tree_select`` on tensors of
    rank 1 (``i32[B]`` obs), 2 and 4 (``[B, 48, 48, 4]`` frames), and on a
    NamedTuple nesting another, as ``PixelState`` nests its engine's."""
    from typing import NamedTuple

    class In(NamedTuple):
        a: np.ndarray
        b: np.ndarray

    class Out(NamedTuple):
        inner: In
        frames: np.ndarray

    b = 6
    pred = rng.random(b) < 0.5
    pred[:2] = [True, False]

    def pair(shape, dtype=np.float32):
        return [rng.normal(size=shape).astype(dtype) for _ in range(2)]

    cases = [pair((b,), np.int32), pair((b, 3)), pair((b, 5, 5, 4))]
    (a0, a1), (b0, b1), (f0, f1) = pair((b,)), pair((b, 2)), pair((b, 4, 4, 2))
    cases.append((Out(In(a0, b0), f0), Out(In(a1, b1), f1)))
    for on_true, on_false in cases:
        want = ref_rollout._tree_select(jnp.asarray(pred),
                                        *jax.tree_util.tree_map(jnp.asarray, (on_true, on_false)))
        got = tree_select(_t(pred), *jax.tree_util.tree_map(_t, (on_true, on_false)))
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vec_env_autoresets_frozenlake_against_reference():
    """Fault 1: ``i32[B]`` observations. 40 steps of B=16 slippery
    FrozenLake with random actions and the reference's draws: every
    transition and carried state equal to ``VecEnv.step``'s, exactly the
    done rows reset to cell 0, and episodes end inside the run."""
    b = 16
    ref_venv = R.make_vec("FrozenLake-v1", b)
    venv = make_vec("FrozenLake-v1", b)
    key = jax.random.PRNGKey(5)
    ref_vs = ref_venv.reset(key)
    vs = interop.vec_state_from_numpy(jax.device_get(ref_vs), state_cls=FrozenLakeState)
    noise = TabularReplayNoise(None)
    gen = np.random.default_rng(1)
    ref_step = jax.jit(ref_venv.step)
    dones = 0
    for i in range(40):
        a = gen.integers(0, 4, b).astype(np.int32)
        key, k = jax.random.split(key)
        noise.k_step = k
        vs, tr = venv.step(vs, _t(a), noise)
        ref_vs, ref_tr = ref_step(ref_vs, jnp.asarray(a), k)
        _assert_fields(tr, ref_tr, f"transition {i}")
        _assert_fields(vs.env_state, ref_vs.env_state, f"state {i}")
        for f in ("obs", "ep_return", "ep_length"):
            np.testing.assert_array_equal(getattr(vs, f).numpy(), np.asarray(getattr(ref_vs, f)))
        assert vs.obs.shape == (b,)
        assert (vs.obs[tr.done] == 0).all() and (vs.obs[~tr.done] == tr.next_obs[~tr.done]).all()
        dones += int(tr.done.sum())
    assert dones > 0


# -- Q-learning --------------------------------------------------------------------------
PRESETS = {
    "frozenlake": (R.qlearning_frozenlake_config, T.qlearning_frozenlake_config),
    "cliffwalking": (R.qlearning_cliffwalking_config, T.qlearning_cliffwalking_config),
}
NARROW = dict(num_envs=8, steps_per_iter=16)


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(preset, **kw):
        k = (preset, tuple(sorted(kw.items())))
        if k not in cache:
            cache[k] = R.QLearningTrainer(PRESETS[preset][0](**{**NARROW, **kw}))
        return cache[k]

    return get


def _port(preset, rt, jts):
    """The port trainer at the reference's config, the reference state
    carried across, and the replaying noise."""
    trainer = T.QLearningTrainer(PRESETS[preset][1](**dataclasses.asdict(rt.cfg)), device="cpu")
    noise = TabularReplayNoise(jts.key)
    return trainer, interop.train_state_from_reference(trainer, jax.device_get(jts), noise), noise


def _assert_q_state_close(ts, jts, where):
    jts = jax.device_get(jts)
    np.testing.assert_allclose(ts.q_table.numpy(), jts.q_table, rtol=Q_RTOL, atol=0,
                               err_msg=f"q_table {where}")
    assert (ts.env_steps, ts.sample_count) == (int(jts.env_steps), int(jts.sample_count)), where
    _assert_fields(ts.vec_state.env_state, jts.vec_state.env_state, where)
    for f in ("obs", "ep_return", "ep_length"):
        np.testing.assert_array_equal(getattr(ts.vec_state, f).numpy(),
                                      np.asarray(getattr(jts.vec_state, f)), err_msg=where)


@pytest.mark.parametrize("start", ["reset", "late"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_train_iters_match_reference(refs, preset, start):
    """Two iterations, each from the reference's state with its draws
    replayed: the Q-table to rtol 1e-6; ε, the counters, the env batch and
    the episode stats exact; the draws asked for in the reference's order.
    ``late`` starts after 45 reference iterations: a learned table, ε
    decayed, episodes ending."""
    rt = refs(preset)
    cfg = rt.cfg
    jts = rt.init(jax.random.PRNGKey(0))
    for _ in range(45 if start == "late" else 0):
        jts, _ = rt.train_iter(jts)
    done = 0
    for it in range(2):
        trainer, ts, noise = _port(preset, rt, jts)
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"{preset} {start} iteration {it}"
        assert noise.calls == ["explore", "env_step", "env_reset"] * cfg.steps_per_iter, where
        _assert_q_state_close(ts, jts, where)
        for f in ("ep_done", "ep_length", "ep_return"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                          err_msg=f"{f} {where}")
        eps, want_eps = np.float32(out.metrics["epsilon"]), np.float32(jout.metrics["epsilon"])
        assert abs(eps - want_eps) <= np.spacing(want_eps), where  # one ulp: see the docstring
        np.testing.assert_allclose(float(out.metrics["q_max"]), float(jout.metrics["q_max"]),
                                   rtol=Q_RTOL)
        done += int(np.asarray(jout.ep_done).sum())
    if start == "late":
        assert done > 0 and float(jout.metrics["epsilon"]) < 0.5


def test_shaping_and_update_math_match_reference():
    """The FrozenLake shaping (hole, no move, goal, step) and the reference's
    single-update case: greedy from a zero table is action 0 (UP) from cell
    36 to cell 24, r = −1, so Q[36, 0] = 0.1·(−1 + 0.9·0)."""
    s, ns = torch.tensor([0, 0, 14, 4]), torch.tensor([5, 0, 15, 8])
    np.testing.assert_array_equal(T._shape_frozenlake(s, ns, torch.zeros(4)).numpy(),
                                  [-10.0, -5.0, 100.0, -1.0])
    np.testing.assert_array_equal(
        T._shape_frozenlake(s, ns, torch.zeros(4)).numpy(),
        np.asarray(R._shape_frozenlake(jnp.asarray(s.numpy()), jnp.asarray(ns.numpy()),
                                       jnp.zeros(4))))
    kw = dict(num_envs=1, steps_per_iter=1, epsilon_start=0.0, epsilon_end=0.0)
    trainer = T.QLearningTrainer(T.qlearning_cliffwalking_config(**kw), device="cpu")
    ts, _ = trainer.train_iter(trainer.init(0))
    rt = R.QLearningTrainer(R.qlearning_cliffwalking_config(**kw))
    jts, _ = rt.train_iter(rt.init(jax.random.PRNGKey(0)))
    np.testing.assert_allclose(float(ts.q_table[36, 0]), 0.1 * (-1.0 + 0.9 * 0.0), rtol=1e-6)
    np.testing.assert_array_equal(ts.q_table.numpy(), np.asarray(jts.q_table))
    # the greedy action is the first maximal index, as jnp.argmax's
    q = torch.tensor([[0.0, 0.0, 0.0, 0.0], [1.0, 2.0, 2.0, 0.0], [-1.0, -1.0, -3.0, -1.0]])
    obs = torch.tensor([0, 1, 2])
    assert trainer.policy(ts._replace(q_table=q), obs, None).tolist() == [0, 1, 0]


SOLVE = dict(num_envs=32, steps_per_iter=64, epsilon_decay=3000.0)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_solve_config_reproduces_reference(refs, preset):
    """The reference's solve configs (``tests/test_tabular.py``), 80
    iterations with the reference's draws, free-running: the same Q-table
    (rtol 1e-6), greedy policy and eval as the reference. FrozenLake's
    success over 50 episodes is above 0.08 (its reward shaping caps it near
    0.12); CliffWalking's deterministic return is above −20 (−13 optimal)."""
    rt = refs(preset, **SOLVE)
    jts = rt.init(jax.random.PRNGKey(0))
    trainer, ts, _ = _port(preset, rt, jts)
    for _ in range(80):
        jts, _ = rt.train_iter(jts)
        ts, _ = trainer.train_iter(ts)
    _assert_q_state_close(ts, jts, preset)
    np.testing.assert_array_equal(trainer.policy(ts, torch.arange(trainer.n_states), None).numpy(),
                                  np.asarray(rt.policy(jts, jnp.arange(rt.n_states), None)))
    key = jax.random.PRNGKey(1)
    if preset == "frozenlake":
        rate = trainer.success_rate(ts, EvalReplay(key, 100), episodes=50)
        assert rate == rt.success_rate(jts, key, episodes=50)
        assert rate > 0.08, f"success rate {rate} below the shaped-optimal regime (~0.12)"
    else:
        returns, lengths = trainer.eval_episodes(ts, EvalReplay(key, 1000), 5)
        want_r, want_l = rt.eval_episodes(jts, key, 5)
        np.testing.assert_array_equal(returns.numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_l))
        assert float(returns.mean()) > -20.0


# -- the MountainCar rule policy --------------------------------------------------------
def test_mountaincar_baseline_policy_matches_reference():
    """The phase-space band on a 301 × 301 grid of (position, velocity)
    covering the whole state space, and on the grid's points nudged by an
    ulp: actions exact."""
    pos = np.linspace(-1.2, 0.6, 301, dtype=np.float32)
    vel = np.linspace(-0.07, 0.07, 301, dtype=np.float32)
    obs = np.stack(np.meshgrid(pos, vel, indexing="ij"), -1).reshape(-1, 2)
    obs = np.concatenate([obs, np.nextafter(obs, np.float32(1.0))])
    ref = R.MountainCarBaseline()
    want = np.asarray(jax.jit(lambda o: ref.policy(None, o, None))(jnp.asarray(obs)))
    got = T.MountainCarBaseline(device="cpu").policy(None, _t(obs), None).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 2}


def test_mountaincar_baseline_eval_matches_reference_and_solves():
    """Ten deterministic episodes from the reference's eval draws: the same
    lengths and returns as the reference's, every one reaching the flag."""
    agent, ref = T.MountainCarBaseline(device="cpu"), R.MountainCarBaseline()
    key = jax.random.PRNGKey(1)
    returns, lengths = agent.eval_episodes(agent.init(0), EvalReplay(key, 200), 10)
    want_r, want_l = ref.eval_episodes(ref.init(jax.random.PRNGKey(0)), key, 10)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(returns.numpy(), np.asarray(want_r))
    assert float(returns.mean()) > -200.0 and bool((lengths < 200).all())


# -- interop, checkpoints, CLI ------------------------------------------------------------
def test_train_state_interop_and_checkpoint_round_trip(refs, tmp_path):
    """A reference state after 3 iterations carried across to the bit; a
    strict checkpoint round trip of the port state, after which the next
    iteration is the same; a mismatch raises."""
    rt = refs("frozenlake")
    jts = jax.device_get(functools.reduce(lambda s, _: rt.train_iter(s)[0], range(3),
                                          rt.init(jax.random.PRNGKey(0))))
    trainer, ts, _ = _port("frozenlake", rt, jts)
    np.testing.assert_array_equal(ts.q_table.numpy(), jts.q_table)
    _assert_q_state_close(ts, jts, "interop")
    back = interop.vec_state_to_numpy(ts.vec_state)
    np.testing.assert_array_equal(back["env_state"]["pos"], jts.vec_state.env_state.pos)

    ts = ts._replace(noise=Noise("cpu", 3))
    ts, _ = trainer.train_iter(ts)
    path = save_checkpoint(str(tmp_path / "q.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    assert (restored.env_steps, restored.sample_count) == (ts.env_steps, ts.sample_count)
    ts, out = trainer.train_iter(ts)
    restored, out_r = trainer.train_iter(restored)
    torch.testing.assert_close(restored.q_table, ts.q_table, rtol=0, atol=0)
    torch.testing.assert_close(out_r.ep_return, out.ep_return, rtol=0, atol=0)
    other = T.QLearningTrainer(T.qlearning_cliffwalking_config(**NARROW), device="cpu")
    with pytest.raises(ValueError, match="q_table"):
        restore_checkpoint(path, other.init(0))


def test_cli_has_every_reference_workload_and_runs_the_baseline(capsys):
    assert set(cli.WORKLOADS) == set(ref_cli.WORKLOADS) and len(cli.WORKLOADS) == 21
    assert cli.main(["mountaincar_baseline", "--device", "cpu"]) == 0
    assert cli.main([]) == 1
    assert "mountaincar_baseline" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["qlearning_frozenlake", "qlearning_cliffwalking"])
def test_cli_workload_trains_in_train_loop_on_cpu(name, tmp_path, monkeypatch):
    """The workload's trainer, config and solve bar are the reference CLI's;
    it trains two iterations in TrainLoop with eval and a final checkpoint."""
    monkeypatch.chdir(tmp_path)
    trainer, algo, solve = cli.WORKLOADS[name]("cpu")
    ref_trainer, ref_algo, ref_solve = ref_cli.WORKLOADS[name]()
    assert (algo, solve) == (ref_algo, ref_solve)
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(ref_trainer.cfg)
    assert trainer.device == torch.device("cpu")
    per_iter = trainer.cfg.num_envs * trainer.cfg.steps_per_iter
    loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1, eval_every=2 * per_iter,
                     save_every=10 ** 9, eval_episodes=1)
    ts, stats = loop.train(2 * per_iter, solve_threshold=solve)
    assert stats["env_steps"] == ts.env_steps == ts.sample_count == 2 * per_iter
    assert len(stats["curve"]) == 2 and not stats["solved"]
    assert (tmp_path / "checkpoints" / f"{algo}_{trainer.venv.env.name}.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


@pytest.mark.parametrize("cls", [T.QLearningTrainer, T.MountainCarBaseline])
def test_default_device_without_cuda_raises(cls):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(T.qlearning_frozenlake_config()) if cls is T.QLearningTrainer else cls()
