"""The port's LunarLander, VecEnv and registry against the JAX reference.

Both packages run on the CPU. Inputs are either made with numpy from a seed
or drawn by replaying the reference's own ``jax.random`` key splits
(``JaxReplayNoise``), so the two engines see the very same numbers.

Tolerances:
  * kinematic state and observations: atol 1e-5. The values are O(1-20);
    the two frameworks round transcendental functions differently, and XLA
    on the CPU contracts ``a*b + c`` into one fused multiply-add where
    PyTorch rounds twice, so agreement is to float32 rounding, not bitwise.
  * reward and ``prev_shaping``: atol 1e-5 + 1e-6·|shaping|. The reward is
    the difference of two shaping values of magnitude up to ~300, whose
    float32 spacing alone is 3e-5; 1e-6 relative is about 8 of those steps.
  * integer and boolean fields (indices, step counter, contact and
    termination flags): exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.envs.lunarlander import CHUNKS, H, HELIPAD_Y
from gymrl_tpu.envs.lunarlander import LunarLander as RefLander
from gymrl_tpu.envs.rollout import VecEnv as RefVecEnv
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.envs.lunarlander import LunarLander, LunarLanderParams, ResetDraws
from gymrl_tpu_torch.envs.registry import make, make_vec
from gymrl_tpu_torch.envs.rollout import VecEnv

torch.set_num_threads(1)

STATE_ATOL = 1e-5
SHAPING_RTOL = 1e-6
_EXACT = ("wind_idx", "torque_idx", "leg_contact", "t")
_SHAPING = ("prev_shaping",)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- replaying the reference's draws ------------------------------------------
def jax_reset_draws(key, num: int) -> ResetDraws:
    """The draws of ``RefLander.reset_batch(params, key, num)``: per env
    ``split(key_i, 5)``, then uniform terrain / force and randint indices."""

    def one(k):
        k_terrain, k_force, k_wind, k_torque, _ = jax.random.split(k, 5)
        return (
            jax.random.uniform(k_terrain, (CHUNKS + 1,), jnp.float32, 0.0, H / 2.0),
            jax.random.uniform(k_force, (2,), jnp.float32, -1000.0, 1000.0),
            jax.random.randint(k_wind, (), -9999, 9999),
            jax.random.randint(k_torque, (), -9999, 9999),
        )

    return ResetDraws(*map(_t, jax.vmap(one)(jax.random.split(key, num))))


def jax_step_draws(key, num: int) -> torch.Tensor:
    """The dispersion draws of ``RefLander.step_batch(..., key)``."""
    keys = jax.random.split(key, num)
    return _t(jax.vmap(lambda k: jax.random.uniform(k, (2,), jnp.float32, -1.0, 1.0))(keys))


class JaxReplayNoise:
    """A ``Noise`` stand-in that replays a reference PPO trainer's key
    splits: per rollout step ``split(key, 3)`` for (key, action, env step),
    the env step's ``split(k_step)`` into step and reset keys, and per
    iteration ``split(key)`` then one permutation key per epoch."""

    def __init__(self, key):
        self.key = key
        self.k_step = None
        self.k_reset = None

    def gumbel(self, shape):
        self.key, k_act, self.k_step = jax.random.split(self.key, 3)
        return _t(jax.random.gumbel(k_act, tuple(shape), jnp.float32))

    def env_step(self, env, num):
        k_env_step, self.k_reset = jax.random.split(self.k_step)
        return jax_step_draws(k_env_step, num)

    def env_reset(self, env, num):
        return jax_reset_draws(self.k_reset, num)

    def permutations(self, count, n):
        self.key, k_epochs = jax.random.split(self.key)
        keys = jax.random.split(k_epochs, count)
        return torch.stack([_t(jax.random.permutation(k, n)) for k in keys]).long()


# -- comparisons ---------------------------------------------------------------
def _batched(tree):
    """Reference per-env state (numpy leaves) → batch of one."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jax.device_get(tree))


def assert_state_close(state, ref, where=""):
    ref = jax.device_get(ref)
    for f in ref._fields:
        got = getattr(state, f).numpy()
        want = np.asarray(getattr(ref, f)).reshape(got.shape)
        msg = f"{f} {where}"
        if f in _EXACT:
            np.testing.assert_array_equal(got, want, err_msg=msg)
        elif f in _SHAPING:
            atol = STATE_ATOL + SHAPING_RTOL * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=STATE_ATOL, err_msg=msg)


def assert_step_close(sr, ref, where=""):
    assert_state_close(sr.state, ref.state, where)
    np.testing.assert_allclose(sr.obs.numpy(), np.asarray(ref.obs).reshape(sr.obs.shape),
                               rtol=0, atol=STATE_ATOL, err_msg=f"obs {where}")
    shaping = np.abs(np.asarray(ref.state.prev_shaping)).max()
    np.testing.assert_allclose(
        sr.reward.numpy(), np.asarray(ref.reward).reshape(sr.reward.shape),
        rtol=0, atol=STATE_ATOL + SHAPING_RTOL * shaping, err_msg=f"reward {where}",
    )
    for f in ("terminated", "truncated"):
        np.testing.assert_array_equal(
            getattr(sr, f).numpy(), np.asarray(getattr(ref, f)).reshape(sr.reward.shape),
            err_msg=f"{f} {where}",
        )


# The reference engine reads wind and dispersion from its params, so one
# engine instance and one compiled function per entry point serve every case.
_REF = RefLander()
_REF_STEP = jax.jit(_REF.step)
_REF_STEP_BATCH = jax.jit(_REF.step_batch)
_REF_RESET_BATCH = jax.jit(_REF.reset_batch, static_argnums=2)


def _pair(wind: bool, dispersion: float):
    ref_params = _REF.default_params()._replace(
        enable_wind=jnp.asarray(wind), dispersion_scale=jnp.asarray(dispersion, jnp.float32))
    env = LunarLander(enable_wind=wind)
    params = env.default_params()._replace(dispersion_scale=dispersion)
    return ref_params, env, params


# -- reset ----------------------------------------------------------------------
@pytest.mark.parametrize("wind", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_reset_matches_reference(wind, seed):
    """Same key → same terrain, body, wind indices, obs (the wind acts in
    the reset step when enabled)."""
    ref_params, env, params = _pair(wind, 1.0)
    key = jax.random.PRNGKey(seed)
    ref_state, ref_obs = _REF_RESET_BATCH(ref_params, key, 32)
    state, obs = env.reset_from(params, jax_reset_draws(key, 32))
    assert_state_close(state, ref_state, "after reset")
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=0, atol=STATE_ATOL)


def test_state_interop_round_trips():
    ref_params, env, params = _pair(False, 1.0)
    vs = _ref_rollout_states(ref_params, jax.random.PRNGKey(3))
    want = jax.device_get(vs)
    back = interop.vec_state_to_numpy(interop.vec_state_from_numpy(want))
    for f in ("obs", "ep_return", "ep_length"):
        np.testing.assert_array_equal(back[f], getattr(want, f))
    for f in want.env_state._fields:
        got, ref = back["env_state"][f], getattr(want.env_state, f)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


# -- scripted single-env cases (mirrors tests/test_lunarlander.py) --------------
def _teleport(**fields):
    def setup(state):
        return state._replace(**{k: jnp.asarray(v, jnp.float32) for k, v in fields.items()})
    return setup


_FLAT = np.full((CHUNKS,), HELIPAD_Y * 0.99, np.float32)
CASES = {
    "free_fall": dict(actions=[0] * 25, setup=None),
    "main_engine": dict(actions=[2] * 20, setup=None),
    "side_engines": dict(actions=[1, 3] * 8, setup=None),
    "mixed_control": dict(actions=list(np.random.default_rng(5).integers(0, 4, size=30)),
                          setup=None),
    "landing_plus_100": dict(
        actions=[0] * 120,
        setup=_teleport(pos=[10.0, HELIPAD_Y * 0.99 + 0.56], vel=[0.0, 0.0], angle=0.0,
                        omega=0.0, terrain=_FLAT, sleep_time=0.0),
    ),
    "crash_minus_100": dict(
        actions=[0],
        setup=_teleport(pos=[10.0, HELIPAD_Y + 0.4], vel=[0.0, -20.0], angle=1.2,
                        terrain=np.full((CHUNKS,), HELIPAD_Y, np.float32)),
    ),
    "out_of_bounds": dict(actions=[0], setup=_teleport(pos=[19.99, 10.0], vel=[3.0, 0.0])),
}


def _run_case(name, wind, dispersion):
    case = CASES[name]
    ref_params, env, params = _pair(wind, dispersion)
    ref_state, _ = _REF.reset(ref_params, jax.random.PRNGKey(0))
    if case["setup"] is not None:
        ref_state = case["setup"](ref_state)
    state = interop.lander_state_from_numpy(_batched(ref_state))
    key = jax.random.PRNGKey(1)
    last = None
    for i, a in enumerate(case["actions"]):
        key, k = jax.random.split(key)
        ref_sr = _REF_STEP(ref_params, ref_state, jnp.asarray(a, jnp.int32), k)
        disp = _t(jax.random.uniform(k, (2,), jnp.float32, -1.0, 1.0))[None]
        sr = env.step_from(params, state, torch.tensor([a], dtype=torch.int32), disp)
        assert_step_close(sr, ref_sr, f"{name} step {i}")
        ref_state, state, last = ref_sr.state, sr.state, sr
        if bool(ref_sr.terminated):
            break
    return last


@pytest.mark.parametrize("dispersion", [0.0, 1.0], ids=["no_dispersion", "jax_dispersion"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_scripted_step_matches_reference(name, dispersion):
    last = _run_case(name, wind=False, dispersion=dispersion)
    if name == "landing_plus_100":
        assert bool(last.terminated[0]) and float(last.reward[0]) == 100.0
        assert bool(last.state.leg_contact.all())
    if name in ("crash_minus_100", "out_of_bounds"):
        assert bool(last.terminated[0]) and float(last.reward[0]) == -100.0


@pytest.mark.parametrize("dispersion", [0.0, 1.0], ids=["no_dispersion", "jax_dispersion"])
def test_wind_flight_matches_reference(dispersion):
    _run_case("mixed_control", wind=True, dispersion=dispersion)


# -- one batched step from rollout states --------------------------------------
NUM = 16


@jax.jit
def _ref_vec_step(ref_params, vs, actions, key):
    return RefVecEnv(_REF, ref_params, NUM).step(vs, actions, key)


@jax.jit
def _ref_rollout_states(ref_params, key):
    """``NUM`` reference envs after 80 random-action steps with autoreset:
    a mix of flight, ground contact and fresh episodes."""
    k_reset, k_roll = jax.random.split(key)

    def body(vs, k):
        k_a, k_s = jax.random.split(k)
        a = jax.random.randint(k_a, (NUM,), 0, 4)
        return _ref_vec_step(ref_params, vs, a, k_s)[0], None

    vs = RefVecEnv(_REF, ref_params, NUM)._reset_impl(k_reset)
    vs, _ = jax.lax.scan(body, vs, jax.random.split(k_roll, 80))
    return vs


@pytest.mark.parametrize("wind", [False, True])
def test_batch_step_matches_reference(wind):
    ref_params, env, params = _pair(wind, 1.0)
    vs = _ref_rollout_states(ref_params, jax.random.PRNGKey(3))
    assert np.asarray(vs.env_state.leg_contact).any(), "want contact states in the batch"
    actions = np.random.default_rng(0).integers(0, 4, 16).astype(np.int32)
    key = jax.random.PRNGKey(11)
    ref_sr = _REF_STEP_BATCH(ref_params, vs.env_state, jnp.asarray(actions), key)
    state = interop.lander_state_from_numpy(jax.device_get(vs.env_state))
    sr = env.step_from(params, state, torch.from_numpy(actions), jax_step_draws(key, 16))
    assert_step_close(sr, ref_sr, "batch step")


# -- VecEnv autoreset ------------------------------------------------------------
def test_vecenv_step_autoreset_matches_reference():
    """Done envs (crash, out of bounds, time limit) are reset in the same
    step; next_obs is the true successor, final stats are valid where done."""
    ref_params, env, params = _pair(False, 1.0)
    num = NUM
    vs = _ref_rollout_states(ref_params, jax.random.PRNGKey(5))
    es = vs.env_state
    pos = np.array(es.pos)
    vel = np.array(es.vel)
    t = np.array(es.t)
    pos[:3] = [19.99, 10.0]  # drift out of bounds
    vel[:3] = [3.0, 0.0]
    t[3:5] = 999  # truncated by the time limit this step
    vs = vs._replace(env_state=es._replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                                           t=jnp.asarray(t)))
    actions = np.random.default_rng(1).integers(0, 4, num).astype(np.int32)
    key = jax.random.PRNGKey(21)
    ref_vs, ref_tr = _ref_vec_step(ref_params, vs, jnp.asarray(actions), key)

    noise = JaxReplayNoise(None)
    noise.k_step = key
    new_vs, tr = VecEnv(env, params, num).step(
        interop.vec_state_from_numpy(jax.device_get(vs)), torch.from_numpy(actions), noise)

    done = np.asarray(ref_tr.done)
    assert done[:5].all() and np.asarray(ref_tr.truncated)[3:5].all()
    assert_state_close(new_vs.env_state, ref_vs.env_state, "after autoreset")
    # returns are sums of rewards: they telescope to a shaping difference
    reward_atol = STATE_ATOL + SHAPING_RTOL * np.abs(np.asarray(es.prev_shaping)).max()
    for obj, ref_obj, f, atol in (
        (new_vs, ref_vs, "obs", STATE_ATOL), (new_vs, ref_vs, "ep_return", reward_atol),
        (tr, ref_tr, "obs", STATE_ATOL), (tr, ref_tr, "next_obs", STATE_ATOL),
        (tr, ref_tr, "reward", reward_atol), (tr, ref_tr, "final_return", reward_atol),
    ):
        np.testing.assert_allclose(getattr(obj, f).numpy(), np.asarray(getattr(ref_obj, f)),
                                   rtol=0, atol=atol, err_msg=f)
    np.testing.assert_array_equal(new_vs.ep_length.numpy(), np.asarray(ref_vs.ep_length))
    for f in ("action", "terminated", "truncated", "done", "final_length"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(ref_tr, f)),
                                      err_msg=f)


# -- registry ----------------------------------------------------------------------
def test_registry_makes_lunarlander_and_lists_what_it_has():
    for name in ("LunarLander-v2", "LunarLander-v3"):
        env = make(name)
        assert isinstance(env, LunarLander) and env.n_actions == 4 and env.obs_dim == 8
    venv = make_vec("LunarLander-v3", 5)
    assert venv.num_envs == 5 and venv.params == LunarLanderParams()
    with pytest.raises(KeyError, match="LunarLander-v3"):
        make("Acrobot-v1")
    cont = make("LunarLander-v3", continuous=True)
    assert cont.act_dim == 2 and cont.action_bound == 1.0 and cont.n_actions is None
