"""The port's PER sum-tree, FlappyBird engine and layer zoo (PReLU,
NoisyDense, MLP, PSCN) against the JAX reference.

Both packages run on the CPU, on the same numpy-seeded inputs. Draws are
the reference's own: PER's stratified uniforms and FlappyBird's gap
centres come from replaying its ``jax.random`` keys, and NoisyNet ε from
recording what the flax layers drew (``record_noise``: the draws do not
depend on the input, so a replaying noise source can make them from the key
and the shapes alone).

Tolerances, each with its reason:
  * PER: the sum-tree, the sampled leaf indices, the batch and
    ``max_priority`` exact. Both frameworks add leaf deltas in index order
    on the CPU, so the tree carries the same float32 rounding bit for bit.
    IS weights rtol 1e-6 (``pow`` may round differently by an ulp).
  * FlappyBird: state fields and observations atol 1e-6 (the engine is
    float32 adds, clamps and divisions by constants; in practice they agree
    to the bit), rewards atol 1e-6; flags, score and step counters exact.
  * layers: outputs and gradients atol 1e-5 / rtol 1e-5 (float32 matmuls
    of widths ≤ 64 summed in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.envs.flappybird import FlappyBird as RefFlappy
from gymrl_tpu.envs.rollout import VecEnv as RefVecEnv
from gymrl_tpu.nn import layers as ref_layers
from gymrl_tpu.replay import per as ref_per
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.envs.flappybird import FlappyBird, FlappyBirdState
from gymrl_tpu_torch.envs.registry import make, make_vec
from gymrl_tpu_torch.nn.layers import MLP, PSCN, NoisyDense, PReLU, noisy_layers
from gymrl_tpu_torch.replay import per

from test_torch_dqn import EnvReplay

torch.set_num_threads(1)

ENV_ATOL = 1e-6
ATOL = 1e-5
RTOL = 1e-5
WEIGHT_RTOL = 1e-6


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- replaying the reference's draws ----------------------------------------------
_REF_FB = RefFlappy()
_GAP_LOW, _GAP_HIGH = _REF_FB.default_params()


@jax.jit
def _flappy_reset_draws(key, num_keys):
    """``reset_batch(params, key, num)``: per env ``split(k)`` into (gaps,
    the state's key)."""
    def one(k):
        k_gaps, k_state = jax.random.split(k)
        return jax.random.uniform(k_gaps, (3,), jnp.float32, _GAP_LOW, _GAP_HIGH), k_state
    return jax.vmap(one)(jax.random.split(key, num_keys.shape[0]))


@jax.jit
def _flappy_step_draws(env_keys):
    """A step's respawn gaps: per env ``split(state.key)`` into (next key, gaps)."""
    def one(k):
        k_next, k_gap = jax.random.split(k)
        return jax.random.uniform(k_gap, (3,), jnp.float32, _GAP_LOW, _GAP_HIGH), k_next
    return jax.vmap(one)(env_keys)


class FlappyKeys:
    """Tracks the per-env PRNG keys a reference FlappyBird batch keeps in its
    state, and hands out the gaps the reference draws from them. The port's
    state has no key, so after each ``VecEnv.step`` the keys are selected by
    ``done`` as the reference selects its states (``after_step``)."""

    def __init__(self, env_keys):
        self.env_keys = env_keys
        self.stepped = self.reset_keys = None

    def step_gaps(self):
        gaps, self.stepped = _flappy_step_draws(self.env_keys)
        return _t(gaps)

    def reset_gaps(self, key, num):
        gaps, self.reset_keys = _flappy_reset_draws(key, jnp.zeros(num))
        return _t(gaps)

    def after_step(self, done):
        self.env_keys = jnp.where(jnp.asarray(done.numpy())[:, None], self.reset_keys,
                                  self.stepped)


class FlappyEnvReplay(EnvReplay):
    """The env part of a replaying noise for FlappyBird batches: VecEnv's
    ``split(k_step)`` into (step, reset) keys, the reset gaps from the reset
    key, the respawn gaps from the per-env keys."""

    def __init__(self, env_keys):
        self.flappy = FlappyKeys(env_keys)

    def env_step(self, env, num):
        _, self.k_reset = jax.random.split(self.k_step)
        return self.flappy.step_gaps()

    def env_reset(self, env, num):
        return self.flappy.reset_gaps(self.k_reset, num)


_RECORDERS: dict = {}


def record_noise(module, variables, x, key, per_sample: bool):
    """``(y, [(eps_in, eps_out), ...])``: the flax ``module``'s noisy forward
    and the scaled ε each ``NoisyDense`` drew, in call order, recorded by
    wrapping ``gymrl_tpu.nn.layers._scale_noise`` while tracing. One jitted
    recorder per (module, mode), so repeated draws do not retrace."""
    if (module, per_sample) not in _RECORDERS:
        recorded = []
        orig = ref_layers._scale_noise

        def rec(v):
            out = orig(v)
            recorded.append(out)
            return out

        def run(variables, x, key):
            recorded.clear()
            ref_layers._scale_noise = rec
            try:
                y = module.apply(variables, x, per_sample=per_sample, rngs={"noise": key})
            finally:
                ref_layers._scale_noise = orig
            return y, list(recorded)

        _RECORDERS[module, per_sample] = jax.jit(run)
    y, eps = _RECORDERS[module, per_sample](variables, x, key)
    return y, [(_t(a), _t(b)) for a, b in zip(eps[0::2], eps[1::2])]


# -- PER ------------------------------------------------------------------------------
class _Uniforms:
    def __init__(self, key):
        self.key = key

    def per_uniforms(self, batch_size):
        return _t(jax.random.uniform(self.key, (batch_size,), jnp.float32))


def _data(lo, hi, jax_side=False):
    x = np.arange(lo, hi, dtype=np.float32)[:, None].repeat(2, 1) * 0.5
    a = np.arange(lo, hi, dtype=np.int32)
    leaves = (x, a)
    if jax_side:
        return {"x": jnp.asarray(x), "a": jnp.asarray(a)}
    from collections import namedtuple
    return namedtuple("D", "x a")(*map(torch.from_numpy, leaves))


def _per_pair(capacity):
    from collections import namedtuple
    example = namedtuple("D", "x a")(torch.zeros(2), torch.zeros((), dtype=torch.int32))
    ref_example = {"x": jnp.zeros(2), "a": jnp.zeros((), jnp.int32)}
    return per.per_init(example, capacity), ref_per.per_init(ref_example, capacity)


def assert_per_equal(st, ref_st, where=""):
    ref_st = jax.device_get(ref_st)
    assert (st.pos, st.size) == (int(ref_st.pos), int(ref_st.size)), where
    np.testing.assert_array_equal(st.tree.numpy(), ref_st.tree, err_msg=f"tree {where}")
    assert float(st.max_priority) == float(ref_st.max_priority), where
    for f in ("x", "a"):
        np.testing.assert_array_equal(getattr(st.data, f).numpy(), ref_st.data[f],
                                      err_msg=f"{f} {where}")


def test_per_push_and_wraparound_match_reference():
    """Pushes that wrap the ring, with a priority update in between so
    later pushes carry a new max priority: tree, data, pos/size exact."""
    st, ref_st = _per_pair(16)
    pushes = ((0, 4), (4, 10), (10, 17), (17, 22), (22, 35))
    for i, (lo, hi) in enumerate(pushes):
        st = per.per_push_batch(st, _data(lo, hi))
        ref_st = ref_per.per_push_batch(ref_st, _data(lo, hi, True))
        assert_per_equal(st, ref_st, f"push {i}")
        if i == 1:
            idx, pri = np.array([1, 3, 7]), np.array([2.5, 0.3, 4.25], np.float32)
            st = per.per_update_priorities(st, torch.from_numpy(idx), torch.from_numpy(pri))
            ref_st = ref_per.per_update_priorities(ref_st, jnp.asarray(idx), jnp.asarray(pri))
            assert_per_equal(st, ref_st, "update")
    assert st.size == 16 and st.pos == 35 % 16
    assert float(st.tree[16:].min()) == 4.25  # every slot rewritten at the new max
    assert isinstance(st.pos, int) and isinstance(st.size, int)


@pytest.mark.parametrize("filled,beta", [(16, 0.4), (11, 0.7), (64, 1.0)],
                         ids=["partial", "partial_beta_tensor", "full"])
def test_per_sample_matches_reference(filled, beta, rng):
    """Stratified samples from a tree of random priorities: the same leaf
    indices, batch and (rtol 1e-6) IS weights. ``partial`` leaves most of
    the tree empty, so the unfilled-slot guard acts."""
    st, ref_st = _per_pair(64)
    st = per.per_push_batch(st, _data(0, filled))
    ref_st = ref_per.per_push_batch(ref_st, _data(0, filled, True))
    idx = np.arange(filled)
    pri = rng.uniform(0.05, 3.0, filled).astype(np.float32)
    st = per.per_update_priorities(st, torch.from_numpy(idx), torch.from_numpy(pri))
    ref_st = ref_per.per_update_priorities(ref_st, jnp.asarray(idx), jnp.asarray(pri))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        b = torch.tensor(beta) if filled == 11 else beta
        batch, leaf, w = per.per_sample(st, _Uniforms(key), 32, b)
        ref_batch, ref_leaf, ref_w = jax.device_get(ref_per.per_sample(ref_st, key, 32, beta))
        np.testing.assert_array_equal(leaf.numpy(), ref_leaf)
        np.testing.assert_allclose(w.numpy(), ref_w, rtol=WEIGHT_RTOL, atol=0)
        for f in ("x", "a"):
            np.testing.assert_array_equal(getattr(batch, f).numpy(), ref_batch[f])
        assert leaf.max() < filled and float(w.max()) == 1.0


def test_per_update_with_duplicates_and_long_run_match_reference(rng):
    """Rounds of push → sample → update with duplicate indices on a ring
    that wraps: the tree (every node, with the rounding of every past
    delta), max priority, indices and weights stay the reference's."""
    st, ref_st = _per_pair(32)
    dup_idx = np.array([3, 5, 3, 3, 9, 5, 0], np.int64)
    dup_pri = np.array([0.5, 2.0, 7.0, 1.0, 0.25, 3.0, 1.5], np.float32)
    lo = 0
    for r in range(30):
        n = int(rng.integers(1, 9))
        st = per.per_push_batch(st, _data(lo, lo + n))
        ref_st = ref_per.per_push_batch(ref_st, _data(lo, lo + n, True))
        lo += n
        key = jax.random.PRNGKey(100 + r)
        beta = min(1.0, 0.4 + 0.02 * r)
        _, leaf, w = per.per_sample(st, _Uniforms(key), 16, beta)
        _, ref_leaf, ref_w = ref_per.per_sample(ref_st, key, 16, beta)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref_leaf), err_msg=f"round {r}")
        np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=WEIGHT_RTOL)
        # |δ|-style priorities with duplicates among the sampled indices
        pri = rng.uniform(0.0, 1.5, 16).astype(np.float32) ** 0.6
        idx = leaf.numpy()
        if r == 0:  # explicit duplicates
            idx, pri = dup_idx, dup_pri
        st = per.per_update_priorities(st, torch.from_numpy(idx), torch.from_numpy(pri))
        ref_st = ref_per.per_update_priorities(ref_st, jnp.asarray(idx), jnp.asarray(pri))
        assert_per_equal(st, ref_st, f"round {r}")
        if r == 0:  # the first occurrence of each duplicate wins
            assert [float(st.tree[32 + i]) for i in (3, 5)] == [0.5, 2.0]
    assert lo > 32 and st.size == 32


def test_per_state_interop_round_trips():
    st, ref_st = _per_pair(16)
    ref_st = ref_per.per_push_batch(ref_st, _data(0, 20, True))
    ref_st = ref_per.per_update_priorities(ref_st, jnp.asarray([2, 4]), jnp.asarray([3.0, 0.5]))
    ref_np = jax.device_get(ref_st)
    got = interop.replay_from_numpy(ref_np, type(st.data))
    assert isinstance(got, per.PERState)
    assert_per_equal(got, ref_st, "interop")
    back = interop.replay_to_numpy(got)
    np.testing.assert_array_equal(back["tree"], ref_np.tree)
    assert (back["pos"], back["size"], float(back["max_priority"])) == (4, 16, 3.0)


# -- FlappyBird ----------------------------------------------------------------------------
def _assert_flappy_close(sr, ref_sr, where, rows=slice(None)):
    ref = jax.device_get(ref_sr)
    for f in FlappyBirdState._fields:
        got = getattr(sr.state, f).numpy()[rows]
        want = np.asarray(getattr(ref.state, f)).reshape(getattr(sr.state, f).shape)[rows]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=ENV_ATOL, err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{f} {where}")
    np.testing.assert_allclose(sr.obs.numpy()[rows], np.asarray(ref.obs)[rows], rtol=0,
                               atol=ENV_ATOL, err_msg=f"obs {where}")
    np.testing.assert_allclose(sr.reward.numpy()[rows], np.asarray(ref.reward)[rows], rtol=0,
                               atol=ENV_ATOL, err_msg=f"reward {where}")
    for f in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(sr, f).numpy()[rows],
                                      np.asarray(getattr(ref, f))[rows], err_msg=f"{f} {where}")


def _hover_actions(rng, steps, num):
    """Random flaps at about the rate that keeps a bird level (one per 18
    frames), so birds fly past pipes, die on them and on the ground."""
    return (rng.random((steps, num)) < 1.0 / 18.0).astype(np.int32)


def test_flappybird_reset_and_step_match_reference(rng):
    """B=64 birds from the reference's reset draws, stepped 260 times with
    the reference's per-env respawn draws (no autoreset: dead birds keep
    falling and their pipes keep scrolling, so every pipe respawns at
    least twice). Also a state with a pipe about to be passed, one under
    the top edge and one at the time limit."""
    num, steps = 64, 260
    env, params, ref_params = FlappyBird(), FlappyBird().default_params(), _REF_FB.default_params()
    key = jax.random.PRNGKey(3)
    ref_state, ref_obs = jax.jit(_REF_FB.reset_batch, static_argnums=2)(ref_params, key, num)
    keys = FlappyKeys(None)
    state, obs = env.reset_from(params, keys.reset_gaps(key, num))
    keys.env_keys = keys.reset_keys
    np.testing.assert_array_equal(np.asarray(ref_state.key), np.asarray(keys.env_keys))
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=0, atol=ENV_ATOL)

    # special cases in the first rows: a pipe about to be passed with the
    # bird in its gap, a bird at the top, a bird one step from the limit
    ref_state = jax.device_get(ref_state)
    px, gy, y, t = (np.array(ref_state.pipe_x), np.array(ref_state.gap_y),
                    np.array(ref_state.player_y), np.array(ref_state.t))
    px[0, 0], gy[0, 0] = 57.6 - 52.0 + 2.0, y[0] + 12.0
    y[1] = 3.0
    t[2] = 9_999
    ref_state = ref_state._replace(pipe_x=jnp.asarray(px), gap_y=jnp.asarray(gy),
                                   player_y=jnp.asarray(y), t=jnp.asarray(t))
    state = interop.state_from_numpy(ref_state, FlappyBirdState)
    actions = _hover_actions(rng, steps, num)
    actions[0, :3] = (0, 1, 0)
    step = jax.jit(_REF_FB.step_batch)
    seen = {"passed": 0, "died": 0, "top": 0, "respawns": 0}
    for i, a in enumerate(actions):
        ref_sr = step(ref_params, ref_state, jnp.asarray(a), jax.random.PRNGKey(i))
        sr = env.step_from(params, state, torch.from_numpy(a), keys.step_gaps())
        keys.env_keys = keys.stepped
        _assert_flappy_close(sr, ref_sr, f"step {i}")
        r = sr.reward.numpy()
        seen["passed"] += int((sr.state.score - state.score).sum())
        seen["died"] += int(sr.terminated.sum())
        seen["top"] += int(((r % 1.0) > 0.55).sum())  # -0.5 for the top edge
        seen["respawns"] += int((sr.state.gap_y != state.gap_y).any(dim=1).sum())
        if i == 0:
            assert sr.truncated.numpy()[2] and float(r[0]) == pytest.approx(1.1, abs=1e-6)
        ref_state, state = ref_sr.state, sr.state
    assert min(seen.values()) > 0, seen


def test_flappybird_vecenv_autoreset_matches_reference():
    """Mirrors tests/test_flappybird.py:116 on both packages: B=64, 300
    autoresetting steps of random flapping (the same actions), the
    reference's keys replayed per env. Transitions, finished episodes and
    the carried observations agree; birds die and pipes respawn."""
    num, steps = 64, 300
    ref_venv = RefVecEnv(_REF_FB, _REF_FB.default_params(), num)
    actions = _hover_actions(np.random.default_rng(1), steps, num)

    @jax.jit
    def roll(vstate, keys, actions):
        return jax.lax.scan(lambda vs, ka: ref_venv.step(vs, ka[1], ka[0]), vstate, (keys, actions))

    vs0 = ref_venv.reset(jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.PRNGKey(1), steps)
    ref_vs, ref_trs = jax.device_get(roll(vs0, keys, jnp.asarray(actions)))

    venv = make_vec("FlappyBird-v0", num)
    vs = interop.vec_state_from_numpy(jax.device_get(vs0), state_cls=FlappyBirdState)
    noise = FlappyEnvReplay(vs0.env_state.key)
    trs, respawns = [], 0
    for k, a in zip(keys, actions):
        noise.k_step = k
        gap0 = vs.env_state.gap_y
        vs, tr = venv.step(vs, torch.from_numpy(a), noise)
        noise.flappy.after_step(tr.done)
        respawns += int(((vs.env_state.gap_y != gap0).any(dim=1) & ~tr.done).sum())
        trs.append(tr)
    for f in ("obs", "next_obs", "reward"):
        np.testing.assert_allclose(torch.stack([getattr(t, f) for t in trs]).numpy(),
                                   getattr(ref_trs, f), rtol=0, atol=ENV_ATOL, err_msg=f)
    for f in ("action", "terminated", "truncated", "done", "final_length"):
        np.testing.assert_array_equal(torch.stack([getattr(t, f) for t in trs]).numpy(),
                                      getattr(ref_trs, f), err_msg=f)
    np.testing.assert_allclose(torch.stack([t.final_return for t in trs]).numpy(),
                               ref_trs.final_return, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(noise.flappy.env_keys), ref_vs.env_state.key)
    back = interop.vec_state_to_numpy(vs)
    for f in FlappyBirdState._fields:
        np.testing.assert_allclose(back["env_state"][f], getattr(ref_vs.env_state, f), rtol=0,
                                   atol=ENV_ATOL, err_msg=f)
    assert np.asarray(ref_trs.done).sum() > num and respawns > 0


def test_flappybird_registry_and_draws():
    env = make("FlappyBird-v0")
    assert (env.n_actions, env.obs_dim, env.max_steps) == (2, 12, 10_000)
    from gymrl_tpu_torch.core.noise import Noise
    gaps = env.reset_draws(Noise("cpu", 0), 4096)
    assert gaps.shape == (4096, 3)
    assert 102.4 <= float(gaps.min()) and float(gaps.max()) < 297.6 + 1e-4


# -- layers -----------------------------------------------------------------------------------
def _perturbed(variables, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(scale=scale, size=np.shape(p)), jnp.float32),
        variables)


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


LAYER_CASES = {
    "prelu": (lambda: ref_layers.PReLU(), lambda: PReLU(), 12),
    "noisy_dense": (lambda: ref_layers.NoisyDense(24), lambda: NoisyDense(12, 24), 12),
    "mlp_noisy": (lambda: ref_layers.MLP((32, 16, 8), linear="noisy"),
                  lambda: MLP(12, [32, 16, 8], linear="noisy"), 12),
    "mlp_dense_last_act": (lambda: ref_layers.MLP((16, 8), last_act=True),
                           lambda: MLP(12, [16, 8], last_act=True), 12),
    "mlp_dense_deep": (lambda: ref_layers.MLP((32, 16, 8, 4)),
                       lambda: MLP(12, [32, 16, 8, 4]), 12),
    "pscn_noisy": (lambda: ref_layers.PSCN(32, linear="noisy"),
                   lambda: PSCN(12, 32, linear="noisy"), 12),
    "pscn_dense": (lambda: ref_layers.PSCN(16), lambda: PSCN(12, 16), 12),
}


_NOISY_CASES = ("noisy_dense", "mlp_noisy", "pscn_noisy")


@pytest.mark.parametrize("case,mode", [(c, "mu_only") for c in sorted(LAYER_CASES)]
                         + [(c, m) for c in _NOISY_CASES for m in ("shared", "per_row")])
def test_layers_match_flax(case, mode, rng):
    """Outputs, input gradients and parameter gradients against flax, from
    the same (perturbed) params, with the ε flax drew (recorded). Inputs
    include exact zeros, PReLU's kink."""
    make_ref, make_port, in_dim = LAYER_CASES[case]
    ref_mod, mod = make_ref(), make_port()
    assert bool(noisy_layers(mod)) == (case in _NOISY_CASES)
    x = rng.normal(size=(48, in_dim)).astype(np.float32)
    x[:4, :3] = 0.0
    variables = _perturbed(ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    if case == "prelu":
        variables = {"params": {"negative_slope": jnp.asarray(0.3, jnp.float32)}}
    mod.load_state_dict(_flax(variables))
    w = rng.normal(size=(48, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    if mode == "mu_only":
        eps = None

        def ref_f(v, xx):
            kw = {} if case == "prelu" else {"deterministic": True}
            return ref_mod.apply(v, xx, **kw)
    else:
        per_sample = mode == "per_row"
        want_y, eps = record_noise(ref_mod, variables, jnp.asarray(x), key, per_sample)
        assert [tuple(e[0].shape[-1:] + e[1].shape[-1:]) for e in eps] == noisy_layers(mod)
        if per_sample:
            assert all(e[0].shape[0] == 48 for e in eps)

        def ref_f(v, xx):
            return ref_mod.apply(v, xx, per_sample=per_sample, rngs={"noise": key})

    def ref_loss(v, xx):
        return jnp.sum(ref_f(v, xx) * jnp.asarray(w))

    want_y = ref_f(variables, jnp.asarray(x))
    want_gv, want_gx = jax.grad(ref_loss, argnums=(0, 1))(variables, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    if case == "prelu":
        y = mod(xt)
    elif isinstance(mod, NoisyDense):
        y = mod(xt, None if eps is None else eps[0])
    else:
        y = mod(xt, None if eps is None else iter(eps))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    names = [n for n, _ in mod.named_parameters()]
    params = list(mod.parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [xt] + params, allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_gx), rtol=RTOL, atol=ATOL)
    want_g = _flax(want_gv)
    assert set(names) == set(want_g)
    for n, p, g in zip(names, params, grads[1:]):
        g = torch.zeros_like(p) if g is None else g  # σ is unused by the μ-only forward
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), rtol=RTOL, atol=ATOL, err_msg=n)
    # names map both ways, 0-dim PReLU slopes and [in, out] noisy kernels included
    back = interop.params_to_flax(mod.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(variables)):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_noisy_dense_init_and_noise_draws():
    """μ ~ U(±1/√in), σ = 0.5/√fan (as the reference inits them); the
    port's draws have the shapes the layer order asks for, and are scaled
    by sign·√|·|."""
    from gymrl_tpu_torch.core.noise import Noise

    layer = NoisyDense(64, 16, generator=torch.Generator().manual_seed(0))
    mu = layer.kernel_mu.detach()
    assert float(mu.abs().max()) <= 1 / 8 and float(mu.std()) > 0.05
    assert float(layer.kernel_sigma[0, 0].detach()) == pytest.approx(0.5 / 8)
    assert float(layer.bias_sigma[0].detach()) == pytest.approx(0.5 / 4)
    mlp = MLP(12, [32, 16, 2], linear="noisy")
    layers = noisy_layers(mlp)
    assert layers == [(12, 32), (32, 16), (16, 2)]
    noise = Noise("cpu", 0)
    act = noise.noisy_act(layers, 5)
    assert [(a.shape, b.shape) for a, b in act] == [((5, i), (5, o)) for i, o in layers]
    upd = noise.noisy_update(layers, 2)
    assert len(upd) == 2 and [(a.shape, b.shape) for a, b in upd[1]] == [((i,), (o,))
                                                                        for i, o in layers]
    big = noise.noisy_update([(20000, 1)], 1)[0][0][0]
    # sign·√|z| of a standard normal: E|f| = E|z|^½ ≈ 0.8222
    assert abs(float(big.abs().mean()) - 0.8222) < 0.02 and float(big.min()) < 0
