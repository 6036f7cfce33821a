"""The port's pixel slice and rendering against the JAX reference: the
rasterizers, ``CartPolePixels`` (and a frame-skipping variant), ``VecEnv``'s
autoreset of a nested state with rank-3 observations, the conv layers and
the rest of the layer zoo against flax, pixel DQN in lockstep with its
uint8 replay, the renderers, ``TrainLoop.test(render=True)``, the CLI,
interop and checkpoints.

Both packages run on the CPU. Weights come from the reference's (perturbed)
init, carried across with ``interop``; the port's noise replays the
reference's key splits (``PixelReplayNoise``).

Tolerances, each with its reason:
  * the rasterizers on the same coordinates: atol 1e-6. Frames of the same
    CartPole states: atol 1e-5. The pixel coordinates reach 48, where a
    float32 ulp is 3.8e-6, and the two frameworks' float32 ``cos`` differ
    by an ulp (6e-8) for some angles, which the 40-px pole turns into
    2.4e-6 px at its tip; coverage changes by 1 per px. Over 4096 random
    states the frames differed by at most 4.05e-6.
  * conv and attention outputs, Q-values, losses: atol 1e-5 / rtol 1e-5
    (sums of thousands of float32 products in another order);
  * params after Adam: ``test_torch_dqn``'s Adam-sign rule and
    ``test_torch_dqn_variants``' tie rule along ``QNet.activation_edges``
    (for the conv trunk: a ReLU tie marks the conv's output channel and the
    consumer's input channel, or every flattened column of that channel);
  * uint8 frames: exact, except one level where the float frame's x·255
    lies within ``QUANT_HALF`` = 255·``FRAME_ATOL`` of a half (such an x
    may round either way in the two frameworks);
  * the renderers' uint8 images and every integer or boolean: exact.
"""

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image, ImageSequence

from gymrl_tpu.algos import dqn_variants as R
from gymrl_tpu.envs import render as ref_render
from gymrl_tpu.envs.cartpole import CartPole as RefCartPole
from gymrl_tpu.envs.frozenlake import FrozenLake as RefFrozenLake
from gymrl_tpu.envs.lunarlander import LunarLander as RefLunarLander
from gymrl_tpu.envs.pixels import CartPolePixels as RefCartPolePixels
from gymrl_tpu.envs.pixels import rasterize_box as ref_box
from gymrl_tpu.envs.pixels import rasterize_segment as ref_segment
from gymrl_tpu.envs.rollout import VecEnv as RefVecEnv
from gymrl_tpu.nn import layers as ref_layers
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos import dqn_variants as V
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs import render
from gymrl_tpu_torch.envs.cartpole import CartPole, CartPoleState
from gymrl_tpu_torch.envs.cliffwalking import CliffWalkingState
from gymrl_tpu_torch.envs.frozenlake import FrozenLakeState
from gymrl_tpu_torch.envs.pixels import CartPolePixels, PixelState, rasterize_box, rasterize_segment
from gymrl_tpu_torch.envs.registry import make
from gymrl_tpu_torch.envs.rollout import VecEnv
from gymrl_tpu_torch.nn import layers as L
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_dqn import ATOL, RTOL, assert_params_close, env_reset_draws
from test_torch_dqn_variants import (
    FamilyGradLog, FamilyLockstep, FamilyReplayNoise, _assert_replay_close, _flax,
)

torch.set_num_threads(1)

RASTER_ATOL = 1e-6
FRAME_ATOL = 1e-5
QUANT_HALF = 255.0 * FRAME_ATOL


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _leaves(state, prefix=""):
    """(path, leaf) of a (nested) NamedTuple."""
    out = []
    for f, x in zip(state._fields, state):
        if isinstance(x, tuple):
            out += _leaves(x, f"{prefix}{f}.")
        else:
            out.append((prefix + f, x))
    return out


def _assert_nested_close(got, want, where, atol=FRAME_ATOL):
    want = dict(_leaves(jax.device_get(want)))
    for path, g in _leaves(got):
        w = np.asarray(want[path])
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=f"{path} {where}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{path} {where}")


def _perturbed(variables, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(scale=scale, size=np.shape(p)), jnp.float32),
        variables)


# -- rasterizers and the pixel env --------------------------------------------------------
def test_rasterizers_match_reference(rng):
    """A batch of segments and boxes at random sub-pixel positions, some off
    the canvas, and the shared (number) form of the box."""
    n, h, w = 64, 24, 32
    seg = rng.uniform(-4.0, 36.0, (4, n)).astype(np.float32)
    box = rng.uniform(-2.0, 30.0, (2, n)).astype(np.float32)
    want = jax.vmap(lambda a, b, c, d: ref_segment(h, w, a, b, c, d, 1.2))(*map(jnp.asarray, seg))
    got = rasterize_segment(h, w, *map(_t, seg), 1.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RASTER_ATOL)
    want = jax.vmap(lambda a, b: ref_box(h, w, a, b, 4.0, 2.5))(*map(jnp.asarray, box))
    got = rasterize_box(h, w, *map(_t, box), 4.0, 2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RASTER_ATOL)
    np.testing.assert_allclose(rasterize_box(h, w, 16.0, 18.0, 16.0, 0.5).numpy(),
                               np.asarray(ref_box(h, w, 16.0, 18.0, 16.0, 0.5)), atol=RASTER_ATOL)
    assert 0.0 < float(got.min() + 1e-3) and float(got.max()) == 1.0


def _cartpole_states(rng, n):
    """Random CartPole states, some about to fail (|θ| near 12°, |x| near
    2.4, moving outward)."""
    u = rng.uniform(-1.0, 1.0, (4, n)).astype(np.float32)
    x, x_dot, theta, theta_dot = u[0] * 2.3, u[1] * 2.0, u[2] * 0.2, u[3] * 2.0
    theta[: n // 4] = np.sign(theta[: n // 4]) * 0.205
    theta_dot[: n // 4] = np.sign(theta[: n // 4]) * 1.5
    x[n // 4: n // 2] = np.sign(x[n // 4: n // 2]) * 2.399
    x_dot[n // 4: n // 2] = np.sign(x[n // 4: n // 2]) * 1.0
    return x, x_dot, theta, theta_dot, np.zeros(n, np.int32)


class RefPixels2(RefCartPolePixels):
    frame_skip = 2


class Pixels2(CartPolePixels):
    frame_skip = 2


@pytest.mark.parametrize("skip", [1, 2])
def test_cartpole_pixels_reset_and_step_match_reference(skip, rng):
    """Reset from the reference's draws, then one step from states carried
    across, frames at 1e-5. ``skip=2`` (a test-only subclass on both
    sides): episodes that end at the first inner step keep the first step's
    state and reward (the ``live`` mask), and the wrapper's own limit
    (t ≥ 250) ORs into ``truncated``, also together with ``terminated``."""
    ref, env = (RefCartPolePixels(), CartPolePixels()) if skip == 1 else (RefPixels2(), Pixels2())
    assert (env.name, env.obs_shape, env.max_steps) == (ref.name, ref.obs_shape, ref.max_steps)
    rp, p = ref.default_params(), env.default_params()
    n = 32
    key = jax.random.PRNGKey(0)
    ref_state, ref_obs = jax.vmap(ref.reset, in_axes=(None, 0))(rp, jax.random.split(key, n))
    state, obs = env.reset_from(p, env_reset_draws(CartPole(), key, n))
    _assert_nested_close(state, ref_state, "reset")
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=0, atol=FRAME_ATOL)
    np.testing.assert_array_equal(obs[..., 0].numpy(), obs[..., 3].numpy())

    x, x_dot, theta, theta_dot, _ = _cartpole_states(rng, n)
    t_inner = np.where(np.arange(n) % 8 == 5, 499, 10).astype(np.int32)
    t_outer = np.where(np.arange(n) % 3 == 0, env.max_steps - 1, 3).astype(np.int32)
    frames = rng.uniform(0.0, 1.0, (n, 48, 48, 4)).astype(np.float32)
    inner = (x, x_dot, theta, theta_dot, t_inner)
    ref_state = ref_state._replace(inner=ref_state.inner._replace(
        **dict(zip(("x", "x_dot", "theta", "theta_dot", "t"), map(jnp.asarray, inner)))),
        frames=jnp.asarray(frames), t=jnp.asarray(t_outer))
    action = rng.integers(0, 2, n).astype(np.int32)
    want = jax.jit(ref.step_batch)(rp, ref_state, jnp.asarray(action), key)
    got = env.step_from(p, PixelState(CartPoleState(*map(_t, inner)), _t(frames), _t(t_outer)),
                        _t(action), env.step_draws(Noise("cpu", 0), n))
    _assert_nested_close(got.state, want.state, "step")
    for f in ("reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.obs[..., :3].numpy(), frames[..., 1:])
    both = got.terminated & got.truncated
    assert got.terminated.any() and both.any() and (~got.terminated & got.truncated).any()
    if skip == 2:  # an early done keeps the first inner step and its reward
        early = got.reward == 1.0
        assert early.any() and (got.reward[~early] == 2.0).all()
        assert (got.state.inner.t[early] == t_inner[early.numpy()] + 1).all()


def test_vec_env_autoresets_cartpole_pixels_against_reference():
    """Faults 1 and 2: rank-3 observations and a nested state. 25 steps of
    B=8 CartPolePixels from near-failing states with the reference's draws:
    every transition and carried state against ``VecEnv.step``'s (frames at
    1e-5), exactly the done rows reset (a fresh frame stack)."""
    b = 8
    ref_venv, venv = RefVecEnv(RefCartPolePixels(), RefCartPolePixels().default_params(), b), \
        VecEnv(CartPolePixels(), CartPolePixels().default_params(), b)
    key = jax.random.PRNGKey(2)
    ref_vs = ref_venv.reset(key)
    gen = np.random.default_rng(3)
    x, x_dot, theta, theta_dot, t = _cartpole_states(gen, b)
    inner = ref_vs.env_state.inner._replace(x=jnp.asarray(x), theta=jnp.asarray(theta),
                                            theta_dot=jnp.asarray(theta_dot))
    ref_vs = ref_vs._replace(env_state=ref_vs.env_state._replace(inner=inner))
    like = venv.reset(Noise("cpu", 0)).env_state
    vs = interop.vec_state_from_numpy(jax.device_get(ref_vs), state_cls=like)
    noise = PixelEnvReplay()
    ref_step = jax.jit(ref_venv.step)
    dones = 0
    for i in range(25):
        a = gen.integers(0, 2, b).astype(np.int32)
        key, k = jax.random.split(key)
        noise.k_step = k
        vs, tr = venv.step(vs, _t(a), noise)
        ref_vs, ref_tr = ref_step(ref_vs, jnp.asarray(a), k)
        _assert_nested_close(tr, ref_tr, f"transition {i}")
        _assert_nested_close(vs, ref_vs, f"carry {i}")
        d = tr.done.numpy()
        assert vs.obs.shape == (b, 48, 48, 4)
        np.testing.assert_array_equal(vs.obs[d][..., 0].numpy(), vs.obs[d][..., 3].numpy())
        np.testing.assert_array_equal(vs.obs[~d].numpy(), tr.next_obs[~d].numpy())
        assert (vs.env_state.t[d] == 0).all() and (vs.ep_length[d] == 0).all()
        dones += int(d.sum())
    assert dones > 0


class PixelEnvReplay:
    """The env part of a replaying noise for a pixel env: ``VecEnv.step``
    splits its key into (step, reset); CartPole's step draws nothing, once
    per skipped frame; the reset draws are the inner CartPole's."""

    k_step = k_reset = None

    def env_step(self, env, num):
        _, self.k_reset = jax.random.split(self.k_step)
        return [None] * env.frame_skip

    def env_reset(self, env, num):
        return env_reset_draws(env.inner, self.k_reset, num)


def test_registry_makes_cartpole_pixels():
    env = make("CartPolePixels-v0")
    assert (env.name, env.obs_shape, env.n_actions, env.max_steps) == (
        "CartPole-v1-pixels", (48, 48, 4), 2, 500)


# -- layers against flax --------------------------------------------------------------------
def _load(module, variables):
    module.load_state_dict(_flax(variables))
    back = interop.params_to_flax(module.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(variables)):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)  # names and layouts map both ways
    return module


def test_conv_encoder_matches_flax(rng):
    """``ConvEncoder`` on [B, H, W, C] and [T, B, H, W, C] from the
    reference's perturbed init; the flatten is 2·2·32 = 128 wide."""
    ref = ref_layers.ConvEncoder(features=64)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 4))), rng, 0.05)
    net = _load(L.ConvEncoder((48, 48, 4), 64), variables)
    assert net.proj.in_features == 128 and net.out_hw == (2, 2)
    apply = jax.jit(ref.apply)
    for shape in ((5, 48, 48, 4), (3, 2, 48, 48, 4)):
        x = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        with torch.no_grad():
            got = net(_t(x)).numpy()
        want = np.asarray(apply(variables, jnp.asarray(x)))
        assert got.shape == shape[:-3] + (64,)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert (got > 0).mean() > 0.2  # the ReLU passes a good share


def test_dsconv_matches_flax(rng):
    ref = ref_layers.DSConv(features=8, strides=(2, 2))
    variables = _perturbed(ref.init(jax.random.PRNGKey(1), jnp.zeros((1, 11, 11, 4))), rng)
    net = _load(L.DSConv(4, 8, strides=(2, 2)), variables)
    x = rng.normal(size=(3, 11, 11, 4)).astype(np.float32)
    with torch.no_grad():
        got = net(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(variables, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    assert got.shape == (3, 5, 5, 8)


def test_noisy_conv_matches_flax_with_the_same_noise(rng):
    """μ-only, and with the ε flax drew (recorded from its ``_scale_noise``
    calls), factorized over (kh·kw·in) × out."""
    ref = ref_layers.NoisyConv2d(features=6, kernel_size=(3, 3), strides=(2, 1))
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    variables = _perturbed(ref.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng, 0.05)
    net = _load(L.NoisyConv2d(4, 6, (3, 3), (2, 1)), variables)
    recorded, orig = [], ref_layers._scale_noise

    def rec(v):
        recorded.append(orig(v))
        return recorded[-1]

    ref_layers._scale_noise = rec
    try:
        want = ref.apply(variables, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(9)})
    finally:
        ref_layers._scale_noise = orig
    eps = tuple(_t(e) for e in recorded)
    assert [e.shape for e in eps] == [(4 * 3 * 3,), (6,)]
    with torch.no_grad():
        np.testing.assert_allclose(net(_t(x), eps).numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            net(_t(x)).numpy(), np.asarray(ref.apply(variables, jnp.asarray(x), deterministic=True)),
            rtol=RTOL, atol=ATOL)


def test_positional_encoding_matches_reference():
    np.testing.assert_array_equal(L.positional_encoding(37, 16).numpy(),
                                  np.asarray(ref_layers.positional_encoding(37, 16)))


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_flax(masked, rng):
    ref = ref_layers.MultiHeadAttention(embed_size=16, num_heads=4)
    v, k, q = (rng.normal(size=(2, n, 16)).astype(np.float32) for n in (5, 5, 3))
    mask = (rng.random((2, 1, 3, 5)) < 0.7).astype(np.int32) if masked else None
    if masked:
        mask[..., 0] = 1  # every query sees one key
    variables = _perturbed(ref.init(jax.random.PRNGKey(3), *map(jnp.asarray, (v, k, q))), rng)
    net = _load(L.MultiHeadAttention(16, 4), variables)
    want = ref.apply(variables, *map(jnp.asarray, (v, k, q)),
                     mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = net(_t(v), _t(k), _t(q), None if mask is None else _t(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mlp_with_layer_norm_matches_flax(rng):
    """``MLP(use_norm=True)``: flax's LayerNorm (eps 1e-6, ``scale``/``bias``)
    before each PReLU, perturbed so the norm's parameters matter."""
    ref = ref_layers.MLP(dims=(8, 8, 3), use_norm=True, last_act=True)
    x = (rng.normal(size=(6, 5)) * 3).astype(np.float32)
    variables = _perturbed(ref.init(jax.random.PRNGKey(4), jnp.asarray(x)), rng)
    net = _load(L.MLP(5, [8, 8, 3], last_act=True, use_norm=True), variables)
    assert net.norm_2.eps == 1e-6
    with torch.no_grad():
        got = net(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(variables, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


# -- pixel DQN ---------------------------------------------------------------------------------
SMALL = dict(num_envs=4, steps_per_iter=8, batch_size=8, memory_capacity=64, updates_per_step=1,
             target_update_freq=8, hidden_dim=32, max_train_steps=2000)


@pytest.fixture(scope="module")
def ref_trainer():
    return R.DQNFamilyTrainer(R.dqn_pixels_config(**SMALL))


class PixelReplayNoise(FamilyReplayNoise):
    """``FamilyReplayNoise`` for a pixel env (see ``PixelEnvReplay``)."""

    def env_step(self, env, num):
        self.calls.append("env_step")
        _, self.k_reset = jax.random.split(self.k_step)
        return [None] * env.frame_skip

    def env_reset(self, env, num):
        self.calls.append("env_reset")
        return env_reset_draws(env.inner, self.k_reset, num)


def _port(rt, jts):
    trainer = V.DQNFamilyTrainer(V.dqn_pixels_config(**SMALL), device="cpu")
    noise = PixelReplayNoise(rt, jts)
    return trainer, interop.train_state_from_reference(trainer, jax.device_get(jts), noise), noise


class QuantLog:
    """Records the float frames the port quantizes, in push order, so a
    uint8 slot that differs from the reference's by one level can be held
    to the rule of the module docstring."""

    def __init__(self, monkeypatch):
        self.frames: list[np.ndarray] = []
        orig = V.quantize_frames

        def logged(x):
            self.frames.append(x.numpy().copy())
            return orig(x)

        monkeypatch.setattr(V, "quantize_frames", logged)

    def shadow(self, replay0_pos, capacity, num_envs):
        """The float frames behind each ring slot written since the log
        began (obs, next_obs), NaN elsewhere."""
        shape = (capacity,) + self.frames[0].shape[1:]
        obs, nxt = np.full(shape, np.nan, np.float32), np.full(shape, np.nan, np.float32)
        pos = replay0_pos
        for o, n in zip(self.frames[0::2], self.frames[1::2]):
            slots = (pos + np.arange(num_envs)) % capacity
            obs[slots], nxt[slots] = o, n
            pos = (pos + num_envs) % capacity
        return obs, nxt


def assert_uint8_close(got: np.ndarray, want: np.ndarray, floats: np.ndarray, where) -> int:
    """Exact, except one level where ``floats``·255 lies within QUANT_HALF of
    a half (NaN floats: exact). Returns the count of such entries."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    x = floats.astype(np.float64) * 255.0
    near_half = np.abs(x - np.floor(x) - 0.5) < QUANT_HALF
    off = diff != 0
    assert not (off & ~(near_half & (np.abs(diff) == 1))).any(), (
        f"{where}: {int(off.sum())} uint8 entries differ, "
        f"{int((off & ~near_half).sum())} away from a half")
    return int(off.sum())


def test_qnet_conv_matches_flax_and_names_its_edges(ref_trainer, rng):
    rt = ref_trainer
    trainer = V.DQNFamilyTrainer(V.dqn_pixels_config(**SMALL), device="cpu")
    variables = _perturbed(rt.net.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 4))), rng,
                           0.05)
    net = _load(trainer.make_net(), variables)
    x = rng.uniform(0.0, 1.0, (8, 48, 48, 4)).astype(np.float32)
    with torch.no_grad():
        got = net(_t(x)).numpy()
    want = jax.jit(lambda v, x: rt.net.apply(v, x, deterministic=True))(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    modules = dict(net.named_modules())
    width = {n: getattr(m, "out_channels", getattr(m, "out_features", None))
             for n, m in modules.items()}
    fan = {n: getattr(m, "in_channels", getattr(m, "in_features", None))
           for n, m in modules.items()}
    columns = set()
    for producer, consumer, lo, hi, off in net.activation_edges():
        assert 0 <= lo < hi <= width[producer]
        assert 0 <= lo + off and hi + off <= fan[consumer]
        if consumer == "conv.proj":
            columns |= set(range(lo + off, hi + off))
    assert columns == set(range(128))  # every flattened column has its channel


def test_train_iters_match_reference(ref_trainer, monkeypatch):
    """Two iterations after three reference iterations (the 64-slot ring has
    wrapped, episodes end), each from the reference's state with its draws
    replayed: every act (exact) and update (loss, params under the rules,
    Adam count) held by ``FamilyLockstep``; at the end the nets, the env
    batch, the episode stats and the uint8 ring under the quantization rule."""
    rt = ref_trainer
    cfg = rt.cfg
    jts = rt.init(jax.random.PRNGKey(0))
    for _ in range(3):
        jts, _ = rt.train_iter(jts)
    assert int(jts.env_steps) > cfg.memory_capacity
    done = checked = 0
    quant = QuantLog(monkeypatch)
    for it in range(2):
        trainer, ts, noise = _port(rt, jts)
        lockstep = FamilyLockstep(rt, trainer, FamilyGradLog(ts.params, ts.opt_state))
        quant.frames.clear()
        pos0 = ts.replay.pos
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"iteration {it}"
        ref = jax.device_get(jts)
        assert (ts.env_steps, ts.learn_steps) == (int(ref.env_steps), int(ref.learn_steps))
        assert int(ts.episodes) == int(ref.episodes) and int(ts.target_syncs) == int(ref.target_syncs)
        for net, want in (("params", ref.params), ("target_params", ref.target_params)):
            assert_params_close(getattr(ts, net).state_dict(), _flax(want), cfg.lr,
                                lockstep.log.counts, f"{net} {where}")
        _assert_nested_close(ts.vec_state, ref.vec_state, where)
        for f in ("ep_done", "ep_length", "ep_return"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                          err_msg=f"{f} {where}")
        np.testing.assert_allclose(float(out.metrics["loss"]), float(jout.metrics["loss"]),
                                   rtol=RTOL, atol=ATOL)
        replay, ref_replay = ts.replay, ref.replay
        obs_f, next_f = quant.shadow(pos0, cfg.memory_capacity, cfg.num_envs)
        for f, floats in (("obs", obs_f), ("next_obs", next_f)):
            got, want = getattr(replay.data, f).numpy(), np.asarray(getattr(ref_replay.data, f))
            assert got.dtype == want.dtype == np.uint8
            assert_uint8_close(got, want, floats, f"replay {f} {where}")
        stripped = lambda r: r._replace(data=r.data._replace(obs=r.data.obs[:0],
                                                             next_obs=r.data.next_obs[:0]))
        _assert_replay_close(stripped(replay), stripped(ref_replay), where)
        done += int(np.asarray(jout.ep_done).sum())
        checked += lockstep.updates
        assert lockstep.acts == cfg.steps_per_iter
    assert checked == 2 * cfg.steps_per_iter * cfg.n_updates and done > 0


def test_uint8_round_trip_matches_reference(rng):
    """Frames rendered by both packages from the same 256 CartPole states
    quantize to the same levels under the rule, and dequantize (``/255``)
    to the same floats, within half a level of the frame."""
    ref, env = RefCartPolePixels(), CartPolePixels()
    x, x_dot, theta, theta_dot, t = _cartpole_states(rng, 256)
    rp = ref.default_params()
    one = RefCartPole().reset(rp, jax.random.PRNGKey(0))[0]
    ref_frames = jax.vmap(lambda x, th: ref.render(rp, one._replace(x=x, theta=th)))(
        jnp.asarray(x), jnp.asarray(theta))
    frames = env.render(env.default_params(), CartPoleState(*map(_t, (x, x_dot, theta,
                                                                     theta_dot, t))))
    want = np.asarray(jnp.clip(jnp.round(ref_frames * 255.0), 0.0, 255.0).astype(jnp.uint8))
    got = V.quantize_frames(frames)
    assert got.dtype == torch.uint8
    assert_uint8_close(got.numpy(), want, frames.numpy(), "quantize")
    back = got.float() / 255.0
    np.testing.assert_array_equal(back.numpy(), want.astype(np.float32) / 255.0)
    assert float((back - frames).abs().max()) <= 0.5 / 255.0 + 1e-7
    assert V.quantize_frames(torch.tensor([-0.5, 0.5 / 255, 1.5 / 255, 2.0])).tolist() == [
        0, 0, 2, 255]  # clamped, and halves round to even as jnp.round does


def test_train_state_interop_and_checkpoint_round_trip(ref_trainer, tmp_path):
    """A reference pixel state carried across to the bit (HWIO conv kernels
    into OIHW weights, the nested ``PixelState``, the uint8 ring); a strict
    checkpoint round trip that leaves the replay out and restores it fresh,
    as the reference does, after which the next iteration from the same
    fresh replay is the same."""
    rt = ref_trainer
    jts = jax.device_get(rt.train_iter(rt.init(jax.random.PRNGKey(0)))[0])
    trainer, ts, _ = _port(rt, jts)
    got, want = ts.params.state_dict(), _flax(jts.params)
    assert set(got) == set(want) and got["conv.conv_0.weight"].shape == (16, 4, 8, 8)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    back = interop.vec_state_to_numpy(ts.vec_state)
    np.testing.assert_array_equal(back["env_state"]["frames"], jts.vec_state.env_state.frames)
    np.testing.assert_array_equal(back["env_state"]["inner"]["theta"],
                                  jts.vec_state.env_state.inner.theta)
    np.testing.assert_array_equal(ts.replay.data.obs.numpy(), jts.replay.data.obs)

    ts = ts._replace(noise=Noise("cpu", 5))
    path = save_checkpoint(str(tmp_path / "pixels.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    fresh = trainer.init(1).replay
    assert torch.load(path, weights_only=True)["replay"] is None and ts.replay.size > 0
    assert restored.replay.data.obs.dtype == torch.uint8 and restored.replay.size == 0
    torch.testing.assert_close(restored.replay.data.obs, fresh.data.obs, rtol=0, atol=0)
    assert isinstance(restored.vec_state.env_state, PixelState)
    ts, out = trainer.train_iter(ts._replace(replay=fresh))
    restored, out_r = trainer.train_iter(restored)
    for k, v in ts.params.state_dict().items():
        torch.testing.assert_close(restored.params.state_dict()[k], v, rtol=0, atol=0)
    torch.testing.assert_close(restored.replay.data.obs, ts.replay.data.obs, rtol=0, atol=0)
    with pytest.raises(ValueError, match="params"):
        restore_checkpoint(path, V.DQNFamilyTrainer(
            V.dqn_pixels_config(**{**SMALL, "hidden_dim": 16}), device="cpu").init(0))
    # a replay of another capacity is no mismatch: the example's fresh one is kept
    smaller = restore_checkpoint(path, V.DQNFamilyTrainer(
        V.dqn_pixels_config(**{**SMALL, "memory_capacity": 32}), device="cpu").init(0))
    assert smaller.replay.data.obs.shape[0] == 32 and smaller.replay.size == 0


def test_cli_workload_trains_in_train_loop_on_cpu(tmp_path, monkeypatch):
    """``dqn_cartpole_pixels``: the reference CLI's trainer, config and solve
    bar; a small config of it trains two iterations in TrainLoop."""
    monkeypatch.chdir(tmp_path)
    trainer, algo, solve = cli.WORKLOADS["dqn_cartpole_pixels"]("cpu")
    ref_trainer, ref_algo, ref_solve = ref_cli.WORKLOADS["dqn_cartpole_pixels"]()
    assert (algo, solve) == (ref_algo, ref_solve) == ("DQN_Pixels", 495.0)
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(ref_trainer.cfg)
    small = type(trainer)(dataclasses.replace(trainer.cfg, **SMALL), device="cpu")
    loop = TrainLoop(small, algo, log_metrics=False, log_every=1, eval_every=10 ** 9,
                     save_every=10 ** 9, eval_episodes=1)
    ts, stats = loop.train(64, solve_threshold=solve)
    assert stats["env_steps"] == ts.env_steps == 64 and ts.learn_steps == 15
    assert ts.replay.data.obs.dtype == torch.uint8 and ts.replay.size == 64
    assert (tmp_path / "checkpoints" / "DQN_Pixels_CartPole-v1-pixels.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


# -- rendering ---------------------------------------------------------------------------------
def _row0(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[0], jax.device_get(tree))


def test_renderers_match_reference():
    """Each renderer draws the reference's uint8 image from a state carried
    across: CartPole and the lander after some steps, FrozenLake and
    CliffWalking at several cells."""
    key = jax.random.PRNGKey(0)
    lander = RefLunarLander()
    vs = RefVecEnv(lander, lander.default_params(), 2).reset(key)
    step = jax.jit(RefVecEnv(lander, lander.default_params(), 2).step)
    for i in range(40):
        vs, _ = step(vs, jnp.asarray([2, 1], jnp.int32), jax.random.PRNGKey(i))
    state = interop.lander_state_from_numpy(jax.device_get(vs.env_state))
    np.testing.assert_array_equal(render.render_lunarlander(render.state_row(state)),
                                  ref_render.render_lunarlander(_row0(vs.env_state)))
    cp = RefCartPole()
    cs = cp.reset(cp.default_params(), key)[0]._replace(x=jnp.float32(1.3), theta=jnp.float32(-0.15))
    batched = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jax.device_get(cs))
    port = interop.state_from_numpy(batched, CartPoleState)
    np.testing.assert_array_equal(render.render_cartpole(render.state_row(port)),
                                  ref_render.render_cartpole(jax.device_get(cs)))
    for pos in (0, 5, 15, 36, 40, 47):
        grid = FrozenLakeState(torch.tensor([pos % 16]), torch.tensor([0]))
        want_fl = ref_render.render_frozenlake(RefFrozenLake().reset(None, key)[0]._replace(
            pos=np.int32(pos % 16)))
        np.testing.assert_array_equal(render.render_frozenlake(render.state_row(grid)), want_fl)
        cw = CliffWalkingState(torch.tensor([pos]), torch.tensor([0]))
        np.testing.assert_array_equal(render.render_cliffwalking(render.state_row(cw)),
                                      ref_render.render_cliffwalking(_Pos(pos)))
    assert render.render(make("CartPolePixels-v0"), None) is None
    assert set(render.RENDERERS) == set(ref_render.RENDERERS)


class _Pos(NamedTuple):
    pos: np.int32


def _gif_frames(path) -> tuple[int, tuple]:
    """(frames, size) of a GIF: PIL merges identical consecutive frames and
    adds their durations, so the count is the total duration over 20 ms."""
    with Image.open(path) as im:
        total = sum(frame.info["duration"] for frame in ImageSequence.Iterator(im))
        return total // 20, im.size


def test_test_with_render_writes_the_episode_gif(tmp_path, monkeypatch):
    """``TrainLoop.test(ts, render=True)`` writes
    ``./exp/renders/{algo}_{env}.gif`` with one frame per step plus the
    reset's, for the episode ``eval_episodes`` plays from the same seed:
    FrozenLake (Q-learning), and recurrent PPO on the lander, whose GRU
    hidden is threaded from step to step."""
    from gymrl_tpu_torch.algos.ppo_rnn import PPORNNTrainer, ppo_rnn_lunarlander_config
    from gymrl_tpu_torch.algos.tabular import QLearningTrainer, qlearning_frozenlake_config

    monkeypatch.chdir(tmp_path)
    for trainer, algo, size in (
        (QLearningTrainer(qlearning_frozenlake_config(), device="cpu"), "QLearning", (192, 192)),
        (PPORNNTrainer(ppo_rnn_lunarlander_config(), device="cpu"), "PPO_RNN", (600, 400)),
    ):
        ts = trainer.init(0)
        _, tested = trainer.eval_episodes(ts, Noise("cpu", 1234), 1)  # test()'s evaluation
        _, length = trainer.eval_episodes(ts, Noise("cpu", 0), 1)  # the rendered episode
        carries = []
        policy_step = trainer.policy_step

        def logged(ts, carry, obs, noise, deterministic=True):
            out = policy_step(ts, carry, obs, noise, deterministic)
            carries.append((carry, out[0]))
            return out

        trainer.policy_step = logged
        loop = TrainLoop(trainer, algo, log_metrics=False)
        assert np.isfinite(loop.test(ts, episodes=1, render=True))
        path = tmp_path / "exp" / "renders" / f"{algo}_{trainer.venv.env.name}.gif"
        assert _gif_frames(path) == (int(length[0]) + 1, size)
        steps = carries[int(tested[0]):]
        if algo == "PPO_RNN":
            assert float(steps[0][0].abs().max()) == 0.0
            assert all(a[0] is b[1] for a, b in zip(steps[1:], steps))
            assert float(steps[-1][1].abs().max()) > 0.0
        assert len(steps) == int(length[0])
