"""The port's core numerics, initializers, Dense, interop, trainer helpers,
logging and package rules, held against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance for the numerics: atol 1e-6 + rtol 1e-6. Inputs are float32 of
O(1) and results reach O(10); XLA on the CPU fuses ``a*b + c`` into one
rounding where PyTorch rounds twice, and the two sum in different orders,
so results agree to a few float32 steps, not bitwise.
"""

import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu import core as ref_core
from gymrl_tpu.core.gae import standardize as ref_standardize
from gymrl_tpu.nn import initializers as ref_init
from gymrl_tpu.nn.layers import Dense as RefDense
from gymrl_tpu.algos.base import masked_mean as ref_masked_mean
from gymrl_tpu_torch import core, interop
from gymrl_tpu_torch.algos.base import masked_mean
from gymrl_tpu_torch.utils.logging import MetricsWriter, log_monitors
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.layers import Dense

torch.set_num_threads(1)

ATOL = 1e-6
RTOL = 1e-6
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x)


def _gae_inputs(rng, shape):
    r, v, nv = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    dw = (rng.random(shape) < 0.1).astype(np.float32)
    done = np.clip(dw + (rng.random(shape) < 0.05), 0, 1).astype(np.float32)
    return r, v, nv, dw, done


# -- GAE ----------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64,), (32, 5)], ids=["T", "TxB"])
def test_compute_gae_matches_reference(rng, shape):
    inputs = _gae_inputs(rng, shape)
    adv, vt = core.compute_gae(*map(torch.from_numpy, inputs), 0.99, 0.95)
    ref_adv, ref_vt = ref_core.compute_gae(*map(jnp.asarray, inputs), 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), _np(ref_adv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), _np(ref_vt), rtol=RTOL, atol=ATOL)


def test_compute_gae_accepts_bool_flags(rng):
    r, v, nv, dw, done = _gae_inputs(rng, (16, 3))
    a, _ = core.compute_gae(*map(torch.from_numpy, (r, v, nv)), torch.from_numpy(dw > 0),
                            torch.from_numpy(done > 0), 0.99, 0.95)
    b, _ = core.compute_gae(*map(torch.from_numpy, (r, v, nv, dw, done)), 0.99, 0.95)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dual_lambda_gae_matches_reference(rng):
    inputs = _gae_inputs(rng, (40, 4))
    adv, ret = core.compute_gae_dual_lambda(*map(torch.from_numpy, inputs), 0.99, 0.9, 0.95)
    ref_adv, ref_ret = ref_core.compute_gae_dual_lambda(*map(jnp.asarray, inputs), 0.99, 0.9, 0.95)
    np.testing.assert_allclose(adv.numpy(), _np(ref_adv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ret.numpy(), _np(ref_ret), rtol=RTOL, atol=ATOL)


def test_standardize_uses_population_std(rng):
    x = (rng.normal(size=(16, 8)) * 5 + 3).astype(np.float32)
    out = core.standardize(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _np(ref_standardize(jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    # ddof=0: the sample std (ddof=1) would give a std of sqrt((n-1)/n) here
    assert abs(float(out.std(correction=0)) - 1.0) < 1e-5


# -- running statistics --------------------------------------------------------------
def test_rms_update_single_samples_match_reference(rng):
    """One sample at a time, including the n==1 quirk (std = x)."""
    rms, ref = core.rms_init((3,)), ref_core.rms_init((3,))
    for i in range(10):
        x = rng.normal(size=3).astype(np.float32)
        rms = core.rms_update(rms, torch.from_numpy(x))
        ref = ref_core.rms_update(ref, jnp.asarray(x))
        for f in ref._fields:
            np.testing.assert_allclose(getattr(rms, f).numpy(), _np(getattr(ref, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{f} at sample {i}")
        if i == 0:
            np.testing.assert_array_equal(rms.std.numpy(), x)


def test_rms_update_batch_matches_reference(rng):
    """Chan merge, first-batch branch included."""
    rms, ref = core.rms_init((4,)), ref_core.rms_init((4,))
    for i in range(6):
        xb = (rng.normal(size=(32, 4)) * 3 + 2).astype(np.float32)
        rms = core.rms_update_batch(rms, torch.from_numpy(xb))
        ref = ref_core.rms_update_batch(ref, jnp.asarray(xb))
        for f in ref._fields:
            np.testing.assert_allclose(getattr(rms, f).numpy(), _np(getattr(ref, f)),
                                       rtol=1e-6, atol=1e-5, err_msg=f"{f} after batch {i}")
    obs = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(core.normalize_obs(rms, torch.from_numpy(obs)).numpy(),
                               _np(ref_core.normalize_obs(ref, jnp.asarray(obs))),
                               rtol=RTOL, atol=ATOL)


def test_reward_scaler_matches_reference(rng):
    scaler = core.reward_scaler_init(num_envs=8, gamma=0.9)
    ref = ref_core.reward_scaler_init(num_envs=8, gamma=0.9)
    for i in range(30):
        r = rng.normal(size=8).astype(np.float32)
        scaler, scaled = core.reward_scaler_step(scaler, torch.from_numpy(r))
        ref, ref_scaled = ref_core.reward_scaler_step(ref, jnp.asarray(r))
        np.testing.assert_allclose(scaler.ret.numpy(), _np(ref.ret), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(scaled.numpy(), _np(ref_scaled), rtol=1e-5, atol=ATOL,
                                   err_msg=f"step {i}")
    done = np.zeros(8, bool)
    done[::2] = True
    scaler = core.reward_scaler_reset(scaler, torch.from_numpy(done))
    ref = ref_core.reward_scaler_reset(ref, jnp.asarray(done))
    np.testing.assert_array_equal(scaler.ret.numpy(), _np(ref.ret))


# -- initializers and Dense ----------------------------------------------------------
@pytest.mark.parametrize("gain", [float(np.sqrt(2.0)), 0.01, 1.0])
@pytest.mark.parametrize("shape", [(8, 256), (256, 256), (256, 4)], ids=["in8", "sq", "out4"])
def test_orthogonal_init_matches_reference_distribution(shape, gain):
    """Flax kernel [in, out] and torch weight [out, in] = kernel.T are both
    scaled orthogonal: W·Wᵀ or Wᵀ·W (the smaller side) is gain²·I."""
    w = torch.empty(shape[1], shape[0])
    gl_init.orthogonal(gain)(w, torch.Generator().manual_seed(0))
    k = _np(ref_init.orthogonal(gain)(jax.random.PRNGKey(0), shape))
    small = min(shape)
    gram = (w @ w.T if w.shape[0] == small else w.T @ w).numpy()
    ref_gram = k.T @ k if k.shape[1] == small else k @ k.T
    np.testing.assert_allclose(gram, gain ** 2 * np.eye(small), atol=1e-5 * max(gain ** 2, 1))
    np.testing.assert_allclose(ref_gram, gain ** 2 * np.eye(small), atol=1e-5 * max(gain ** 2, 1))


@pytest.mark.parametrize("name", ["kaiming", "xavier"])
def test_uniform_inits_match_reference_distribution(name):
    """Same bound (fan_in over the ``in`` axis) and the same spread."""
    shape = (64, 512)  # flax [in, out]
    w = torch.empty(shape[1], shape[0])
    gl_init.INITS[name](w, torch.Generator().manual_seed(0))
    k = _np(ref_init.INITS[name](jax.random.PRNGKey(0), shape))
    bound = np.sqrt(2.0 / (1.0 + 0.01 ** 2)) * np.sqrt(3.0 / 64) if name == "kaiming" \
        else np.sqrt(6.0 / (64 + 512))
    for x in (w.numpy(), k):
        assert np.abs(x).max() <= bound * (1 + 1e-6)
        assert abs(x.std() - bound / np.sqrt(3.0)) < 0.02 * bound  # std of U(-b, b)


def test_dense_matches_flax_dense(rng):
    x = rng.normal(size=(5, 8)).astype(np.float32)
    ref = RefDense(16, kernel_init=ref_init.orthogonal())
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape), jnp.float32), variables)  # nonzero bias
    layer = Dense(8, 16, gl_init.orthogonal(), generator=torch.Generator().manual_seed(0))
    assert torch.all(layer.bias == 0)
    state = interop.params_from_flax({"params": {"d": variables["params"]}})
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               _np(ref.apply(variables, jnp.asarray(x))), rtol=1e-6, atol=1e-5)


def test_dense_init_leaves_global_rng_alone():
    before = torch.random.get_rng_state()
    Dense(4, 4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(before, torch.random.get_rng_state())


def test_params_interop_round_trip(rng):
    tree = {"params": {"a": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                             "bias": rng.normal(size=5).astype(np.float32)}}}
    state = interop.params_from_flax(tree)
    assert state["a.weight"].shape == (5, 3)
    back = interop.params_to_flax(state)
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(back["params"]["a"][leaf], tree["params"]["a"][leaf])


# -- trainer helpers and logging ---------------------------------------------------------
def test_masked_mean_matches_reference(rng):
    x = rng.normal(size=(6, 5)).astype(np.float32)
    mask = rng.random((6, 5)) < 0.4
    got = masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref_masked_mean(jnp.asarray(x), jnp.asarray(mask))),
                               rtol=RTOL, atol=ATOL)
    assert float(masked_mean(torch.ones(3), torch.zeros(3, dtype=torch.bool))) == 0.0


class _Scalars:
    def __init__(self):
        self.rows = []

    def add_scalar(self, key, value, step):
        self.rows.append((key, value, step))


def test_log_monitors_skips_nan_and_disabled_writer_is_a_no_op(tmp_path):
    writer = _Scalars()
    log_monitors(writer, {"a": 1.5, "b": float("nan"), "c": torch.tensor(2.0)}, 7)
    assert writer.rows == [("a", 1.5, 7), ("c", 2.0, 7)]
    off = MetricsWriter("PPO", "LunarLander-v3", enabled=False, root=str(tmp_path))
    off.log({"a": 1.0}, 1)
    off.close()
    assert not any(tmp_path.iterdir())


# -- noise -------------------------------------------------------------------------------
def test_noise_draws_are_reproducible_and_in_range():
    a, b = Noise("cpu", 3), Noise("cpu", 3)
    g = a.gumbel((4096, 4))
    torch.testing.assert_close(g, b.gumbel((4096, 4)))
    assert abs(float(g.mean()) - 0.5772) < 0.05  # Euler–Mascheroni: mean of Gumbel(0, 1)
    perms = a.permutations(3, 50)
    assert perms.shape == (3, 50)
    assert all(torch.equal(p.sort().values, torch.arange(50)) for p in perms)
    idx = a.randint(-9999, 9999, (1000,))
    assert idx.dtype == torch.int32 and int(idx.min()) >= -9999 and int(idx.max()) < 9999
    u = a.uniform((1000,), -2.0, 3.0)
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    state = a.state_dict()
    x = a.uniform((3,))
    a.load_state_dict(state)
    torch.testing.assert_close(a.uniform((3,)), x)


# -- package rules -------------------------------------------------------------------------
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gymrl_tpu"}


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_family_and_nothing_of_gymrl_tpu():
    files = sorted((ROOT / "gymrl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & _FORBIDDEN) for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_default_device_without_cuda_raises():
    """Entry points default to cuda and never fall back to the CPU silently."""
    from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
    from gymrl_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOTrainer(PPOConfig(num_envs=2, rollout_steps=2, minibatch_size=4))
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
