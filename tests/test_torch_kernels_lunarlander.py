"""The LunarLander kernels' build and wrappers on the CPU (no nvcc, no card).

The kernels themselves run only on a CUDA device; ``chip_smoke.py`` phase
18 holds them there against the plain path. Here:
  * the ``-D`` constants the build passes to nvcc equal the module's
    float32 constants as the plain path applies them, bit for bit, and the
    source uses no other;
  * the ctypes signatures match the C launchers in the source;
  * the cache key follows the source, the flags and the constants; a build
    writes through a temporary file and a cached library is not rebuilt;
  * a missing or failing nvcc raises, and never yields the plain result;
  * the wrappers refuse CPU tensors, wrong dtypes and wrong shapes before
    any build;
  * ``step_from`` / ``reset_from`` on the CPU are the plain functions and
    still equal the JAX package on a contact-heavy batch.
"""

import ctypes
import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymrl_tpu_torch import interop, kernels
from gymrl_tpu_torch.envs import lunarlander as ll
from gymrl_tpu_torch.kernels import build
from gymrl_tpu_torch.kernels import lunarlander as kl
from test_torch_lunarlander import (_REF_RESET_BATCH, _REF_STEP_BATCH, _pair,
                                    _ref_rollout_states, assert_state_close,
                                    assert_step_close, jax_reset_draws, jax_step_draws)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32(x) -> int:
    """The bits of x as float32."""
    return int(np.float32(x).view(np.uint32))


def _literal_bits(text: str) -> int:
    m = re.fullmatch(r"\((-?0x[0-9a-f.]+p[+-]\d+)f\)", text)
    assert m, text
    return _f32(float.fromhex(m.group(1)))


def _reciprocal(c):
    return np.float32(1.0 / c)  # what the card multiplies by for tensor / c


EXPECTED = {
    "LL_DT": np.float32(1.0 / 50.0), "LL_INV_FPS": _reciprocal(ll.FPS),
    "LL_INV_SCALE": _reciprocal(30.0), "LL_INV_BODY_MASS": _reciprocal(ll.BODY_MASS),
    "LL_INV_BODY_INERTIA": _reciprocal(ll.BODY_INERTIA),
    "LL_INV_WIND_INERTIA": _reciprocal(ll.WIND_INERTIA), "LL_INV_DX": np.float32(0.5),
    "LL_DT_OVER_MASS": np.float32(ll.DT / ll.BODY_MASS), "LL_COM_Y": np.float32(ll.COM_Y),
    "LL_MAIN_POWER": np.float32(13.0), "LL_SIDE_POWER": np.float32(0.6),
    "LL_SIDE_AWAY": np.float32(12.0), "LL_SIDE_HEIGHT": np.float32(14.0),
    "LL_MAIN_Y": np.float32(4.0 / 30.0), "LL_WIND_FREQ": np.float32(0.02),
    "LL_WIND_FREQ_PI": np.float32(np.pi * 0.01), "LL_WIND_LEVER": np.float32(0.011),
    "LL_CONTACT_FRICTION": np.float32(np.sqrt(0.02)), "LL_BAUMGARTE": np.float32(0.2),
    "LL_LINEAR_SLOP": np.float32(0.005), "LL_MAX_CORRECTION": np.float32(0.2),
    "LL_SLEEP_LIN_TOL": np.float32(0.01), "LL_SLEEP_ANG_TOL": np.float32(2.0 / 180.0 * np.pi),
    "LL_TIME_TO_SLEEP": np.float32(0.5), "LL_X_MAX": np.float32(10 - 1e-6),
    "LL_HELIPAD_Y": np.float32(400.0 / 30.0 / 4.0), "LL_TERRAIN_SMOOTH": np.float32(0.33),
    "LL_MAIN_FUEL": np.float32(0.30), "LL_SIDE_FUEL": np.float32(0.03),
    "LL_SPAWN_X": np.float32(10.0), "LL_SPAWN_Y": np.float32(400.0 / 30.0),
    "LL_OBS_OFF_X": np.float32(10.0), "LL_OBS_OFF_Y": np.float32(400.0 / 30.0 / 4.0 + 18.0 / 30.0),
    "LL_OBS_SCALE_X": np.float32(10.0), "LL_OBS_SCALE_Y": np.float32(400.0 / 30.0 / 2.0),
    "LL_OBS_VEL_SCALE_X": np.float32(10.0), "LL_OBS_VEL_SCALE_Y": np.float32(400.0 / 30.0 / 2.0),
}
EXPECTED.update({f"LL_LEG_X{i}": v for i, v in enumerate(ll.LEG_PTS[:, 0])})
EXPECTED.update({f"LL_LEG_Y{i}": v for i, v in enumerate(ll.LEG_PTS[:, 1])})
EXPECTED.update({f"LL_HULL_X{i}": v for i, v in enumerate(ll.HULL_PTS[:, 0])})
EXPECTED.update({f"LL_HULL_Y{i}": v for i, v in enumerate(ll.HULL_PTS[:, 1])})
INTS = {"LL_CHUNKS": "11", "LL_N_LEG": "4", "LL_N_HULL": "6", "LL_SWEEPS": "10",
        "LL_PAD_MASK": str(0b11111000)}  # helipad chunks 3..7 of 0..11


def test_defines_equal_the_module_float32_constants_bit_for_bit():
    d = kl.defines()
    assert set(d) == set(EXPECTED) | set(INTS)
    for name, want in EXPECTED.items():
        assert _literal_bits(d[name]) == _f32(want), name
    for name, want in INTS.items():
        assert d[name] == want, name
    assert not any("," in v for v in d.values())  # nvcc splits a -D value at commas
    # a division by a Python scalar on the card is a product with the scalar's double
    # reciprocal rounded to float32; for BODY_MASS it differs from the reciprocal of
    # the float32 BODY_MASS
    assert _literal_bits(d["LL_INV_BODY_MASS"]) != _f32(np.float32(1) / np.float32(ll.BODY_MASS))


def test_source_uses_every_define_and_no_other():
    text = open(kl.SOURCE).read()
    used = set(re.findall(r"\bLL_[A-Z0-9_]*[A-Z0-9]\b", text))
    assert used == set(kl.defines())


def _c_params(text: str, fn: str) -> list[str]:
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", text, re.S)
    assert m, fn
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def _ctype(param: str):
    if "*" in param or param.startswith("cudaStream_t"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[param.split()[0]]


@pytest.mark.parametrize("fn,argtypes", [("lander_step_launch", kl.STEP_ARGTYPES),
                                         ("lander_reset_launch", kl.RESET_ARGTYPES)])
def test_ctypes_signatures_match_the_c_launchers(fn, argtypes):
    params = _c_params(open(kl.SOURCE).read(), fn)
    assert [_ctype(p) for p in params] == argtypes


def test_cache_key_follows_source_flags_and_constants(monkeypatch):
    text = open(kl.SOURCE).read()
    flags = (*build.FLAGS, *build.define_flags(kl.defines()))
    key = build.cache_key(text, flags, "nvcc 12.8")
    assert build.cache_key(text, flags, "nvcc 12.8") == key
    assert build.cache_key(text + "\n", flags, "nvcc 12.8") != key
    assert build.cache_key(text, flags[:-1], "nvcc 12.8") != key
    assert build.cache_key(text, (*flags, "-lineinfo"), "nvcc 12.8") != key
    assert build.cache_key(text, flags, "nvcc 12.9") != key
    monkeypatch.setattr(ll, "TERRAIN_SMOOTH", 0.34)
    moved = (*build.FLAGS, *build.define_flags(kl.defines()))
    assert build.cache_key(text, moved, "nvcc 12.8") != key


class FakeNvcc:
    """Stands in for ``build._run``: answers ``--version`` and compiles by
    writing a file at ``-o`` (or fails with a message)."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.compiles = []

    def __call__(self, cmd):
        if cmd[1:] == ["--version"]:
            return subprocess.CompletedProcess(cmd, 0, "Cuda compilation tools, release 12.8", "")
        self.compiles.append(cmd)
        if self.fail:
            return subprocess.CompletedProcess(cmd, 1, "", "lunarlander.cu(1): error: boom")
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("not a library")
        return subprocess.CompletedProcess(cmd, 0, "", "")


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(kl, "_LIB", None)
    monkeypatch.setattr(build, "find_nvcc", lambda: "fake-nvcc")
    return tmp_path / "_build"


def test_build_writes_through_a_temporary_file_and_reuses_the_cache(monkeypatch, fresh_build):
    fake = FakeNvcc()
    monkeypatch.setattr(build, "_run", fake)
    loaded = []
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    path = build.load("lunarlander", kl.SOURCE, kl.defines())
    assert os.listdir(fresh_build) == [os.path.basename(path)]  # no temporary file left
    out = fake.compiles[0][fake.compiles[0].index("-o") + 1]
    assert out != path and os.path.dirname(out) == str(fresh_build)
    assert "-fmad=false" in fake.compiles[0] and "arch=compute_90a,code=sm_90a" in fake.compiles[0]
    monkeypatch.setattr(build, "_LOADED", {})  # a new process: the file is cached
    assert build.load("lunarlander", kl.SOURCE, kl.defines()) == path
    assert len(fake.compiles) == 1 and loaded == [path, path]


def _cpu_batch(num: int = 4, continuous: bool = False):
    env = ll.LunarLander(continuous=continuous)
    params = env.default_params()
    gen = torch.Generator().manual_seed(0)
    draws = ll.ResetDraws(
        height_u=torch.rand((num, ll.CHUNKS + 1), generator=gen) * ll.H / 2,
        force=torch.rand((num, 2), generator=gen) * 2000 - 1000,
        wind_idx=torch.zeros(num, dtype=torch.int32), torque_idx=torch.zeros(num, dtype=torch.int32))
    state, _ = env.reset_from_plain(params, draws)
    state = state._replace(pos=state.pos.contiguous())
    action = (torch.zeros((num, 2)) if continuous else torch.zeros(num, dtype=torch.int32))
    return env, params, draws, state, action, torch.zeros((num, 2))


@pytest.mark.parametrize("fail", [False, True], ids=["nvcc_missing", "nvcc_fails"])
def test_a_failing_compiler_raises_and_never_returns_the_plain_result(monkeypatch, fresh_build,
                                                                      fail):
    if fail:
        monkeypatch.setattr(build, "_run", FakeNvcc(fail=True))
    else:
        monkeypatch.setattr(build, "find_nvcc", lambda: None)
    # route this CPU batch to the kernels, as a CUDA batch is
    monkeypatch.setattr(kl, "_check_device", lambda x, what: None)
    monkeypatch.setattr(ll, "_on_card", lambda x: True)
    env, params, draws, state, action, disp = _cpu_batch()
    before = dict(kernels.LAUNCHES)
    match = "boom" if fail else "nvcc is not on PATH"
    with pytest.raises(build.KernelCompileError, match=match):
        env.step_from(params, state, action, disp)
    with pytest.raises(build.KernelCompileError, match=match):
        env.reset_from(params, draws)
    assert kernels.LAUNCHES == before
    assert not os.path.exists(fresh_build) or os.listdir(fresh_build) == []


def _no_build(*args, **kw):
    raise AssertionError("the wrapper reached the build")


@pytest.mark.parametrize("case", ["cpu_state", "cpu_draws", "float_discrete_action",
                                  "int_continuous_action", "int64_pos", "terrain_shape",
                                  "action_shape", "draws_dtype", "draws_shape"])
def test_wrappers_refuse_bad_inputs_before_any_build(monkeypatch, case):
    monkeypatch.setattr(build, "load", _no_build)
    monkeypatch.setattr(kl, "_LIB", None)
    continuous = case == "int_continuous_action"
    env, params, draws, state, action, disp = _cpu_batch(continuous=continuous)
    if case not in ("cpu_state", "cpu_draws"):  # past the device check, as on the card
        monkeypatch.setattr(kl, "_check_device", lambda x, what: None)
    bad = {
        "float_discrete_action": dict(action=action.float()),
        "int_continuous_action": dict(action=action.int()),
        "int64_pos": dict(state=state._replace(pos=state.pos.long())),
        "terrain_shape": dict(state=state._replace(terrain=state.terrain[:, :-1])),
        "action_shape": dict(action=action[:-1]),
        "draws_dtype": dict(draws=draws._replace(force=draws.force.double())),
        "draws_shape": dict(draws=draws._replace(height_u=draws.height_u[:, :-1])),
    }.get(case, {})
    args = {**dict(state=state, action=action, draws=draws), **bad}
    error = {"cpu_state": ValueError, "cpu_draws": ValueError, "float_discrete_action": TypeError,
             "int_continuous_action": TypeError, "int64_pos": TypeError,
             "draws_dtype": TypeError}.get(case, ValueError)
    with pytest.raises(error):
        if case.startswith("draws") or case == "cpu_draws":
            kl.lander_reset(params, args["draws"])
        else:
            kl.lander_step(params, args["state"], args["action"], disp, continuous=continuous)


def test_int64_discrete_actions_are_cast_for_the_kernel(monkeypatch):
    seen = []
    monkeypatch.setattr(kl, "_check_device", lambda x, what: None)
    monkeypatch.setattr(kl, "_library", lambda: type("Lib", (), {"lander_step_launch": None}))
    monkeypatch.setattr(kl, "_launch", lambda fn, tensors, scalars, device, what: seen.append(
        (tensors, scalars)))
    env, params, draws, state, action, disp = _cpu_batch()
    before = kernels.LAUNCHES["lunarlander_step"]
    kl.lander_step(params, state, action.long(), disp, max_steps=1000)
    (tensors, scalars), = seen
    assert len(tensors) + len(scalars) + 2 == len(kl.STEP_ARGTYPES)  # + device, stream
    assert tensors[11].dtype == torch.int32 and scalars[:4] == [4, 0, 0, 1000]
    assert kernels.LAUNCHES["lunarlander_step"] == before + 1


def test_launch_passes_the_tensors_device_and_its_stream_last(monkeypatch):
    import contextlib
    import types

    entered, seen = [], []
    monkeypatch.setattr(torch.cuda, "device", lambda d: entered.append(d)
                        or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1000 + d.index))
    x = torch.zeros(3)
    kl._launch(lambda *args: seen.append(args) or 0, [x, x], [7, 0.5],
               torch.device("cuda", 3), "lander_step")
    assert entered == [torch.device("cuda", 3)]
    assert seen == [(x.data_ptr(), x.data_ptr(), 7, 0.5, 3, 1003)]
    with pytest.raises(RuntimeError, match="cudaError_t 101"):
        kl._launch(lambda *args: 101, [x], [], torch.device("cuda", 3), "lander_step")


def test_dispatch_sends_card_batches_to_the_kernels(monkeypatch):
    calls = []
    monkeypatch.setattr(ll, "_on_card", lambda x: True)
    monkeypatch.setattr(kl, "lander_step", lambda *a, **kw: calls.append(("step", kw)) or "k")
    monkeypatch.setattr(kl, "lander_reset", lambda *a, **kw: calls.append(("reset", kw)) or "r")
    env, params, draws, state, action, disp = _cpu_batch(continuous=True)
    assert env.step_from(params, state, action, disp) == "k"
    assert env.reset_from(params, draws) == "r"
    assert calls == [("step", {"continuous": True, "max_steps": 1000}), ("reset", {})]


@pytest.mark.parametrize("wind", [False, True])
def test_cpu_step_and_reset_are_the_plain_path_and_match_the_reference(monkeypatch, wind):
    """On the CPU neither wrapper is reached; a contact-heavy batch (80
    random-action steps of the reference) steps and resets as the JAX
    package does."""
    monkeypatch.setattr(kl, "lander_step", _no_build)
    monkeypatch.setattr(kl, "lander_reset", _no_build)
    ref_params, env, params = _pair(wind, 1.0)
    vs = _ref_rollout_states(ref_params, jax.random.PRNGKey(3))
    assert np.asarray(vs.env_state.leg_contact).any(), "want contact states in the batch"
    actions = np.random.default_rng(2).integers(0, 4, 16).astype(np.int32)
    key = jax.random.PRNGKey(13)
    ref_sr = _REF_STEP_BATCH(ref_params, vs.env_state, jnp.asarray(actions), key)
    state = interop.lander_state_from_numpy(jax.device_get(vs.env_state))
    disp = jax_step_draws(key, 16)
    sr = env.step_from(params, state, torch.from_numpy(actions), disp)
    assert_step_close(sr, ref_sr, "step_from on the CPU")
    plain = env.step_from_plain(params, state, torch.from_numpy(actions), disp)
    for got, want in zip((*sr.state, sr.obs, sr.reward, sr.terminated, sr.truncated),
                         (*plain.state, plain.obs, plain.reward, plain.terminated, plain.truncated)):
        assert torch.equal(got, want)

    ref_state, ref_obs = _REF_RESET_BATCH(ref_params, key, 16)
    state, obs = env.reset_from(params, jax_reset_draws(key, 16))
    assert_state_close(state, ref_state, "reset_from on the CPU")
    np.testing.assert_allclose(obs.numpy(), np.asarray(ref_obs), rtol=0, atol=1e-5)


def test_gitignore_lists_the_build_directory():
    lines = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "gymrl_tpu_torch/kernels/_build/" in lines
    assert os.path.relpath(build.BUILD_DIR, REPO) == "gymrl_tpu_torch/kernels/_build"
