"""The Hopper redesign of ``ppo_loss_bwd`` (``kernels/ppo.cu``) and
``lander_reset`` (``kernels/lunarlander.cu``) on the CPU: what their
wrappers decide and hand to the C launchers (no nvcc, no card).

The kernels themselves run only on a CUDA device; ``chip_smoke.py`` phases
18 and 19 hold them there against the plain versions. Here a stand-in
library records each launch's arguments by the C parameter names:
  * ``PPOHeadLoss.backward`` launches with the addresses, sizes, strides,
    ``packed`` flag and scalars its forward computed, and checks nothing
    again; the public ``ppo_loss_bwd`` still refuses a wrong input;
  * the backward's ``packed`` flag is ``columns_packed``'s, and its
    row-vector flag is set exactly where A is its own padded width P (a
    power of two, at least 2) and both rows lie on 4·P bytes;
  * the backward has its own block size, and the forward's stays;
  * the reset's outputs keep their shapes, dtypes and contiguity while they
    share three buffers, overlap nowhere, and lie where the kernel's vector
    stores need them; its grid gives every env one thread;
  * the lander's launches enter PyTorch's device context only when the card
    is not current; the changed launchers bind by ctypes.
"""

import contextlib
import re
import types

import pytest
import torch

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos.ppo import PPOConfig
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs.lunarlander import CHUNKS, LunarLander
from gymrl_tpu_torch.kernels import build
from gymrl_tpu_torch.kernels import lunarlander as kl
from gymrl_tpu_torch.kernels import ppo as kp
from test_torch_kernels_lunarlander import _c_params, _ctype
from test_torch_kernels_ppo_hopper import RecordingLib, _cols, _layout, _packed_rows

torch.set_num_threads(1)

PPO_SOURCE = open(kp.SOURCE).read()
LANDER_SOURCE = open(kl.SOURCE).read()
HEAD_ARGS = ("logits", "values", "action", "logp_old", "adv", "ret", "n", "n_actions",
             "s_action", "s_logp", "s_adv", "s_ret", "packed", "lo", "hi", "dual_clip",
             "value_coef", "entropy_coef", "inv_n")


@pytest.fixture
def lib(monkeypatch):
    """The loss wrappers on CPU tensors, as on the card: the stand-in
    library, PyTorch's CUDA calls stood in, and every cache empty."""
    fake = RecordingLib()
    monkeypatch.setattr(kp, "_library", lambda: fake)
    monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    monkeypatch.setattr(kp, "_TICKETS", {})
    monkeypatch.setattr(kp, "_HEAD_SCALARS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return fake


def _padded(a: int) -> int:
    return 1 << (a - 1).bit_length()  # the kernel's P: PyTorch's warp softmax width


def _aligned_views(shape, offset: int, align: int = 128):
    """A view of ``shape`` floats ``offset`` floats past an ``align``-byte
    boundary of a buffer of its own."""
    n = shape[0] * shape[1]
    buf = torch.randn(n + offset + align // 4)
    base = (-(buf.data_ptr() // 4)) % (align // 4)
    view = buf[base + offset:base + offset + n].view(shape)
    assert (view.data_ptr() - 4 * offset) % align == 0
    return view


# -- the backward's launch ---------------------------------------------------------------
@pytest.mark.parametrize("case", ["obs4", "obs8", "spread", "reordered", "unequal_strides",
                                  "stride_off_16_bytes", "base_off_16_bytes"])
def test_backward_launches_with_what_the_forward_computed(lib, monkeypatch, case):
    cols, packed = _layout(case, n=40)
    logits, values, _ = _packed_rows(40, 8)
    lg, v = logits.clone().requires_grad_(True), values.clone().requires_grad_(True)
    calls = {"_head_args": 0, "_expect": 0}
    for name in calls:
        real = getattr(kp, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(kp, name, counted)
    loss, _ = kp.PPOHeadLoss.apply(lg, v, *cols, PPOConfig(clip_eps=0.1))
    after_forward = dict(calls)
    before = kernels.LAUNCHES["ppo_loss_bwd"]
    loss.backward()
    assert calls == after_forward and after_forward["_head_args"] == 1  # nothing checked again
    assert kernels.LAUNCHES["ppo_loss_bwd"] == before + 1
    fwd, bwd = lib.calls
    assert (fwd["fn"], bwd["fn"]) == ("ppo_loss_fwd_launch", "ppo_loss_bwd_launch")
    assert [bwd[k] for k in HEAD_ARGS] == [fwd[k] for k in HEAD_ARGS]
    assert bwd["packed"] == int(packed) == int(kp.columns_packed(*cols))
    assert [bwd[k] for k in ("logits", "values", "action", "logp_old", "adv", "ret")] == [
        x.data_ptr() for x in (lg, v, *cols)]
    assert [bwd[k] for k in ("s_action", "s_logp", "s_adv", "s_ret")] == [
        c.stride(0) for c in cols]
    assert bwd["n"] == 40 and bwd["n_actions"] == 4
    assert bwd["inv_n"] == pytest.approx(1 / 40, rel=1e-7) and bwd["lo"] == pytest.approx(0.9)


@pytest.mark.parametrize("d", [4, 8])
def test_backward_takes_the_float4_columns_of_a_packed_minibatch(lib, d):
    logits, values, rows = _packed_rows(64, d)
    for offset_rows in (rows, _aligned_views(rows.shape, 1), _aligned_views(rows.shape, 2)):
        offset_rows.copy_(rows)
        cols = _cols(offset_rows, d)
        kp.ppo_loss_bwd(logits, values, *cols, torch.ones(()), PPOConfig())
        assert lib.calls[-1]["packed"] == int(offset_rows.data_ptr() % 16 == 0)
    assert [c["packed"] for c in lib.calls] == [1, 0, 0]


@pytest.mark.parametrize("case", ["values_shape", "logits_dtype", "column_device",
                                  "grad_out_shape", "grad_out_dtype", "cpu_logits"])
def test_public_backward_still_refuses_a_wrong_input(monkeypatch, case):
    monkeypatch.setattr(build, "load", lambda *a, **kw: pytest.fail("reached the build"))
    monkeypatch.setattr(kp, "_LIB", None)
    if case != "cpu_logits":  # past the device check, as on the card
        monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    logits, values, rows = _packed_rows(8, 8)
    cols, grad_out = _cols(rows, 8), torch.ones(())
    error = ValueError
    if case == "values_shape":
        values = values[:-1]
    elif case == "logits_dtype":
        logits, error = logits.double(), TypeError
    elif case == "column_device":
        cols = cols[:2] + (cols[2].to("meta"),) + cols[3:]
    elif case == "grad_out_shape":
        grad_out = torch.ones(1)
    elif case == "grad_out_dtype":
        grad_out, error = grad_out.double(), TypeError
    with pytest.raises(error):
        kp.ppo_loss_bwd(logits, values, *cols, grad_out, PPOConfig())


# -- the row vectors -----------------------------------------------------------------------
@pytest.mark.parametrize("a", range(1, kp.MAX_ACTIONS + 1))
def test_row_vectors_exactly_where_a_is_its_padded_width_and_rows_lie_on_it(a):
    p = _padded(a)
    for off_logits in (0, 1, 2, 4, 8, 16):
        for off_grad in (0, 2, 32):
            logits = _aligned_views((3, a), off_logits)
            dlogits = _aligned_views((3, a), off_grad)
            want = (a == p and a >= 2 and logits.data_ptr() % (4 * p) == 0
                    and dlogits.data_ptr() % (4 * p) == 0)
            assert kp.row_vectors(logits, dlogits) is want, (a, off_logits, off_grad)
    assert kp.row_vectors(_aligned_views((3, a), 0), _aligned_views((3, a), 0)) is (
        a == p and a >= 2)


@pytest.mark.parametrize("a", [1, 2, 3, 4, 8, 32])
def test_the_wrapper_passes_the_row_vector_flag(lib, a):
    logits, values, rows = _packed_rows(16, 8, a=a)
    for off in (0, 1):
        shifted = _aligned_views(logits.shape, off)
        shifted.copy_(logits)
        dlogits, _ = kp.ppo_loss_bwd(shifted, values, *_cols(rows, 8), torch.ones(()),
                                     PPOConfig())
        call = lib.calls[-1]
        assert call["dlogits"] == dlogits.data_ptr() and call["logits"] == shifted.data_ptr()
        assert call["row_vectors"] == int(kp.row_vectors(shifted, dlogits))
        assert call["row_vectors"] == int(off == 0 and a in (2, 4, 8, 32)
                                          and dlogits.data_ptr() % (4 * a) == 0)


def test_the_launcher_refuses_a_false_row_vector_claim_as_the_wrapper_decides():
    body = PPO_SOURCE[PPO_SOURCE.index("bool rows_on_vectors("):]
    body = body[:body.index("\n}\n")]
    assert "n_actions >= 2 && lanes(n_actions) == n_actions" in body
    for ptr in ("logits", "dlogits"):
        assert f"reinterpret_cast<uintptr_t>({ptr}) % width == 0" in body
    assert "const uintptr_t width = 4u * (unsigned int)n_actions;" in body
    assert re.search(r"if \(row_vectors && !rows_on_vectors\(logits, dlogits, n_actions\)\)\s*"
                     r"return \(int\)cudaErrorInvalidValue;", PPO_SOURCE)


# -- block sizes -----------------------------------------------------------------------------
def test_the_backward_has_its_own_block_and_the_forward_keeps_its_own():
    defines = kp.defines()
    assert defines["PPO_BWD_THREADS"] == str(kp.BWD_THREADS)
    assert (defines["PPO_THREADS"], defines["PPO_CHUNK"]) == ("256", "2048")
    assert (kp.THREADS, kp.CHUNK) == (256, 2048)
    assert kp.BWD_THREADS % 32 == 0
    assert -(-16384 // kp.BWD_THREADS) >= 128  # the bench's rows: about a wave of 132 SMs
    launcher = PPO_SOURCE[PPO_SOURCE.index('extern "C" int ppo_loss_bwd_launch('):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert launcher.count("<<<bwd_blocks(n), BWD_THREADS, 0, stream>>>") == 4
    assert "inline int bwd_blocks(int n) { return (n + BWD_THREADS - 1) / BWD_THREADS; }" in (
        PPO_SOURCE)
    assert PPO_SOURCE.count("<<<blocks(n), THREADS, 0, stream>>>") == 2  # the forward's


# -- the reset's outputs ----------------------------------------------------------------------
@pytest.mark.parametrize("num", [0, 1, 7, 64, 8192])
def test_reset_outputs_keep_their_shapes_dtypes_and_contiguity(num):
    state, obs = kl._reset_outputs(num, torch.device("cpu"))
    env = LunarLander()
    want_state, want_obs = env.reset_from_plain(env.default_params(),
                                                env.reset_draws(Noise(torch.device("cpu"), 0),
                                                                max(num, 1)))
    outs = [*state, obs]
    for got, want in zip(outs, [*want_state, want_obs]):
        assert got.dtype == want.dtype and got.shape[1:] == want.shape[1:]
        assert got.shape[0] == num and got.is_contiguous()
    assert state.terrain.shape == (num, CHUNKS) and obs.shape == (num, 8)
    spans = sorted((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()) for x in outs
                   if x.numel())
    assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))  # no overlap
    for value, x in enumerate(outs):  # a write to one field reaches no other
        x.fill_(value % 2 if x.dtype == torch.bool else value)
    for value, x in enumerate(outs):
        assert torch.equal(x, torch.full_like(x, value % 2 if x.dtype == torch.bool else value))
    assert obs.data_ptr() % 16 == 0  # two float4 a row
    assert state.pos.data_ptr() % 8 == 0 and state.vel.data_ptr() % 8 == 0  # float2
    assert state.leg_contact.data_ptr() % 2 == 0  # one 2-byte store an env


def test_reset_wrapper_launches_on_its_outputs_in_the_launchers_order(monkeypatch):
    seen = []
    monkeypatch.setattr(kl, "_check_device", lambda x, what: None)
    monkeypatch.setattr(kl, "_library", lambda: types.SimpleNamespace(lander_reset_launch=None))
    monkeypatch.setattr(kl, "_launch", lambda fn, tensors, scalars, device, what: seen.append(
        (tensors, scalars)))
    env = LunarLander(enable_wind=True)
    params = env.default_params()
    draws = env.reset_draws(Noise(torch.device("cpu"), 1), 65)
    before = kernels.LAUNCHES["lunarlander_reset"]
    state, obs = kl.lander_reset(params, draws)
    (tensors, scalars), = seen
    assert kernels.LAUNCHES["lunarlander_reset"] == before + 1
    assert len(tensors) + len(scalars) + 2 == len(kl.RESET_ARGTYPES)  # + device, stream
    assert [t.data_ptr() for t in tensors] == [x.data_ptr() for x in (*draws, *state, obs)]
    names = [p.split()[-1].lstrip("*") for p in _c_params(LANDER_SOURCE, "lander_reset_launch")]
    assert names[4:16] == ["pos", "vel", "angle", "omega", "terrain", "prev_shaping",
                           "sleep_time", "wind_out", "torque_out", "leg_contact", "t", "obs"]
    assert list(state._fields) == ["pos", "vel", "angle", "omega", "terrain", "prev_shaping",
                                   "sleep_time", "wind_idx", "torque_idx", "leg_contact", "t"]
    assert scalars[:2] == [65, 1]


def test_reset_grid_gives_every_env_one_thread():
    envs = int(re.search(r"^constexpr int RESET_ENVS = (\d+);", LANDER_SOURCE, re.M).group(1))
    for line in ("inline int reset_blocks(int num) { return (num + RESET_ENVS - 1) / RESET_ENVS; }",
                 "lander_reset<true><<<reset_blocks(num), RESET_ENVS, 0, stream>>>(io, p);",
                 "lander_reset<false><<<reset_blocks(num), RESET_ENVS, 0, stream>>>(io, p);",
                 "__launch_bounds__(RESET_ENVS) lander_reset(",
                 "const int e = blockIdx.x * RESET_ENVS + threadIdx.x;",
                 "if (e >= p.num) return;"):
        assert line in LANDER_SOURCE, line
    assert envs % 32 == 0 and -(-8192 // envs) >= 128  # whole warps; 8192 envs fill a wave
    for num in (1, 63, 64, 65, 8192):
        blocks = -(-num // envs)
        threads = torch.arange(blocks * envs)
        live = threads[threads < num]
        assert live.tolist() == list(range(num)) and blocks * envs - num < envs


# -- launch and bindings -------------------------------------------------------------------------
@pytest.mark.parametrize("current", [3, 0])
def test_lander_launch_enters_the_device_only_when_it_is_not_current(monkeypatch, current):
    entered, seen = [], []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", lambda d: entered.append(d)
                        or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1000 + d.index))
    x = torch.zeros(3)
    kl._launch(lambda *args: seen.append(args) or 0, [x], [64, 0.5], torch.device("cuda", 3),
               "lander_reset")
    assert seen == [(x.data_ptr(), 64, 0.5, 3, 1003)]
    assert entered == ([] if current == 3 else [torch.device("cuda", 3)])


@pytest.mark.parametrize("source,fn,argtypes,names", [
    (kp.SOURCE, "ppo_loss_bwd_launch", kp.LOSS_BWD_ARGTYPES,
     ["logits", "values", "action", "logp_old", "adv", "ret", "grad_out", "dlogits", "dvalues",
      "n", "n_actions", "s_action", "s_logp", "s_adv", "s_ret", "packed", "row_vectors", "lo",
      "hi", "dual_clip", "value_coef", "entropy_coef", "inv_n", "device", "stream"]),
    (kl.SOURCE, "lander_reset_launch", kl.RESET_ARGTYPES,
     ["height_u", "force", "wind_idx", "torque_idx", "pos", "vel", "angle", "omega", "terrain",
      "prev_shaping", "sleep_time", "wind_out", "torque_out", "leg_contact", "t", "obs", "num",
      "enable_wind", "wind_power", "turbulence_power", "dt_g", "device", "stream"])])
def test_changed_launchers_bind_by_ctypes(source, fn, argtypes, names):
    params = _c_params(open(source).read(), fn)
    assert [_ctype(p) for p in params] == argtypes
    assert [p.split()[-1].lstrip("*") for p in params] == names
