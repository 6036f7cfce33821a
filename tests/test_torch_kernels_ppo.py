"""PPO's update kernels (``gymrl_tpu_torch/kernels/ppo.cu``) on the CPU: their
wrappers, dispatch and plain versions (no nvcc, no card).

The kernels themselves run only on a CUDA device; ``chip_smoke.py`` phase
19 holds them there against the plain versions. Here:
  * the ctypes signatures match the C launchers, and the source uses the
    defines the build passes and no other;
  * the wrappers refuse CPU tensors, wrong dtypes (an integer action too),
    shapes and strides, and Adam options the kernel does not implement (more
    than one param group among them), before any build;
  * the dispatch (``algos.ppo.ppo_head_loss``, ``algos.base.clip_adam_``)
    sends tensors off the CPU to the kernels and CPU tensors to the plain
    versions; a failing build raises and never yields the plain result;
  * ``ppo_head_loss_plain``'s loss, metrics and gradients equal the JAX
    package's ``PPOTrainer._loss`` under ``jax.value_and_grad``, with a
    stand-in net that returns the logits and values it is given, on rows
    inside the clip band, beyond both its bounds, exactly on them, under the
    dual clip and exactly at it. Tolerance: rtol 1e-5 on the loss and
    metrics (atol 1e-7), rtol 1e-5 plus 1e-5 of each tensor's largest entry
    on the gradients, as ``test_torch_ppo.py``. One rule differs, on purpose
    (autograd's, which the kernels reproduce): at a ratio exactly on
    1 ± clip_eps, ``torch.clamp`` passes its whole gradient and JAX's
    ``jnp.clip`` (a ``maximum`` and a ``minimum``) half of it, so there the
    port's gradient through the ratio is 4/3 of the reference's; the test
    holds that difference to the same tolerance;
  * ``clip_adam_`` on the CPU is the former clip and ``opt.step()`` bit for
    bit, and Adam's state survives a checkpoint;
  * the multi-tensor tables are cut into launches of ``MAX_TENSORS``, each
    with its slice of the squares, its host arrays and Adam's bias
    corrections computed as ``torch.optim.Adam`` computes them.
"""

import ctypes
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymrl_tpu.algos.ppo import MinibatchData
from gymrl_tpu.algos.ppo import PPOConfig as RefConfig
from gymrl_tpu.algos.ppo import PPOTrainer as RefTrainer
from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos import base
from gymrl_tpu_torch.algos import ppo as ppo_mod
from gymrl_tpu_torch.algos.base import adam, clip_grads_by_global_norm_
from gymrl_tpu_torch.algos.ppo import ActorCritic, LossMetrics, PPOConfig, PPOTrainer
from gymrl_tpu_torch.kernels import build
from gymrl_tpu_torch.kernels import ppo as kp
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from test_torch_kernels_lunarlander import FakeNvcc, _c_params, _ctype

torch.set_num_threads(1)

RTOL = 1e-5
F32 = np.float32


# -- the source and its bindings ----------------------------------------------------
@pytest.mark.parametrize("fn,argtypes", [
    ("ppo_loss_fwd_launch", kp.LOSS_FWD_ARGTYPES), ("ppo_loss_bwd_launch", kp.LOSS_BWD_ARGTYPES),
    ("grad_sq_norms_launch", kp.SQ_NORMS_ARGTYPES), ("clip_adam_launch", kp.CLIP_ADAM_ARGTYPES)])
def test_ctypes_signatures_match_the_c_launchers(fn, argtypes):
    params = _c_params(open(kp.SOURCE).read(), fn)
    assert [_ctype(p) for p in params] == argtypes


def test_source_uses_every_define_and_no_other():
    used = set(re.findall(r"\bPPO_[A-Z0-9_]*[A-Z0-9]\b", open(kp.SOURCE).read()))
    assert used == set(kp.defines())
    assert kp.defines()["PPO_MAX_TENSORS"] == str(kp.MAX_TENSORS)


# -- inputs -------------------------------------------------------------------------
def _head_inputs(n=8, a=4, d=8, seed=0):
    """Logits, values and the four columns as views of packed rows, the way
    ``PPOTrainer._minibatch_step`` hands them over."""
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randn((n, d + 4), generator=gen)
    rows[:, d] = torch.randint(0, a, (n,), generator=gen).float()
    cols = (rows[:, d], rows[:, d + 1], rows[:, d + 2], rows[:, d + 3])
    return torch.randn((n, a), generator=gen), torch.randn(n, generator=gen), cols


def _net_and_adam(foreach: bool, hidden: int = 16, seed: int = 0):
    net = ActorCritic(8, 4, hidden, generator=torch.Generator().manual_seed(seed))
    return net, adam(list(net.parameters()), 2.5e-4, 1e-5, foreach=foreach)


def _set_grads(net, norm: float, seed: int):
    gen = torch.Generator().manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen) for p in net.parameters()]
    total = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
    for p, g in zip(net.parameters(), grads):
        p.grad = g * (norm / total)
    return [p.grad for p in net.parameters()]


def _no_build(*args, **kw):
    raise AssertionError("the wrapper reached the build")


@pytest.mark.parametrize("case", ["cpu_logits", "float64_values", "noncontiguous_logits",
                                  "values_shape", "too_many_actions", "int_action",
                                  "column_device", "grad_out_dtype"])
def test_head_wrappers_refuse_bad_inputs_before_any_build(monkeypatch, case):
    monkeypatch.setattr(build, "load", _no_build)
    monkeypatch.setattr(kp, "_LIB", None)
    if case != "cpu_logits":  # past the device check, as on the card
        monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    logits, values, cols = _head_inputs()
    grad_out = torch.ones(())
    if case == "float64_values":
        values = values.double()
    elif case == "noncontiguous_logits":
        logits = torch.randn(4, 8).t()
    elif case == "values_shape":
        values = values[:-1]
    elif case == "too_many_actions":
        logits = torch.randn(8, kp.MAX_ACTIONS + 1)
    elif case == "int_action":
        cols = (cols[0].int(),) + cols[1:]
    elif case == "column_device":
        cols = cols[:3] + (cols[3].to("meta"),)
    elif case == "grad_out_dtype":
        grad_out = grad_out.double()
    error = TypeError if case in ("float64_values", "int_action", "grad_out_dtype") else ValueError
    with pytest.raises(error):
        if case == "grad_out_dtype":
            kp.ppo_loss_bwd(logits, values, *cols, grad_out, PPOConfig())
        else:
            kp.ppo_loss_fwd(logits, values, *cols, PPOConfig())
    if case != "grad_out_dtype":
        with pytest.raises(error):
            kp.ppo_loss_bwd(logits, values, *cols, grad_out, PPOConfig())


@pytest.mark.parametrize("case", ["cpu_grads", "float64_grad", "noncontiguous_grad", "none_grad",
                                  "grad_count", "grad_shape", "sq_shape", "amsgrad", "fused",
                                  "weight_decay", "no_state", "capturable_step",
                                  "two_groups"])
def test_update_wrappers_refuse_bad_inputs_before_any_build(monkeypatch, case):
    monkeypatch.setattr(build, "load", _no_build)
    monkeypatch.setattr(kp, "_LIB", None)
    if case != "cpu_grads":
        monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    net, opt = _net_and_adam(foreach=True)
    grads = _set_grads(net, 1.0, 0)
    sq = torch.ones(len(grads))
    group = opt.param_groups[0]
    if case == "float64_grad":
        grads[3] = grads[3].double()
    elif case == "noncontiguous_grad":
        grads[0] = grads[0].t()
    elif case == "none_grad":
        grads[5] = None
    elif case == "grad_count":
        grads = grads[:-1]
    elif case == "grad_shape":
        grads[2] = grads[2][:-1]
    elif case == "sq_shape":
        sq = sq[:-1]
    elif case == "amsgrad":
        group["amsgrad"] = True
    elif case == "fused":
        group["fused"] = True
    elif case == "weight_decay":
        group["weight_decay"] = 1e-4
    elif case == "no_state":
        opt.state.clear()
    elif case == "capturable_step":
        opt.state[next(iter(net.parameters()))]["step"] = torch.tensor(0.0, device="meta")
    elif case == "two_groups":  # algos.base.adam builds one group; PPO steps one
        params = list(net.parameters())
        state = dict(opt.state)
        opt = torch.optim.Adam([{"params": params[:4]}, {"params": params[4:]}], lr=1e-3)
        opt.state.update(state)
    error = TypeError if case == "float64_grad" else ValueError

    def steps():
        return [float(s["step"]) for s in opt.state.values()
                if "step" in s and s["step"].device.type == "cpu"]

    before = steps()
    with pytest.raises(error):
        kp.clip_adam(opt, grads, sq, 0.5)
    if case in ("cpu_grads", "float64_grad", "noncontiguous_grad", "none_grad"):
        with pytest.raises(error):
            kp.grad_sq_norms(grads)
    assert steps() == before  # a refused step counts nothing


# -- dispatch -------------------------------------------------------------------------
def test_dispatch_sends_tensors_off_the_cpu_to_the_kernels(monkeypatch):
    calls = []
    monkeypatch.setattr(kp.PPOHeadLoss, "apply",
                        lambda *args: calls.append(("head", args)) or ("loss", "vec"))
    monkeypatch.setattr(ppo_mod, "ppo_head_loss_plain", _no_build)
    monkeypatch.setattr(base, "clip_adam_plain_", _no_build)
    monkeypatch.setattr(kp, "grad_sq_norms", lambda grads: calls.append(("sq", grads)) or "sq")
    monkeypatch.setattr(kp, "clip_adam", lambda opt, grads, sq, max_norm: calls.append(
        ("adam", sq, max_norm)))
    meta = torch.device("meta")
    logits, values, cols = _head_inputs()
    cols = tuple(c.to(meta) for c in cols)
    assert ppo_mod.ppo_head_loss(logits.to(meta), values.to(meta), *cols,
                                 PPOConfig()) == ("loss", "vec")
    (_, args), = calls
    assert args[2] is cols[0]  # the packed float column, as it lies
    grads = [torch.zeros(3, device=meta)]
    base.clip_adam_(object(), grads, 0.5)
    assert calls[1:] == [("sq", grads), ("adam", "sq", 0.5)]


def test_dispatch_keeps_cpu_tensors_on_the_plain_versions(monkeypatch):
    for name in ("PPOHeadLoss", "ppo_loss_fwd", "ppo_loss_bwd", "grad_sq_norms", "clip_adam"):
        monkeypatch.setattr(kp, name, _no_build)
    logits, values, cols = _head_inputs()
    loss, vec = ppo_mod.ppo_head_loss(logits, values, *cols, PPOConfig())
    want, want_vec = ppo_mod.ppo_head_loss_plain(logits, values, *cols, PPOConfig())
    assert torch.equal(loss, want) and torch.equal(vec, want_vec) and vec.shape == (5,)
    net, opt = _net_and_adam(foreach=False)
    base.clip_adam_(opt, _set_grads(net, 1.0, 0), 0.5)
    assert {float(s["step"]) for s in opt.state.values()} == {1.0}


def test_loss_metrics_are_views_of_one_vector():
    trainer = PPOTrainer(PPOConfig(num_envs=2, rollout_steps=4, minibatch_size=8,
                                   hidden_dim=16), device="cpu")
    ts = trainer.init(0)
    _, _, cols = _head_inputs()
    obs = torch.randn(8, 8)
    loss, metrics = trainer._loss(ts.params, obs, *cols)
    assert isinstance(metrics, LossMetrics) and tuple(metrics) == kp.METRICS
    assert all(m._base is metrics.vec for m in metrics.values())
    assert not metrics.vec.requires_grad and loss.requires_grad


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(kp, "_LIB", None)
    monkeypatch.setattr(kp, "_TICKETS", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: "fake-nvcc")
    return tmp_path / "_build"


@pytest.mark.parametrize("fail", [False, True], ids=["nvcc_missing", "nvcc_fails"])
def test_a_failing_compiler_raises_and_never_returns_the_plain_result(monkeypatch, fresh_build,
                                                                      fail):
    if fail:
        monkeypatch.setattr(build, "_run", FakeNvcc(fail=True))
    else:
        monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    meta = torch.device("meta")  # not the CPU: the dispatch takes the kernels
    logits, values, cols = _head_inputs()
    before = dict(kernels.LAUNCHES)
    match = "boom" if fail else "nvcc is not on PATH"
    with pytest.raises(build.KernelCompileError, match=match):
        ppo_mod.ppo_head_loss(logits.to(meta), values.to(meta), *(c.to(meta) for c in cols),
                              PPOConfig())
    net, opt = _net_and_adam(foreach=True)
    grads = [torch.zeros(p.shape, device=meta) for p in net.parameters()]
    with pytest.raises(build.KernelCompileError, match=match):
        base.clip_adam_(opt, grads, 0.5)
    assert kernels.LAUNCHES == before
    assert {float(s["step"]) for s in opt.state.values()} == {0.0}
    assert not os.path.exists(fresh_build) or os.listdir(fresh_build) == []


def test_launch_passes_addresses_device_and_stream_last(monkeypatch):
    import contextlib

    entered, seen = [], []
    monkeypatch.setattr(torch.cuda, "device", lambda d: entered.append(d)
                        or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1000 + d.index))
    x = torch.zeros(3)
    kp._launch(lambda *args: seen.append(args) or 0, [x, 7, 0.5, x], torch.device("cuda", 2),
               "clip_adam")
    assert entered == [torch.device("cuda", 2)]
    assert seen == [(x.data_ptr(), 7, 0.5, x.data_ptr(), 2, 1002)]
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        kp._launch(lambda *args: 700, [x], torch.device("cuda", 2), "clip_adam")


# -- the plain head against the JAX package ----------------------------------------------
class _Given:
    """Stands in for the reference trainer's ``self.net``: ``apply`` returns
    the logits and values passed as its params."""

    @staticmethod
    def apply(params, obs):
        return params["logits"], params["values"]


def _ref_head(logits, values, action, logp_old, adv, ret):
    rt = object.__new__(RefTrainer)  # only `cfg` and `net` are read by `_loss`
    rt.cfg, rt.net = RefConfig(), _Given()
    params = {"logits": jnp.asarray(logits), "values": jnp.asarray(values)}
    batch = MinibatchData(obs=jnp.zeros((len(values), 1)), action=jnp.asarray(action),
                          logp=jnp.asarray(logp_old))
    (loss, metrics), grads = jax.value_and_grad(rt._loss, has_aux=True)(
        params, batch, jnp.asarray(adv), jnp.asarray(ret))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            np.asarray(grads["logits"]), np.asarray(grads["values"]))


def _logp(logits, action):
    """The taken action's log-probability in both frameworks (float32)."""
    t = torch.log_softmax(torch.from_numpy(logits), -1)[np.arange(len(action)), action].numpy()
    j = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))[np.arange(len(action)), action]
    return t, j


def _ratio(logp, logp_old):
    t = torch.exp(torch.tensor(F32(logp)) - torch.tensor(F32(logp_old)))
    return float(t), float(jnp.exp(jnp.float32(logp) - jnp.float32(logp_old)))


def _tie_logp_old(logp, target, adv=None):
    """A float32 logp_old whose ratio under ``logp`` is exactly ``target`` in
    both frameworks (with ``adv``: whose ``ratio * adv`` equals
    ``target * adv``), or None."""
    start = F32(logp - np.log(target))
    for k in range(-64, 65):
        cand = F32(start + k * np.spacing(start))
        rt, rj = _ratio(logp, cand)
        if adv is None and rt == rj == float(F32(target)):
            return cand
        if adv is not None and rt == rj and F32(rt) * F32(adv) == F32(target) * F32(adv):
            return cand
    return None


def _rows_with_ties(n_actions, seed):
    """64 rows: inside the band, below and above it, under the dual clip, and
    two rows each exactly on 1 - clip_eps, on 1 + clip_eps and at
    ``min_surr == 3 * adv``. Returns the inputs and the band rows' indices."""
    rng = np.random.default_rng(seed)
    n = 64
    logits = rng.normal(size=(n, n_actions)).astype(F32)
    action = rng.integers(0, n_actions, n).astype(np.int32)
    # likely actions for the tie rows: a logp near 0 lets logp_old reach any ratio
    logits[np.arange(n), action] += np.where(np.arange(n) < 24, 2.5, 0.0).astype(F32)
    adv = (rng.normal(size=n) * 2).astype(F32)
    ret = (rng.normal(size=n) * 5).astype(F32)
    logp_t, logp_j = _logp(logits, action)
    r = np.exp(rng.uniform(-0.15, 0.15, n))  # inside the band
    r[24:36] = rng.uniform(0.3, 0.7, 12)  # below it
    r[36:48] = rng.uniform(1.4, 2.5, 12)  # above it
    r[48:56] = rng.uniform(3.5, 6.0, 8)  # under the dual clip when adv < 0
    adv[48:56] = -np.abs(adv[48:56])
    logp_old = (logp_t - np.log(r)).astype(F32)
    edges = {}
    lo, hi = F32(1.0 - 0.2), F32(1.0 + 0.2)
    for name, target, rows in (("lower", lo, range(0, 8)), ("upper", hi, range(8, 16)),
                               ("dual", 3.0, range(16, 24))):
        found = []
        for i in rows:
            if logp_t[i] != logp_j[i] or len(found) == 2:
                continue
            if name == "dual":
                for a in -np.abs(rng.normal(size=16) + 1.5).astype(F32):
                    cand = _tie_logp_old(logp_t[i], target, a)
                    if cand is not None:
                        adv[i], logp_old[i] = a, cand
                        found.append(i)
                        break
            else:
                cand = _tie_logp_old(logp_t[i], target)
                if cand is not None:
                    logp_old[i] = cand
                    found.append(i)
        assert len(found) == 2, f"no {name} tie rows found"
        edges[name] = found
    values = (rng.normal(size=n) * 3).astype(F32)
    return (logits, values, action, logp_old, adv, ret), edges


@pytest.mark.parametrize("n_actions", [4, 2], ids=["lander", "cartpole"])
def test_plain_head_matches_the_reference_loss_and_gradients(n_actions):
    (logits, values, action, logp_old, adv, ret), edges = _rows_with_ties(n_actions, 3)
    ratio = np.exp(np.float64(_logp(logits, action)[0]) - logp_old)
    assert (ratio < 0.8).any() and (ratio > 1.2).any() and ((adv < 0) & (ratio > 3)).any()
    want_loss, want_metrics, want_dl, want_dv = _ref_head(logits, values, action, logp_old,
                                                          adv, ret)
    lg = torch.from_numpy(logits).requires_grad_(True)
    v = torch.from_numpy(values).requires_grad_(True)
    cols = [torch.from_numpy(x) for x in (action, logp_old, adv, ret)]
    loss, metrics = ppo_mod.ppo_head_loss_plain(lg, v, *cols, PPOConfig())
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL, atol=0)
    for k, m in zip(kp.METRICS, metrics.tolist()):
        np.testing.assert_allclose(m, want_metrics[k], rtol=RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(v.grad.numpy(), want_dv, rtol=RTOL,
                               atol=1e-5 * np.abs(want_dv).max())
    # at a ratio exactly on a band edge autograd's clamp passes the whole
    # gradient and JAX's clip half of it: the port's d loss / d ratio there is
    # g_obj * adv, the reference's 0.75 of it, along d ratio / d logits
    n = len(values)
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits)), np.float64)
    onehot = np.eye(n_actions)[action]
    ratio32 = np.exp(np.float64(_logp(logits, action)[0]) - logp_old)
    expected = want_dl.astype(np.float64)
    for i in edges["lower"] + edges["upper"]:
        expected[i] += 0.25 * (-1.0 / n) * adv[i] * ratio32[i] * (onehot[i] - p[i])
    np.testing.assert_allclose(lg.grad.numpy(), expected, rtol=RTOL,
                               atol=1e-5 * np.abs(want_dl).max())
    # and that difference is really there, far above the tolerance
    for i in edges["lower"] + edges["upper"]:
        assert np.abs(lg.grad.numpy()[i] - want_dl[i]).max() > 1e-4 * np.abs(want_dl).max()
    # at min_surr == 3 * adv both frameworks split the maximum's gradient in half
    for i in edges["dual"]:
        np.testing.assert_allclose(lg.grad.numpy()[i], want_dl[i], rtol=RTOL,
                                   atol=1e-5 * np.abs(want_dl).max())


# -- clip + Adam on the CPU ----------------------------------------------------------
@pytest.mark.parametrize("foreach", [True, False], ids=["foreach", "per_tensor"])
@pytest.mark.parametrize("norm", [5.0, 0.05], ids=["clip_active", "clip_inactive"])
def test_clip_adam_on_the_cpu_is_the_former_step_bit_for_bit(foreach, norm):
    runs = []
    for step in ("new", "former"):
        net, opt = _net_and_adam(foreach)
        for i in range(3):
            grads = _set_grads(net, norm, i)
            if step == "new":
                base.clip_adam_(opt, grads, 0.5)
            else:
                clip_grads_by_global_norm_(grads, 0.5)
                opt.step()
        runs.append((net, opt))
    (net, opt), (net0, opt0) = runs
    for p, p0 in zip(net.parameters(), net0.parameters()):
        assert torch.equal(p, p0)
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][k], opt0.state[p0][k]), k


def test_adam_state_survives_a_checkpoint_round_trip(tmp_path):
    trainer = PPOTrainer(PPOConfig(num_envs=4, rollout_steps=8, minibatch_size=16, num_epochs=2,
                                   hidden_dim=16, flat_optimizer=True), device="cpu")
    ts, _ = trainer.train_iter(trainer.init(0))
    path = save_checkpoint(str(tmp_path / "ppo.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    params = dict(ts.params.named_parameters())
    for name, p in restored.params.named_parameters():
        assert torch.equal(p, params[name])
        got, want = restored.opt_state.state[p], ts.opt_state.state[params[name]]
        assert float(got["step"]) == float(want["step"]) == 4.0
        assert got["step"].device.type == "cpu"
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[k], want[k])
    # and it steps on from there as the trained state does
    for state in (ts, restored):
        grads = _set_grads(state.params, 1.0, 7)
        base.clip_adam_(state.opt_state, grads, 0.5)
    for (name, p), q in zip(ts.params.named_parameters(), restored.params.parameters()):
        assert torch.equal(p, q), name


# -- the multi-tensor tables -------------------------------------------------------------
class FakeLib:
    """Records each launch's host arrays while they live (the wrapper frees
    them when the call returns)."""

    def __init__(self):
        self.sq, self.adam = [], []

    def grad_sq_norms_launch(self, grads, numels, aligned, k, sq, partials, ticket, device,
                             stream):
        self.sq.append(dict(grads=list((ctypes.c_void_p * k).from_address(grads)),
                            numels=list((ctypes.c_longlong * k).from_address(numels)),
                            sq=sq, partials=partials))
        return 0

    def clip_adam_launch(self, params, grads, m, v, numels, step_sizes, bc2, device_terms,
                         aligned, k, sq, n_sq, max_norm, w, beta2, c2, eps, divide, device,
                         stream):
        read = lambda addr, t=ctypes.c_void_p: list((t * k).from_address(addr))  # noqa: E731
        self.adam.append(dict(params=read(params), grads=read(grads), m=read(m), v=read(v),
                              numels=read(numels, ctypes.c_longlong),
                              step_sizes=read(step_sizes, ctypes.c_float),
                              bc2=read(bc2, ctypes.c_float), aligned=read(aligned, ctypes.c_int),
                              sq=sq, n_sq=n_sq, scalars=(max_norm, w, beta2, c2, eps, divide)))
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(kp, "_library", lambda: lib)
    monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    monkeypatch.setattr(kp, "_TICKETS", {})
    monkeypatch.setattr(kp, "_launch", lambda fn, args, device, what: fn(*(
        a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), 0, 0))
    return lib


@pytest.mark.parametrize("foreach", [True, False], ids=["foreach", "per_tensor"])
def test_multi_tensor_tables_are_chunked(monkeypatch, fake_lib, foreach):
    monkeypatch.setattr(kp, "MAX_TENSORS", 5)
    net, opt = _net_and_adam(foreach, hidden=300)  # 12 tensors; 90,000 in the widest
    for s in opt.state.values():
        s["step"].fill_(6.0)
    grads = _set_grads(net, 1.0, 0)
    before = dict(kernels.LAUNCHES)
    sq = kp.grad_sq_norms(grads)
    kp.clip_adam(opt, grads, sq, 0.5)
    pieces = [slice(0, 5), slice(5, 10), slice(10, 12)]
    assert len(fake_lib.sq) == len(fake_lib.adam) == 3
    assert kernels.LAUNCHES["grad_sq_norms"] == before["grad_sq_norms"] + 3
    assert kernels.LAUNCHES["clip_adam"] == before["clip_adam"] + 3
    params = list(net.parameters())
    beta1, beta2 = opt.param_groups[0]["betas"]
    lr = opt.param_groups[0]["lr"]
    for piece, launch in zip(pieces, fake_lib.sq):
        assert launch["grads"] == [g.data_ptr() for g in grads[piece]]
        assert launch["numels"] == [g.numel() for g in grads[piece]]
        assert launch["sq"] == sq.data_ptr() + 4 * piece.start  # its slice of the squares
        assert launch["partials"] is not None
    for piece, launch in zip(pieces, fake_lib.adam):
        ps = params[piece]
        assert launch["params"] == [p.data_ptr() for p in ps]
        assert launch["grads"] == [g.data_ptr() for g in grads[piece]]
        assert launch["m"] == [opt.state[p]["exp_avg"].data_ptr() for p in ps]
        assert launch["v"] == [opt.state[p]["exp_avg_sq"].data_ptr() for p in ps]
        assert launch["sq"] == sq.data_ptr() and launch["n_sq"] == 12  # every square
        # Adam's own host arithmetic at step 7, in double, rounded to float32 once
        step = 7.0
        bc2_sqrt = (1 - beta2 ** step) ** 0.5
        assert launch["step_sizes"] == [float(F32(-(lr / (1 - beta1 ** step))))] * len(ps)
        assert launch["bc2"] == [float(F32(bc2_sqrt if foreach else 1.0 / bc2_sqrt))] * len(ps)
        assert launch["scalars"] == (float(F32(0.5)), float(F32(1 - beta1)), float(F32(beta2)),
                                     float(F32(1 - beta2)), float(F32(1e-5)), int(foreach))
    # each step counted once, on the host, as Adam counts it
    assert {float(s["step"]) for s in opt.state.values()} == {7.0}
    assert all(s["step"].device.type == "cpu" for s in opt.state.values())
    assert sum(p.numel() for p in params) == sum(sum(x["numels"]) for x in fake_lib.adam)
