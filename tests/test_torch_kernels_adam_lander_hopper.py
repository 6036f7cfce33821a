"""The Hopper redesign of ``clip_adam`` (``kernels/ppo.cu``) and
``lander_step`` (``kernels/lunarlander.cu``) on the CPU: what their
wrappers decide and hand to the C launchers (no nvcc, no card).

The kernels themselves run only on a CUDA device; ``chip_smoke.py`` phases
18 and 19 hold them there against the plain versions. Here:
  * ``clip_adam``'s launch table is built once and kept while the params,
    grads and moments keep their addresses and sizes, and the optimizer its
    state and param group; a new address, a new numel or a
    ``load_state_dict`` that replaces the state builds it again, with the
    new addresses;
  * the step terms, computed once per distinct step count, equal
    ``torch.optim.Adam``'s host-double arithmetic rounded to float32, to
    the bit, for steps 1..1000 with and without foreach; the CPU step
    tensors still count every step;
  * the alignment chooser flags exactly the tensors whose four arrays lie
    on 16 bytes, views at odd offsets into one flat buffer among them;
  * ``lander_step``'s grid, as its launcher picks it, gives every env of a
    batch of 1, 63, 64, 65 or 8192 exactly one thread of each lane, and no
    block past the last env;
  * the ctypes signatures match the changed C launchers.
"""

import copy
import ctypes
import re

import numpy as np
import pytest
import torch

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos.base import adam
from gymrl_tpu_torch.kernels import lunarlander as kl
from gymrl_tpu_torch.kernels import ppo as kp
from test_torch_kernels_lunarlander import _c_params, _ctype

torch.set_num_threads(1)

F32 = np.float32


class AdamLib:
    """Stands in for the built library: records each ``clip_adam`` launch's
    host arrays (their addresses and what they hold) while they live."""

    def __init__(self):
        self.calls = []

    def clip_adam_launch(self, params, grads, m, v, numels, step_sizes, bc2, device_terms,
                         aligned, k, sq, n_sq, max_norm, w, beta2, c2, eps, divide, device,
                         stream):
        def read(addr, t=ctypes.c_void_p):
            return list((t * k).from_address(addr))

        self.calls.append(dict(
            tables=(params, grads, m, v, numels, step_sizes, bc2, aligned),
            params=read(params), grads=read(grads), m=read(m), v=read(v),
            numels=read(numels, ctypes.c_longlong), step_sizes=read(step_sizes, ctypes.c_float),
            bc2=read(bc2, ctypes.c_float), aligned=read(aligned, ctypes.c_int), n_sq=n_sq,
            divide=divide))
        return 0


@pytest.fixture
def lib(monkeypatch):
    fake = AdamLib()
    monkeypatch.setattr(kp, "_library", lambda: fake)
    monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    monkeypatch.setattr(kp, "_ADAM_TABLE", None)
    monkeypatch.setattr(kp, "_launch", lambda fn, args, device, what: fn(*(
        a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), 0, 0))
    return fake


def _net_adam(foreach=True, sizes=(48, 7, 300, 1, 5)):
    gen = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(n, generator=gen)) for n in sizes]
    return params, adam(params, 3e-4, 1e-5, foreach=foreach)


def _grads(params, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen) for p in params]


def _step(opt, grads):
    kp.clip_adam(opt, grads, torch.ones(len(grads)), 0.5)


# -- the launch table ----------------------------------------------------------------------
def test_table_is_built_once_while_nothing_it_names_changes(lib):
    params, opt = _net_adam()
    grads = _grads(params)
    for _ in range(3):
        _step(opt, grads)
    assert len(lib.calls) == 3
    assert len({c["tables"] for c in lib.calls}) == 1  # the same host arrays each time
    call = lib.calls[0]
    assert call["params"] == [p.data_ptr() for p in params]
    assert call["grads"] == [g.data_ptr() for g in grads]
    assert call["m"] == [opt.state[p]["exp_avg"].data_ptr() for p in params]
    assert call["v"] == [opt.state[p]["exp_avg_sq"].data_ptr() for p in params]
    assert call["numels"] == [p.numel() for p in params] and call["n_sq"] == len(params)
    # every call counted its step, and wrote that step's terms into the kept arrays
    assert {float(opt.state[p]["step"]) for p in params} == {3.0}
    assert lib.calls[-1]["step_sizes"] == [kp.adam_step_terms(3.0, 3e-4, 0.9, 0.999, True)[0]] * 5


@pytest.mark.parametrize("change", ["grad_address", "grad_numel", "param_address",
                                    "moment_address", "state_entry", "load_state_dict", "lr",
                                    "step_tensor"])
def test_table_is_built_again_when_something_it_names_changes(lib, change):
    params, opt = _net_adam(sizes=(48, 7, 300))
    grads = _grads(params)
    _step(opt, grads)
    first = kp._ADAM_TABLE
    if change == "grad_address":
        grads = [g.clone() for g in grads]
    elif change == "grad_numel":  # a gradient of another size refuses, after a rebuild
        grads = grads[:2] + [grads[2][:-1]]
        with pytest.raises(ValueError, match="param 2"):
            _step(opt, grads)
        assert kp._ADAM_TABLE is first  # a refused table is not kept
        return
    elif change == "param_address":
        with torch.no_grad():
            params[1].data = params[1].data.clone()
    elif change == "moment_address":
        opt.state[params[0]]["exp_avg"] = opt.state[params[0]]["exp_avg"].clone()
    elif change == "state_entry":  # one param's state dict replaced by a copy
        opt.state[params[1]] = {k: v.clone() for k, v in opt.state[params[1]].items()}
    elif change == "load_state_dict":  # replaces the state and its tensors
        opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    elif change == "lr":
        opt.param_groups[0]["lr"] = 1e-3
    elif change == "step_tensor":
        opt.state[params[2]]["step"] = opt.state[params[2]]["step"].clone()
    _step(opt, grads)
    assert kp._ADAM_TABLE is not first
    last = lib.calls[-1]
    assert last["params"] == [p.data_ptr() for p in params]
    assert last["grads"] == [g.data_ptr() for g in grads]
    assert last["m"] == [opt.state[p]["exp_avg"].data_ptr() for p in params]
    assert last["v"] == [opt.state[p]["exp_avg_sq"].data_ptr() for p in params]
    lr = opt.param_groups[0]["lr"]
    assert last["step_sizes"] == [kp.adam_step_terms(2.0, lr, 0.9, 0.999, True)[0]] * 3
    assert {float(opt.state[p]["step"]) for p in params} == {2.0}  # the step counted once


def test_pieces_of_max_tensors_and_distinct_steps(lib, monkeypatch):
    """Past ``MAX_TENSORS`` tensors a call launches once per piece; tensors
    at different step counts each get their own step's terms."""
    monkeypatch.setattr(kp, "MAX_TENSORS", 2)
    params, opt = _net_adam(foreach=False)
    opt.state[params[3]]["step"].fill_(9.0)
    before = kernels.LAUNCHES["clip_adam"]
    _step(opt, _grads(params))
    assert kernels.LAUNCHES["clip_adam"] == before + 3
    assert [len(c["params"]) for c in lib.calls] == [2, 2, 1]
    steps = [1.0, 1.0, 1.0, 10.0, 1.0]
    want = [kp.adam_step_terms(s, 3e-4, 0.9, 0.999, False) for s in steps]
    got = [t for c in lib.calls for t in zip(c["step_sizes"], c["bc2"])]
    assert got == want and all(c["divide"] == 0 for c in lib.calls)


# -- the step terms --------------------------------------------------------------------------
@pytest.mark.parametrize("foreach", [True, False], ids=["foreach", "per_tensor"])
def test_step_terms_are_adams_host_arithmetic_to_the_bit(foreach):
    """``torch.optim.Adam``'s own host arithmetic (``_multi_tensor_adam`` /
    ``_single_tensor_adam`` without capturable), in double, rounded once to
    float32 where the launch stores it; one tensor at a time the card
    multiplies by the double reciprocal of ``bias_correction2_sqrt``."""
    lr, beta1, beta2 = 3e-4, 0.9, 0.999
    for step in range(1, 1001):
        step = float(step)  # _get_value(step_t): a CPU tensor's item
        bias_correction1 = 1 - beta1 ** step
        bias_correction2 = 1 - beta2 ** step
        if foreach:
            step_size = (lr / bias_correction1) * -1
            term = bias_correction2 ** 0.5
        else:
            step_size = -(lr / bias_correction1)
            term = 1.0 / bias_correction2 ** 0.5
        got = kp.adam_step_terms(step, lr, beta1, beta2, foreach)
        assert np.array([got], F32).view(np.uint32).tolist() == \
            np.array([[step_size, term]], F32).view(np.uint32).tolist(), step


# -- the alignment chooser ----------------------------------------------------------------------
def test_alignment_flags_exactly_the_tensors_on_16_bytes():
    """Views at offsets 0-3 floats into one flat buffer per array (as a flat
    optimizer hands them over): a tensor takes the float4 path only where
    all four of its arrays lie on 16 bytes."""
    sizes = (4099, 2050, 7, 4097, 1, 2048, 6001, 65539)
    offsets = (0, 1, 2, 3, 0, 1, 0, 3)

    def views(shift=0):
        starts, at = [], 0
        for n, off in zip(sizes, offsets):
            starts.append(at + (off + shift) % 4)
            at += -(-(off + n + 4) // 4) * 4
        buf = torch.zeros(at + 4)
        assert buf.data_ptr() % 16 == 0
        return [buf[s:s + n] for s, n in zip(starts, sizes)]

    p, g, m, v = views(), views(), views(), views()
    assert kp.aligned_flags(p, g, m, v) == [int(o == 0) for o in offsets]
    shifted = views(shift=1)  # one array off where the others are on
    assert kp.aligned_flags(p, g, shifted, v) == [0] * len(sizes)
    assert kp.aligned_flags(p) == [int(x.data_ptr() % 16 == 0) for x in p]


def test_the_wrapper_passes_the_flags(lib):
    params = [torch.nn.Parameter(x) for x in torch.zeros(64)[1:].split((3, 20, 40))]
    opt = adam(params, 3e-4, 1e-5, foreach=True)
    _step(opt, _grads(params))
    (call,) = lib.calls
    want = [int(all(x % 16 == 0 for x in (p.data_ptr(), opt.state[p]["exp_avg"].data_ptr())))
            for p in params]
    assert call["aligned"] == want and call["aligned"] != [1, 1, 1]


# -- the lander's grid ---------------------------------------------------------------------------
def _lander_geometry():
    """(THREADS, LANES) of ``lunarlander.cu``, after checking that its
    launcher and kernel map threads to envs as ``_covered`` emulates."""
    text = open(kl.SOURCE).read()
    threads = int(re.search(r"^#define THREADS (\d+)$", text, re.M).group(1))
    lanes = int(re.search(r"^constexpr int LANES = (\d+);", text, re.M).group(1))
    for line in ("constexpr int ENVS = THREADS / LANES;",
                 "inline int step_blocks(int num) { return (num + ENVS - 1) / ENVS; }",
                 "const int blocks = step_blocks(num);",
                 "lander_step<true, true><<<blocks, THREADS, 0, stream>>>",
                 "const int first = blockIdx.x * ENVS;",
                 "const int lane = threadIdx.x % LANES;",
                 "const bool live = (int)threadIdx.x / LANES < envs;"):
        assert line in text, line
    return threads, lanes


@pytest.mark.parametrize("num", [1, 63, 64, 65, 8192])
def test_lander_grid_gives_every_env_one_thread_of_each_lane(num):
    threads, lanes = _lander_geometry()
    assert threads % 32 == 0 and 32 % lanes == 0  # an env's tile never straddles a warp
    envs_per_block = threads // lanes
    blocks = (num + envs_per_block - 1) // envs_per_block  # the launcher's step_blocks
    block, thread = np.meshgrid(np.arange(blocks), np.arange(threads), indexing="ij")
    env = block * envs_per_block + thread // lanes  # the kernel's first + slot
    lane = thread % lanes
    live = env < num
    pairs = set(zip(env[live].tolist(), lane[live].tolist()))
    assert len(pairs) == live.sum() == num * lanes
    assert pairs == {(e, ln) for e in range(num) for ln in range(lanes)}
    assert live.reshape(blocks, -1).any(axis=1).all()  # no block past the last env


# -- bindings -----------------------------------------------------------------------------------
@pytest.mark.parametrize("source,fn,argtypes,names", [
    (kp.SOURCE, "clip_adam_launch", kp.CLIP_ADAM_ARGTYPES,
     ["params", "grads", "exp_avgs", "exp_avg_sqs", "numels", "step_sizes", "bc2_terms",
      "device_terms", "aligned", "n_tensors", "sq", "n_sq", "max_norm", "lerp_weight", "beta2",
      "one_minus_beta2", "eps", "divide", "device", "stream"]),
    (kl.SOURCE, "lander_step_launch", kl.STEP_ARGTYPES, None)])
def test_changed_launchers_bind_by_ctypes(source, fn, argtypes, names):
    params = _c_params(open(source).read(), fn)
    assert [_ctype(p) for p in params] == argtypes
    got = [p.split()[-1].lstrip("*") for p in params]
    if names is not None:
        assert got == names
    else:
        assert got[-3:] == ["dt_g", "device", "stream"]


def test_adam_chunk_is_clip_adams_own():
    text = open(kp.SOURCE).read()
    assert kp.defines()["PPO_ADAM_CHUNK"] == str(kp.ADAM_CHUNK)
    assert kp.ADAM_CHUNK % (4 * kp.THREADS) == 0  # whole float4 of every thread
    assert re.search(r"chunk_table\(t\.numel, n_tensors, t\.chunk_start, ADAM_CHUNK\)", text)
    assert re.search(r"chunk_table\(t\.numel, n_tensors, t\.chunk_start, CHUNK\)", text)
