"""The Hopper redesign of ``ppo_loss_fwd`` and ``grad_sq_norms``
(``gymrl_tpu_torch/kernels/ppo.cu``) on the CPU: what their wrappers decide
and hand to the C launchers (no nvcc, no card).

The kernels themselves run only on a CUDA device; ``chip_smoke.py`` phase
19 holds them there against the plain versions (every row width and column
layout of the main path, one block and many, bit-equal reruns). Here a
stand-in library records each launch's arguments by the C parameter names:
  * the loss launcher's dispatch covers the padded row width of every A in
    1..MAX_ACTIONS, and the wrapper hands it A;
  * ``columns_packed`` (the float4 column loads) holds exactly for four
    side-by-side columns at one stride on 16 bytes, and the wrapper passes
    its answer; the loss's partials and ticket are passed only past one
    block, and loss and metrics are views of one ``f32[6]`` that autograd
    and an in-place metrics update both take;
  * the squares' table flags each tensor's 16-byte alignment and keeps its
    numel (the ``numel % 4`` tail), for views at storage offsets 0-3; the
    table is reused while the gradients keep their addresses and sizes and
    rebuilt when one changes; the scratch is one per (device, stream);
  * a launch enters PyTorch's device context only when the card is not
    already current;
  * the ctypes signatures match the changed C launchers, and the source
    uses the build's defines and no other.
"""

import contextlib
import ctypes
import re
import types

import pytest
import torch

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos.ppo import PPOConfig
from gymrl_tpu_torch.kernels import ppo as kp
from test_torch_kernels_lunarlander import _c_params, _ctype

torch.set_num_threads(1)

SOURCE = open(kp.SOURCE).read()


def _names(fn: str) -> list[str]:
    """The C launcher's parameter names, in order."""
    return [p.split()[-1].lstrip("*") for p in _c_params(SOURCE, fn)]


class RecordingLib:
    """Stands in for the built library: records each launch's arguments by
    the C parameter names, and the squares' host arrays while they live."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        names = _names(fn)

        def launch(*args):
            assert len(args) == len(names), (fn, len(args))
            call = dict(zip(names, args), fn=fn)
            if fn == "grad_sq_norms_launch":
                k = call["n_tensors"]
                call.update(ptrs=list((ctypes.c_void_p * k).from_address(call["grads"])),
                            sizes=list((ctypes.c_longlong * k).from_address(call["numels"])),
                            flags=list((ctypes.c_int * k).from_address(call["aligned"])))
            self.calls.append(call)
            return 0
        return launch


@pytest.fixture
def lib(monkeypatch):
    """The wrappers on CPU tensors, as on the card: the stand-in library,
    PyTorch's CUDA calls stood in, and every cache empty."""
    fake = RecordingLib()
    monkeypatch.setattr(kp, "_library", lambda: fake)
    monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    monkeypatch.setattr(kp, "_TICKETS", {})
    monkeypatch.setattr(kp, "_HEAD_SCALARS", {})
    monkeypatch.setattr(kp, "_SQ_TABLE", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return fake


def _packed_rows(n: int, d: int, a: int = 4, seed: int = 0):
    """Logits, values and the packed minibatch ``[n, d + 4]`` whose last four
    columns are action, logp_old, adv and v_target."""
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randn((n, d + 4), generator=gen)
    rows[:, d] = torch.randint(0, a, (n,), generator=gen).float()
    return torch.randn((n, a), generator=gen), torch.randn(n, generator=gen), rows


def _cols(rows, d: int):
    return rows[:, d], rows[:, d + 1], rows[:, d + 2], rows[:, d + 3]


# -- the loss head ----------------------------------------------------------------------
CASE_WIDTHS = sorted({int(label) for label, width in re.findall(
    r"case (\d+): return f\(std::integral_constant<int, (\d+)>", SOURCE) if label == width})


@pytest.mark.parametrize("n_actions", range(1, kp.MAX_ACTIONS + 1))
def test_loss_launcher_has_the_padded_width_of_every_row(lib, n_actions):
    width = 1 << (n_actions - 1).bit_length()  # the next power of two: PyTorch's warp softmax
    assert width in CASE_WIDTHS and n_actions <= width < 2 * n_actions
    assert CASE_WIDTHS == [1 << k for k in range(kp.MAX_ACTIONS.bit_length())]
    logits, values, rows = _packed_rows(8, 8, a=n_actions)
    kp.ppo_loss_fwd(logits, values, *_cols(rows, 8), PPOConfig())
    kp.ppo_loss_bwd(logits, values, *_cols(rows, 8), torch.ones(()), PPOConfig())
    assert [(c["fn"], c["n_actions"]) for c in lib.calls] == [
        ("ppo_loss_fwd_launch", n_actions), ("ppo_loss_bwd_launch", n_actions)]


def _layout(case: str, n: int = 6):
    """Four columns laid out as ``case`` says, and whether they are packed."""
    if case in ("obs4", "obs8"):
        d = int(case[3:])
        return _cols(_packed_rows(n, d)[2], d), True
    rows = torch.randn(n, 13)
    if case == "spread":  # one stride, not side by side
        return (rows[:, 0], rows[:, 2], rows[:, 4], rows[:, 6]), False
    if case == "reordered":  # side by side, in another order
        return (rows[:, 1], rows[:, 0], rows[:, 2], rows[:, 3]), False
    if case == "unequal_strides":  # a column of another tensor, adjacent in memory by chance
        cols = _cols(_packed_rows(n, 8)[2], 8)
        return (cols[0], cols[1], cols[2], cols[3].contiguous()), False
    if case == "stride_off_16_bytes":  # side by side, 13 floats a row
        return (rows[:, 4], rows[:, 5], rows[:, 6], rows[:, 7]), False
    assert case == "base_off_16_bytes"  # 12 floats a row, storage offset 1
    shifted = torch.randn(n * 12 + 1)[1:].view(n, 12)
    return _cols(shifted, 8), False


@pytest.mark.parametrize("case", ["obs4", "obs8", "spread", "reordered", "unequal_strides",
                                  "stride_off_16_bytes", "base_off_16_bytes"])
def test_columns_take_the_float4_loads_only_side_by_side_on_16_bytes(lib, case):
    cols, packed = _layout(case)
    assert kp.columns_packed(*cols) is packed
    if packed:
        assert cols[0].data_ptr() % 16 == 0 and cols[0].stride(0) % 4 == 0
    logits, values, _ = _packed_rows(cols[0].shape[0], 8)
    kp.ppo_loss_fwd(logits, values, *cols, PPOConfig())
    (call,) = lib.calls
    assert call["packed"] == int(packed)
    assert [call[k] for k in ("action", "logp_old", "adv", "ret")] == [c.data_ptr() for c in cols]
    assert [call[k] for k in ("s_action", "s_logp", "s_adv", "s_ret")] == [
        c.stride(0) for c in cols]


@pytest.mark.parametrize("rows", [1, 64, 256, 257, 16383, 16384])
def test_loss_scratch_only_past_one_block(lib, rows):
    logits, values, packed = _packed_rows(rows, 8)
    before = kernels.LAUNCHES["ppo_loss_fwd"]
    loss, metrics = kp.ppo_loss_fwd(logits, values, *_cols(packed, 8), PPOConfig())
    (call,) = lib.calls
    assert kernels.LAUNCHES["ppo_loss_fwd"] == before + 1
    blocks = -(-rows // kp.THREADS)
    if blocks == 1:
        assert call["partials"] == call["ticket"] == 0
    else:
        partials, ticket = kp._TICKETS[(torch.device("cpu"), None)]
        assert call["partials"] == partials.data_ptr() and call["ticket"] == ticket.data_ptr()
        assert partials.numel() >= blocks * len(kp.METRICS) and ticket.dtype == torch.int32
    assert loss.shape == () and metrics.shape == (len(kp.METRICS),)
    assert loss._base is metrics._base and loss._base.shape == (1 + len(kp.METRICS),)
    assert call["out"] == loss.data_ptr() == metrics.data_ptr() - 4
    assert call["inv_n"] == pytest.approx(1.0 / rows, rel=1e-7) and call["n"] == rows


def test_head_scalars_are_rounded_once_per_config_and_rows(lib):
    logits, values, rows = _packed_rows(64, 8)
    cfg = PPOConfig(clip_eps=0.1)
    first = kp._head_args(logits, values, *_cols(rows, 8), cfg, "ppo_loss_fwd")[2]
    assert kp._head_args(logits, values, *_cols(rows, 8), cfg, "ppo_loss_fwd")[2] is first
    assert first == tuple(float(torch.tensor(x, dtype=torch.float32))
                          for x in (0.9, 1.1, 3.0, 0.5, 0.01, 1 / 64))
    other = kp._head_args(logits[:32], values[:32], *_cols(rows[:32], 8), cfg, "x")[2]
    assert other[-1] == float(torch.tensor(1 / 32)) and other[:-1] == first[:-1]
    assert len(kp._HEAD_SCALARS) == 2


def test_head_loss_views_carry_autograd_and_an_in_place_metrics_update(monkeypatch):
    """``PPOHeadLoss`` with stand-ins that, as the kernels, return the loss
    and metrics as views of one ``f32[6]``: the loss backpropagates, the
    metrics do not, and the mesh's in-place mean of the metrics is taken.
    The backward launches from what the forward's ``_head_args`` returned
    (here the inputs themselves, which the stand-ins compute from)."""
    from gymrl_tpu_torch.algos.ppo import ppo_head_loss_plain

    def fwd(dev, args):
        loss, metrics = ppo_head_loss_plain(*args)
        out = torch.cat([loss.detach().reshape(1), metrics])
        return out[0], out[1:]

    def bwd(logits, values, args, grad_out):
        lg, v = logits.detach().requires_grad_(True), values.detach().requires_grad_(True)
        with torch.enable_grad():  # a backward runs without grad
            loss, _ = ppo_head_loss_plain(lg, v, *args[2:])
            return torch.autograd.grad(loss * grad_out, (lg, v))

    made = []

    def head_args(*inputs_cfg_what):
        made.append(inputs_cfg_what[:-1])
        return made[-1]

    monkeypatch.setattr(kp, "_head_args", head_args)
    monkeypatch.setattr(kp, "_loss_fwd", fwd)
    monkeypatch.setattr(kp, "_loss_bwd", lambda logits, values, args, grad_out: (
        made.append(args), bwd(logits, values, args, grad_out))[1])
    logits, values, rows = _packed_rows(16, 8)
    lg, v = logits.clone().requires_grad_(True), values.clone().requires_grad_(True)
    loss, metrics = kp.PPOHeadLoss.apply(lg, v, *_cols(rows, 8), PPOConfig())
    assert loss.requires_grad and not metrics.requires_grad
    loss.backward()
    assert len(made) == 2 and made[1] is made[0]  # one _head_args, its result reused
    want = bwd(logits, values, (logits, values, *_cols(rows, 8), PPOConfig()), torch.ones(()))
    assert torch.equal(lg.grad, want[0]) and torch.equal(v.grad, want[1])
    metrics.copy_(torch.arange(5.0))  # as Mesh.mean_ writes the averaged metrics back
    assert metrics.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]


# -- the squares ---------------------------------------------------------------------------
def _views(sizes, offsets):
    """1-D views of one buffer, view i at ``offsets[i]`` floats past a
    multiple of 16 bytes."""
    starts, at = [], 0
    for n, off in zip(sizes, offsets):
        starts.append(at + off)
        at += -(-(off + n) // 4) * 4
    buffer = torch.randn(at)
    assert buffer.data_ptr() % 16 == 0
    return [buffer[s:s + n] for s, n in zip(starts, sizes)]


def test_squares_table_flags_alignment_and_keeps_each_tail(lib):
    sizes = (4099, 2050, 7, 4097, 1, 2048, 6001, 65539)
    offsets = (0, 1, 2, 3, 0, 1, 0, 3)
    grads = _views(sizes, offsets)
    assert [g.storage_offset() % 4 for g in grads] == list(offsets)
    sq = kp.grad_sq_norms(grads)
    (call,) = lib.calls
    assert call["ptrs"] == [g.data_ptr() for g in grads]
    assert call["sizes"] == list(sizes)  # the kernel takes each numel % 4 tail one float a time
    assert call["flags"] == [int(o == 0) for o in offsets]
    assert call["n_tensors"] == len(grads) and call["sq"] == sq.data_ptr()
    partials, ticket = kp._TICKETS[(torch.device("cpu"), None)]
    assert partials.numel() >= sum(-(-n // kp.CHUNK) for n in sizes)
    assert call["partials"] == partials.data_ptr() and call["ticket"] == ticket.data_ptr()


def test_squares_table_is_reused_only_while_addresses_and_sizes_hold(lib, monkeypatch):
    monkeypatch.setattr(kp, "MAX_TENSORS", 3)
    grads = [torch.randn(n) for n in (5, 2049, 3, 8, 1)]
    kp.grad_sq_norms(grads)
    tables = [c["grads"] for c in lib.calls]
    kp.grad_sq_norms(grads)
    assert [c["grads"] for c in lib.calls[2:]] == tables  # the same host arrays
    fresh = [g.clone() for g in grads]
    kp.grad_sq_norms(fresh)
    assert [p for c in lib.calls[4:] for p in c["ptrs"]] == [g.data_ptr() for g in fresh]
    shrunk = grads[:4] + [grads[4][:0].new_ones(1)]
    kp.grad_sq_norms(shrunk)
    assert [p for c in lib.calls[6:] for p in c["ptrs"]] == [g.data_ptr() for g in shrunk]
    assert [n for c in lib.calls[6:] for n in c["sizes"]] == [5, 2049, 3, 8, 1]
    kp.grad_sq_norms(grads)
    assert [p for c in lib.calls[8:] for p in c["ptrs"]] == [g.data_ptr() for g in grads]
    assert [c["n_tensors"] for c in lib.calls] == [3, 2] * 5


def test_scratch_is_one_per_device_and_stream(monkeypatch):
    made = []

    def on_cpu(factory):
        def make(*args, **kw):
            kw.pop("device")
            made.append(factory(*args, **kw))
            return made[-1]
        return make

    monkeypatch.setattr(kp, "_TICKETS", {})
    monkeypatch.setattr(torch, "empty", on_cpu(torch.empty))
    monkeypatch.setattr(torch, "zeros", on_cpu(torch.zeros))
    stream = {"now": 5}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=stream["now"] + 10 * d.index))
    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
    a = kp._scratch(card0, 100)
    assert kp._scratch(card0, 60) is a  # the same stream: reused in its order
    stream["now"] = 6
    b = kp._scratch(card0, 100)
    c = kp._scratch(card1, 100)
    assert len({id(a), id(b), id(c)}) == 3 and set(kp._TICKETS) == {
        (card0, 5), (card0, 6), (card1, 16)}
    grown = kp._scratch(card1, 500)  # larger partials, the same ticket (it is back at 0)
    assert grown[0].numel() == 500 and grown[1] is c[1]
    assert all(t[1].dtype == torch.int32 and int(t[1]) == 0 for t in kp._TICKETS.values())
    assert all(t[0].dtype == torch.float64 for t in kp._TICKETS.values())


# -- launch and bindings --------------------------------------------------------------------
@pytest.mark.parametrize("current", [2, 0])
def test_launch_enters_the_device_only_when_it_is_not_current(monkeypatch, current):
    entered = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", lambda d: entered.append(d)
                        or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1000 + d.index))
    seen = []
    kp._launch(lambda *args: seen.append(args) or 0, [3], torch.device("cuda", 2), "x")
    assert seen == [(3, 2, 1002)]
    assert entered == ([] if current == 2 else [torch.device("cuda", 2)])


@pytest.mark.parametrize("fn,argtypes,names", [
    ("ppo_loss_fwd_launch", kp.LOSS_FWD_ARGTYPES,
     ["logits", "values", "action", "logp_old", "adv", "ret", "out", "partials", "ticket", "n",
      "n_actions", "s_action", "s_logp", "s_adv", "s_ret", "packed", "lo", "hi", "dual_clip",
      "value_coef", "entropy_coef", "inv_n", "device", "stream"]),
    ("grad_sq_norms_launch", kp.SQ_NORMS_ARGTYPES,
     ["grads", "numels", "aligned", "n_tensors", "sq", "partials", "ticket", "device", "stream"])])
def test_redesigned_launchers_bind_by_ctypes(fn, argtypes, names):
    params = _c_params(SOURCE, fn)
    assert [_ctype(p) for p in params] == argtypes
    assert _names(fn) == names


def test_source_uses_the_build_defines_and_their_shapes():
    used = set(re.findall(r"\bPPO_[A-Z0-9_]*[A-Z0-9]\b", SOURCE))
    assert used == set(kp.defines())
    # the kernel's static_asserts, on the values the build passes
    assert kp.CHUNK % (4 * kp.THREADS) == 0  # whole float4 loads a thread
    assert kp.MAX_TENSORS <= 32  # the alignment flags fit the kernel's bit mask
    assert kp.MAX_ACTIONS == 32 and kp.THREADS % 32 == 0
    assert (kp.THREADS // 32) & (kp.THREADS // 32 - 1) == 0
