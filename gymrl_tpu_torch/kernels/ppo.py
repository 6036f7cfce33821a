"""PPO's update kernels (``ppo.cu``) and their wrappers.

One grad step of ``PPOTrainer._sgd`` on a CUDA device runs four kernels
around PyTorch's MLP forward and backward:

  * ``ppo_loss_fwd`` / ``ppo_loss_bwd`` (``PPOHeadLoss``): the dual-clip
    loss head after the net, its five metrics, and its gradient with
    respect to the logits and values. Plain version:
    ``algos.ppo.ppo_head_loss_plain`` and autograd.
  * ``grad_sq_norms`` / ``clip_adam``: each gradient's squared norm, then
    the global-norm clip and ``torch.optim.Adam``'s update of the same
    param, ``exp_avg`` and ``exp_avg_sq`` tensors, in place. Plain version:
    ``algos.base.clip_adam_plain_``.

The recurrent and full-tricks trainers' grad step (``algos.base.grad_step``)
runs ``clip_adam`` alone after the plain clip, its own clip off
(``algos.base.clip_adam_plain_norm_``). The dispatch
(``algos.ppo.ppo_head_loss``, ``algos.base.clip_adam_``,
``clip_adam_plain_norm_``) sends CUDA tensors here and CPU tensors to the
plain versions. A wrapper refuses
a CPU tensor, launches its kernel or raises, and adds one to
``kernels.LAUNCHES[name]`` where it launches.

The kernels read the loss's columns (action, logp_old, adv, v_target) where
they lie in the packed minibatch (``columns_packed``: one float4 a row where
they sit side by side on 16 bytes, else each at its stride), and the
optimizer's tables by value, so a step copies nothing to the card.
Reductions are deterministic (``ppo.cu``). What a wrapper can reuse from one
call to the next it keeps: the loss's float32 scalars per config and row
count, the squares' ctypes table while the gradients keep their addresses
and sizes, ``clip_adam``'s table while nothing it was built from changes
(``_AdamTable``), and the float64 partials and ticket of the reductions
across blocks per (device, stream). Adam's state stays in
``torch.optim.Adam``: ``clip_adam`` counts each parameter's CPU ``step`` as
Adam does and computes its bias corrections on the host in double, as Adam
does, once per distinct step count, so checkpoints and every reader of
``opt.state`` see what the plain step leaves. One difference: the plain clip
scales ``p.grad`` in place, the kernel reads it and leaves it unscaled.

A sweep captured into a CUDA graph (``algos.base.SweepGraph``) replays its
launches with the arguments they had at capture, so there ``clip_adam``
reads its step terms from the card (``device_terms``: one ``(step_size,
bc2)`` pair a grad step, which ``adam_run_terms`` computes before each
replay) and leaves the step counts to the replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import operator
import os

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.kernels import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ppo.cu")

THREADS = 256  # threads per block
BWD_THREADS = 128  # threads (rows) per block of ppo_loss_bwd: 16,384 rows are 128 blocks
CHUNK = 2048  # parameters per block of grad_sq_norms
ADAM_CHUNK = 1024  # parameters per block of clip_adam: one float4 of each array a thread
MAX_TENSORS = 32  # tensors per multi-tensor launch (their table is a kernel argument)
MAX_ACTIONS = 32  # the loss's widest row of logits

METRICS = ("policy_loss", "value_loss", "entropy", "clip_frac", "approx_kl")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C launchers' parameters in order (``ppo.cu``, ``extern "C"``).
LOSS_FWD_ARGTYPES = [_P] * 9 + [_I] * 7 + [_F] * 6 + [_I, _P]
LOSS_BWD_ARGTYPES = [_P] * 9 + [_I] * 8 + [_F] * 6 + [_I, _P]
SQ_NORMS_ARGTYPES = [_P, _P, _P, _I, _P, _P, _P, _I, _P]
CLIP_ADAM_ARGTYPES = [_P] * 9 + [_I, _P, _I] + [_F] * 5 + [_I, _I, _P]

_LIB: ctypes.CDLL | None = None
# The float64 partials and the self-resetting int32 ticket of the last-block reductions
# (grad_sq_norms, ppo_loss_fwd past one block) per (device, stream): launches on one stream
# run in order, so they share them.
_TICKETS: dict[tuple[torch.device, int | None], tuple[torch.Tensor, torch.Tensor]] = {}
# The loss's float32 scalars per (clip_eps, dual_clip, value_coef, entropy_coef, n).
_HEAD_SCALARS: dict[tuple, tuple[float, ...]] = {}
# grad_sq_norms's launches for the last gradient table: (key, [(ctypes arrays, piece,
# chunks)]), the key each tensor's (address, numel) and MAX_TENSORS.
_SQ_TABLE: tuple[tuple, list] | None = None
# clip_adam's launches for the last optimizer and gradients (``_AdamTable``).
_ADAM_TABLE: "_AdamTable | None" = None
# While a sweep is captured (``device_terms``): the step terms on the card and the pairs taken.
_RUN_TERMS: "_TermsRun | None" = None


def defines() -> dict[str, str]:
    return {"PPO_THREADS": str(THREADS), "PPO_BWD_THREADS": str(BWD_THREADS),
            "PPO_CHUNK": str(CHUNK),
            "PPO_ADAM_CHUNK": str(ADAM_CHUNK), "PPO_MAX_TENSORS": str(MAX_TENSORS),
            "PPO_MAX_ACTIONS": str(MAX_ACTIONS)}


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("ppo", SOURCE, defines())
        for fn, argtypes in (("ppo_loss_fwd_launch", LOSS_FWD_ARGTYPES),
                             ("ppo_loss_bwd_launch", LOSS_BWD_ARGTYPES),
                             ("grad_sq_norms_launch", SQ_NORMS_ARGTYPES),
                             ("clip_adam_launch", CLIP_ADAM_ARGTYPES)):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _scratch(device: torch.device, chunks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The partials (at least ``chunks`` float64) and ticket of the
    last-block reductions on the current stream of ``device`` (off the card,
    which only the CPU tests' stand-ins reach, one pair per device)."""
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None
    key = (device, stream)
    held = _TICKETS.get(key)
    if held is None or held[0].numel() < chunks:
        ticket = held[1] if held else torch.zeros(1, dtype=torch.int32, device=device)
        held = _TICKETS[key] = (torch.empty(chunks, dtype=torch.float64, device=device), ticket)
    return held


_launch = kernels.launch


def _check_device(x: torch.Tensor, what: str, plain: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel, but its input is on {x.device}; "
                         f"the plain version is {plain}")


def _expect(name: str, x: torch.Tensor, shape: tuple, device: torch.device,
            contiguous: bool = True) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the batch on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} is {x.dtype}, the kernel takes torch.float32")
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, the kernel takes {shape}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _f32(x: float) -> float:
    return float(np.float32(x))


# -- the loss head ------------------------------------------------------------------


def _head_args(logits, values, action, logp_old, adv, returns, cfg,
               what: str) -> tuple[list, list, tuple]:
    """The loss launchers' arguments but their outputs: the inputs'
    addresses, checked (the four columns as 1-D views at any stride), their
    sizes, strides and ``columns_packed`` flag, and the scalars as the plain
    path rounds them."""
    _check_device(logits, what, "algos.ppo.ppo_head_loss_plain")
    dev = logits.device
    if logits.dim() != 2 or not 1 <= logits.shape[1] <= MAX_ACTIONS or logits.shape[0] < 1:
        raise ValueError(f"logits have shape {tuple(logits.shape)}; the kernel takes [n, A] "
                         f"with n >= 1 and 1 <= A <= {MAX_ACTIONS}")
    n, a = logits.shape
    _expect("logits", logits, (n, a), dev)
    _expect("values", values, (n,), dev)
    columns = (action, logp_old, adv, returns)
    for name, x in zip(("action", "logp_old", "adv", "returns"), columns):
        _expect(name, x, (n,), dev, contiguous=False)
    key = (cfg.clip_eps, cfg.dual_clip, cfg.value_coef, cfg.entropy_coef, n)
    floats = _HEAD_SCALARS.get(key)
    if floats is None:
        floats = _HEAD_SCALARS[key] = (
            _f32(1.0 - cfg.clip_eps), _f32(1.0 + cfg.clip_eps), _f32(cfg.dual_clip),
            _f32(cfg.value_coef), _f32(cfg.entropy_coef), _f32(1.0 / n))
    return ([logits.data_ptr(), values.data_ptr(), *(x.data_ptr() for x in columns)],
            [n, a, *(x.stride(0) for x in columns), int(columns_packed(*columns))], floats)


def columns_packed(action, logp_old, adv, returns) -> bool:
    """Whether the four columns lie side by side at one stride, the first on
    16 bytes and the stride a multiple of 4 floats, so that each row's four
    are one aligned float4 (``mb[:, d:d + 4]`` of a packed minibatch whose
    row, ``d + 4`` floats, is a multiple of 4: obs 4 and 8)."""
    s, p = action.stride(0), action.data_ptr()
    return (s % 4 == 0 and p % 16 == 0
            and logp_old.stride(0) == s and adv.stride(0) == s and returns.stride(0) == s
            and logp_old.data_ptr() == p + 4 and adv.data_ptr() == p + 8
            and returns.data_ptr() == p + 12)


def row_vectors(logits: torch.Tensor, dlogits: torch.Tensor) -> bool:
    """Whether ``ppo_loss_bwd`` moves each row of ``logits`` and ``dlogits``
    ``[n, A]`` as one vector: A is a power of two, at least 2 (the kernel's
    padded width P equals A; a float2 a row at A = 2, A / 4 float4 from
    A = 4), and both lie on 4·A bytes, so every row does."""
    a = logits.shape[1]
    return (a >= 2 and a & (a - 1) == 0
            and logits.data_ptr() % (4 * a) == 0 and dlogits.data_ptr() % (4 * a) == 0)


def _loss_fwd(dev: torch.device, args: tuple[list, list, tuple]):
    """The ``ppo_loss_fwd`` launch from ``_head_args``'s ``args``."""
    ptrs, ints, floats = args
    out = torch.empty(1 + len(METRICS), dtype=torch.float32, device=dev)
    n = ints[0]
    partials, ticket = _scratch(dev, -(-n // THREADS) * len(METRICS)) if n > THREADS else (0, 0)
    _launch(_library().ppo_loss_fwd_launch,
            [*ptrs, out.data_ptr(), partials, ticket, *ints, *floats], dev, "ppo_loss_fwd")
    kernels.LAUNCHES["ppo_loss_fwd"] += 1
    return out[0], out[1:]


def _loss_bwd(logits, values, args: tuple[list, list, tuple], grad_out):
    """The ``ppo_loss_bwd`` launch from ``_head_args``'s ``args`` (of these
    ``logits`` and ``values``)."""
    ptrs, ints, floats = args
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    _launch(_library().ppo_loss_bwd_launch,
            [*ptrs, grad_out, dlogits, dvalues, *ints, int(row_vectors(logits, dlogits)),
             *floats], logits.device, "ppo_loss_bwd")
    kernels.LAUNCHES["ppo_loss_bwd"] += 1
    return dlogits, dvalues


def ppo_loss_fwd(logits, values, action, logp_old, adv, returns, cfg):
    """``algos.ppo.ppo_head_loss_plain``'s ``(loss f32[], metrics f32[5])``, in one
    launch, both views of one ``f32[6]``. ``action`` is float32, as the packed
    minibatch holds it."""
    return _loss_fwd(logits.device, _head_args(logits, values, action, logp_old, adv, returns,
                                               cfg, "ppo_loss_fwd"))


def ppo_loss_bwd(logits, values, action, logp_old, adv, returns, grad_out, cfg):
    """The gradient of ``ppo_loss_fwd``'s loss times ``grad_out`` (f32[], on
    the card) with respect to ``logits`` and ``values``, in one launch."""
    args = _head_args(logits, values, action, logp_old, adv, returns, cfg, "ppo_loss_bwd")
    _expect("grad_out", grad_out, (), logits.device)
    return _loss_bwd(logits, values, args, grad_out)


class PPOHeadLoss(torch.autograd.Function):
    """``algos.ppo.ppo_head_loss_plain`` on the card: forward ``ppo_loss_fwd``,
    backward ``ppo_loss_bwd``, which launches from the arguments the forward
    checked and computed. The metrics are not differentiable."""

    @staticmethod
    def forward(ctx, logits, values, action, logp_old, adv, returns, cfg):
        args = _head_args(logits, values, action, logp_old, adv, returns, cfg, "ppo_loss_fwd")
        loss, metrics = _loss_fwd(logits.device, args)
        ctx.save_for_backward(logits, values, action, logp_old, adv, returns)
        ctx.args = args
        ctx.mark_non_differentiable(metrics)
        return loss, metrics

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_loss, grad_metrics):
        # the saved inputs hold the addresses alive, and unpacking them refuses one modified
        # in place since the forward; autograd hands grad_loss as the loss is: f32[] on the card
        logits, values, *_ = ctx.saved_tensors
        dlogits, dvalues = _loss_bwd(logits, values, ctx.args, grad_loss)
        return dlogits, dvalues, None, None, None, None, None


# -- the global-norm clip with Adam --------------------------------------------------


def _pieces(n: int) -> list[slice]:
    """The multi-tensor launches of a table of ``n`` tensors, in order."""
    return [slice(a, min(a + MAX_TENSORS, n)) for a in range(0, n, MAX_TENSORS)]


def _chunks(numel: int) -> int:
    return -(-numel // CHUNK)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


_data_ptr, _numel = torch.Tensor.data_ptr, torch.Tensor.numel
_DEVICE, _DTYPE = operator.attrgetter("device"), operator.attrgetter("dtype")


def _check_grads(grads: list[torch.Tensor], what: str) -> tuple[torch.device, tuple]:
    """The gradients' device, and their ``(address, numel)`` each; refuses
    what the kernels do not take (a C-level pass, and on a refusal the
    per-tensor pass that names it)."""
    if not grads:
        raise ValueError(f"{what}: no gradients")
    if grads[0] is None:
        raise ValueError(f"{what}: a gradient is None")
    _check_device(grads[0], what, "algos.base.clip_adam_plain_")
    dev = grads[0].device
    try:
        ptrs, numels = tuple(map(_data_ptr, grads)), tuple(map(_numel, grads))
        ok = (all(d == dev for d in map(_DEVICE, grads))
              and all(t is torch.float32 for t in map(_DTYPE, grads))
              and all(map(torch.Tensor.is_contiguous, grads)) and all(numels))
    except TypeError:  # a None among them
        ok = False
    if not ok:
        for i, g in enumerate(grads):
            if g is None:
                raise ValueError(f"{what}: a gradient is None")
            if g.device != dev:
                raise ValueError(f"grads[{i}] is on {g.device}, the batch on {dev}")
            if g.dtype != torch.float32:
                raise TypeError(f"grads[{i}] is {g.dtype}, the kernel takes torch.float32")
            if not g.is_contiguous():
                raise ValueError(f"grads[{i}] is not contiguous")
            if g.numel() == 0:
                raise ValueError(f"grads[{i}] is empty")
    return dev, tuple(zip(ptrs, numels))


def _sq_table(key: tuple) -> list:
    """grad_sq_norms's launches for the gradients ``key`` describes: per
    piece of ``MAX_TENSORS``, the host arrays of addresses, sizes and
    alignment flags (1 where the address lies on 16 bytes: float4 loads),
    the piece, and its chunks (blocks). Built again when any address or size
    changed, so a stale table never reaches a launch."""
    global _SQ_TABLE
    key = (MAX_TENSORS, key)
    if _SQ_TABLE is None or _SQ_TABLE[0] != key:
        launches = []
        for piece in _pieces(len(key[1])):
            part = key[1][piece]
            arrays = ((ctypes.c_void_p * len(part))(*(p for p, _ in part)),
                      (ctypes.c_longlong * len(part))(*(n for _, n in part)),
                      (ctypes.c_int * len(part))(*(int(p % 16 == 0) for p, _ in part)))
            launches.append((arrays, piece, sum(_chunks(n) for _, n in part)))
        _SQ_TABLE = (key, launches)
    return _SQ_TABLE[1]


def grad_sq_norms(grads: list[torch.Tensor]) -> torch.Tensor:
    """f32[len(grads)]: each gradient's squared norm (what
    ``torch._foreach_norm`` gives the clip, squared), summed in float64 in a
    fixed order; one launch per ``MAX_TENSORS`` tensors."""
    dev, key = _check_grads(grads, "grad_sq_norms")
    sq = torch.empty(len(grads), dtype=torch.float32, device=dev)
    lib = _library()
    launches = _sq_table(key)
    partials, ticket = _scratch(dev, max(chunks for _, _, chunks in launches))
    for arrays, piece, _ in launches:
        _launch(lib.grad_sq_norms_launch,
                [*map(ctypes.addressof, arrays), piece.stop - piece.start,
                 sq.data_ptr() + 4 * piece.start, partials, ticket],
                dev, "grad_sq_norms")
        kernels.LAUNCHES["grad_sq_norms"] += 1
    return sq


def _adam_scalars(group: dict) -> tuple[float, float, float, bool]:
    """(beta1, beta2, eps, foreach) of the param group, which the kernel
    computes as ``torch.optim.Adam`` does; raises on an option it does not
    implement."""
    for key, plain in (("amsgrad", False), ("weight_decay", 0), ("maximize", False),
                       ("capturable", False), ("differentiable", False),
                       ("decoupled_weight_decay", False)):
        if group.get(key, plain) != plain:
            raise ValueError(f"clip_adam implements Adam without {key}={group[key]}")
    if group.get("fused"):
        raise ValueError("clip_adam implements the foreach and per-tensor Adam, not fused")
    beta1, beta2 = group["betas"]
    # foreach=None is the default, which is foreach for parameters on the card
    return float(beta1), float(beta2), float(group["eps"]), group.get("foreach") is not False


def adam_step_terms(step: float, lr: float, beta1: float, beta2: float,
                    foreach: bool) -> tuple[float, float]:
    """The kernel's ``(step_size, bc2)`` for one step count, as
    ``torch.optim.Adam`` computes them on the host in double
    (``_single_tensor_adam`` / ``_multi_tensor_adam``), each rounded once to
    float32 where the launch stores it: ``step_size = -(lr / bias_correction1)``;
    ``bc2 = sqrt(bias_correction2)``, which foreach divides by, or its double
    reciprocal, since one tensor at a time ``tensor / float`` multiplies by
    the reciprocal rounded to float32."""
    bias_correction2_sqrt = (1 - beta2 ** step) ** 0.5
    return (_f32(-(lr / (1 - beta1 ** step))),
            _f32(bias_correction2_sqrt if foreach else 1.0 / bias_correction2_sqrt))


def aligned_flags(*tables: list[torch.Tensor]) -> list[int]:
    """Per tensor, 1 where its address in every one of ``tables`` lies on
    16 bytes (the kernel then moves it as float4), else 0."""
    return [int(all(t.data_ptr() % 16 == 0 for t in row)) for row in zip(*tables)]


# The step counts Adam may hold, by dtype.
_STEP_CTYPES = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}

# The param group's entries that decide the launch besides the tensors and the lr.
_GROUP_OPTIONS = ("betas", "eps", "foreach", "amsgrad", "weight_decay", "maximize",
                  "capturable", "differentiable", "fused", "decoupled_weight_decay")


class _AdamTable:
    """clip_adam's launches for one optimizer and its gradients: per piece of
    ``MAX_TENSORS``, the host arrays of addresses, sizes, the step terms and
    the alignment flags. Built again when the key changes: any (address,
    numel) of the params, grads, ``exp_avg`` or ``exp_avg_sq``, the step
    tensors (by identity), the optimizer's state and param group (by
    identity: ``load_state_dict`` replaces both) or the group's options. The
    checks of the tensors and options run only then. It holds the objects
    its key names, so no identity in the key is reused while it lives."""

    def __init__(self, key, holds, opt, ps, grads, ms, vs, steps, dev):
        group = opt.param_groups[0]
        beta1, beta2, eps, foreach = _adam_scalars(group)
        for i, (p, g, m, v, t) in enumerate(zip(ps, grads, ms, vs, steps)):
            _expect(f"param {i}", p.data, tuple(g.shape), dev)
            _expect(f"exp_avg {i}", m, tuple(g.shape), dev)
            _expect(f"exp_avg_sq {i}", v, tuple(g.shape), dev)
            if t.device.type != "cpu":
                raise ValueError("clip_adam counts Adam's steps on the host (capturable is off)")
        self.key, self.holds = key, holds
        # each CPU step count as a ctypes scalar on its memory: +1 and a read without a
        # dispatch (a float32 count + 1 in double, rounded once, is the float32 sum)
        self.counts = []
        for t in steps:
            if t.dtype not in _STEP_CTYPES or t.numel() != 1:
                raise ValueError(f"clip_adam counts a float32 or float64 step, not {t.dtype}"
                                 f"{list(t.shape)}")
            self.counts.append(_STEP_CTYPES[t.dtype].from_address(t.data_ptr()))
        self.lr, self.beta1, self.beta2, self.foreach = float(group["lr"]), beta1, beta2, foreach
        self.scalars = (_f32(1 - beta1), _f32(beta2), _f32(1 - beta2), _f32(eps), int(foreach))
        flags = aligned_flags(ps, grads, ms, vs)
        self.launches = []
        for piece in _pieces(len(ps)):
            k = piece.stop - piece.start
            arrays = (_ptrs(ps[piece]), _ptrs(grads[piece]), _ptrs(ms[piece]), _ptrs(vs[piece]),
                      (ctypes.c_longlong * k)(*(p.numel() for p in ps[piece])),
                      (ctypes.c_float * k)(), (ctypes.c_float * k)(),
                      (ctypes.c_int * k)(*flags[piece]))
            self.launches.append((arrays, piece, k))

    def count_step(self) -> None:
        """Adam's step: one more on every CPU step count (as its
        ``_foreach_add_``), and each tensor's step terms, computed once per
        distinct count (in a trainer every parameter has the same)."""
        values = []
        for count in self.counts:
            count.value += 1.0
            values.append(count.value)
        if values.count(values[0]) == len(values):
            ss, b2 = adam_step_terms(values[0], self.lr, self.beta1, self.beta2, self.foreach)
            for arrays, _, k in self.launches:
                arrays[5][:], arrays[6][:] = [ss] * k, [b2] * k
            return
        terms: dict[float, tuple[float, float]] = {}
        for arrays, piece, _ in self.launches:
            for j, step in enumerate(values[piece]):
                both = terms.get(step)
                if both is None:
                    both = terms[step] = adam_step_terms(step, self.lr, self.beta1, self.beta2,
                                                         self.foreach)
                arrays[5][j], arrays[6][j] = both


def _adam_state(opt: torch.optim.Adam) -> tuple[dict, list, list, list, list]:
    """Adam's one param group, and its params, ``exp_avg``, ``exp_avg_sq``
    and ``step`` tensors in the group's order."""
    if len(opt.param_groups) != 1:
        raise ValueError(f"clip_adam steps one param group, not {len(opt.param_groups)}")
    group = opt.param_groups[0]
    ps = group["params"]
    try:
        states = list(map(opt.state.__getitem__, ps))
        ms = [s["exp_avg"] for s in states]
        vs = [s["exp_avg_sq"] for s in states]
        steps = [s["step"] for s in states]
    except KeyError:
        raise ValueError("clip_adam needs Adam's state made up front (algos.base.adam)") from None
    return group, ps, ms, vs, steps


def adam_key(opt: torch.optim.Adam) -> tuple[tuple, tuple]:
    """What ``clip_adam``'s launches read of ``opt`` but the group's lr: the
    optimizer's state and param group (by identity: ``load_state_dict``
    replaces both), the group's options, each (address, numel) of the params,
    ``exp_avg`` and ``exp_avg_sq``, and the step tensors (by identity). With
    it, the objects it names by identity, for the caller to hold while it
    keeps the key, so that no identity in it is reused."""
    return _adam_key(opt, *_adam_state(opt))


def _adam_key(opt, group, ps, ms, vs, steps) -> tuple[tuple, tuple]:
    key = (id(opt.state), id(group), tuple(map(group.get, _GROUP_OPTIONS)),
           tuple(map(_data_ptr, itertools.chain(ps, ms, vs))),
           tuple(map(_numel, itertools.chain(ps, ms, vs))), tuple(map(id, steps)))
    return key, (opt.state, group, steps)


def _adam_table(opt: torch.optim.Adam, grads: list[torch.Tensor], gkey: tuple,
                dev: torch.device) -> _AdamTable:
    """The cached table for ``opt`` and ``grads``, rebuilt (and checked)
    when its key changed."""
    global _ADAM_TABLE
    group, ps, ms, vs, steps = _adam_state(opt)
    if len(ps) != len(grads):
        raise ValueError(f"{len(grads)} gradients for {len(ps)} parameters")
    state_key, holds = _adam_key(opt, group, ps, ms, vs, steps)
    key = (MAX_TENSORS, ADAM_CHUNK, group["lr"], gkey, state_key)
    table = _ADAM_TABLE
    if table is None or table.key != key:
        table = _ADAM_TABLE = _AdamTable(key, holds, opt, list(ps), grads, ms, vs, steps, dev)
    return table


class _TermsRun:
    """The step terms of a captured sweep: ``terms`` f32[K, 2] on the card,
    and how many of its pairs the sweep's ``clip_adam`` calls have taken."""

    def __init__(self, terms: torch.Tensor):
        self.terms, self.taken = terms, 0

    def next_pair(self, dev: torch.device) -> int:
        if self.taken == self.terms.shape[0]:
            raise ValueError(f"the sweep steps Adam more than the {self.taken} times its "
                             "step terms hold")
        if self.terms.device != dev:
            raise ValueError(f"the step terms are on {self.terms.device}, the grads on {dev}")
        self.taken += 1
        return self.terms.data_ptr() + 8 * (self.taken - 1)


@contextlib.contextmanager
def device_terms(terms: torch.Tensor):
    """While a sweep is captured into a CUDA graph: grad step i's
    ``clip_adam`` reads its step terms from ``terms[i]`` (``(step_size,
    bc2)``; f32[K, 2], contiguous, on the card, filled before each replay
    from ``adam_run_terms``) and counts no step on the host, which the
    replay does. Yields the run, whose ``taken`` says how many grad steps
    took a pair."""
    global _RUN_TERMS
    if terms.dtype != torch.float32 or terms.dim() != 2 or terms.shape[1] != 2 \
            or not terms.is_contiguous():
        raise ValueError(f"step terms are f32[K, 2] contiguous, not {terms.dtype}"
                         f"{list(terms.shape)}")
    if _RUN_TERMS is not None:
        raise RuntimeError("a sweep is already being captured")
    run = _RUN_TERMS = _TermsRun(terms)
    try:
        yield run
    finally:
        _RUN_TERMS = None


def adam_run_terms(opt: torch.optim.Adam, k: int) -> tuple[np.ndarray, float]:
    """The step terms of ``opt``'s next ``k`` steps, f32[k, 2] of
    ``(step_size, bc2)`` at the group's lr, bit for bit what ``k``
    successive ``_AdamTable.count_step``s leave in the table, and the step
    count after them. Every tensor must hold the same count and dtype (a
    trainer's do): the pair then applies to the whole table."""
    group, _, _, _, steps = _adam_state(opt)
    beta1, beta2, _, foreach = _adam_scalars(group)
    first = steps[0]
    if first.dtype not in _STEP_CTYPES or first.numel() != 1 or first.device.type != "cpu":
        raise ValueError(f"clip_adam counts a float32 or float64 step on the host, not "
                         f"{first.dtype}{list(first.shape)} on {first.device}")
    count = _STEP_CTYPES[first.dtype](float(first))
    if any(t.dtype != first.dtype or float(t) != count.value for t in steps):
        raise ValueError("one pair of step terms needs every tensor at the same step count")
    lr = float(group["lr"])
    out = np.empty((k, 2), dtype=np.float32)
    for j in range(k):
        count.value += 1.0  # rounded to the step's dtype, as count_step's +1
        out[j] = adam_step_terms(count.value, lr, beta1, beta2, foreach)
    return out, count.value


def clip_adam(opt: torch.optim.Adam, grads: list[torch.Tensor], sq: torch.Tensor,
              max_norm: float) -> None:
    """The ``clip_adam`` kernel: the global norm from the squares ``sq``, the
    clip scale, and Adam's step of ``opt`` (one param group, as
    ``algos.base.adam`` builds it) with the scaled ``grads``, in place; one
    launch per ``MAX_TENSORS`` tensors. Adam's CPU ``step`` counts go up by
    one as Adam's do; the launch table is kept while nothing it was built
    from changes (``_AdamTable``). Under ``device_terms`` the launches read
    the next pair of step terms on the card, and the counts stay."""
    dev, gkey = _check_grads(grads, "clip_adam")
    _expect("sq", sq, (len(grads),), dev)
    table = _adam_table(opt, grads, gkey, dev)
    lib = _library()
    if _RUN_TERMS is None:
        table.count_step()  # CPU tensors: no sync with the card
        terms = None
    else:
        terms = _RUN_TERMS.next_pair(dev)
    n_sq, max_norm = len(grads), _f32(max_norm)
    for arrays, _, k in table.launches:
        _launch(lib.clip_adam_launch,
                [*map(ctypes.addressof, arrays[:7]), terms, ctypes.addressof(arrays[7]), k, sq,
                 n_sq, max_norm, *table.scalars],
                dev, "clip_adam")
        kernels.LAUNCHES["clip_adam"] += 1
