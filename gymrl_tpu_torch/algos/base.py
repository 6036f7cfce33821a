"""Shared trainer scaffolding (counterpart of ``gymrl_tpu/algos/base.py``).

A ``Trainer`` exposes:

  * ``init(seed) -> TrainState`` — build params, optimizer, env batch, noise
  * ``train_iter(ts) -> (ts, IterOut)`` — one iteration of the algorithm
  * ``policy(ts, obs, noise, deterministic) -> action`` — batched, for eval

The JAX trainers are pure and jitted; here ``train_iter`` updates the
parameters and optimizer held by ``ts`` in place (PyTorch's idiom),
returning the state with its new env batch and counters. The PPO
family's loops are the port's ``lax.scan``, written once: ``rollout_scan``,
``sweep`` and ``to_chunks``. They run eagerly, but for these parts: on a
CUDA device without a mesh, while ``trainer.graphs`` is True (the default),
the rollouts of ``PPOTrainer`` and ``PPOLSTMTrainer`` (``_rollout_route``,
``RolloutGraph``) and their sweeps (``_sweep_route``, ``SweepGraph``) are
each one replay of a captured CUDA graph. Everything under a mesh, the CPU,
and the other trainers' rollouts and updates run eagerly.

Under a ``mesh`` (``distributed/mesh.py``) each rank steps its share of the
env batch and computes its share of every minibatch. A rank's loss is its
share's mean, which is ``D`` times its part of the whole minibatch's mean,
so gradients and metrics are averaged over ``data`` before the clip and
the optimizer step, which then run replicated.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
from typing import Any, Callable, NamedTuple

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.core.noise import Noise, ShardedNoise
from gymrl_tpu_torch.distributed.mesh import constrain_batch, gather_pytree_batch
from gymrl_tpu_torch.kernels import ppo as ppo_kernels
from gymrl_tpu_torch.utils.device import resolve_device
from gymrl_tpu_torch.utils.logging import get_logger
from gymrl_tpu_torch.utils.profiling import span


class IterOut(NamedTuple):
    """Per-iteration outputs. ``ep_return[t, b]`` is valid where ``ep_done[t, b]``."""

    ep_return: torch.Tensor  # f32[T, B]
    ep_length: torch.Tensor  # i32[T, B]
    ep_done: torch.Tensor  # bool[T, B]
    metrics: dict[str, torch.Tensor]  # scalars, already averaged over the iter


# Called with a phase's name as that phase of train_iter ends.
PhaseTimer = Callable[[str], None]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8,
                mesh=None) -> torch.Tensor:
    """Mean over entries where mask (reference ppo_lstm_lunarlander.py:646-655).

    Under a ``mesh`` with ``D > 1`` data ranks, ``x`` is one rank's share of
    a minibatch and the shares hold different numbers of active entries, so
    the count is summed over ``data`` (one all-reduce) and the result is
    ``D·Σ_share / (count + eps)``: averaged over the ranks, the whole
    minibatch's masked mean."""
    mask = mask.to(x.dtype)
    if mesh is None or mesh.data_size == 1:
        return (x * mask).sum() / (mask.sum() + eps)
    count = mesh.sum_(mask.sum().detach())
    return (x * mask).sum() * float(mesh.data_size) / (count + eps)


def pack_fields(data: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """A dict of ``[n, ...]`` tensors as ONE ``[n, F]`` float32 matrix and
    its layout, keys in sorted order, so an epoch's shuffle is one row
    gather. Integer fields ride through float32 exactly for |v| < 2^24
    (actions and indices here); ``unpack_fields`` restores the dtypes."""
    spec, cols, off = {}, [], 0
    for k in sorted(data):
        x = data[k]
        if x.dtype not in (torch.float32, torch.int32, torch.bool):
            raise TypeError(f"{k}: {x.dtype} does not ride exactly through float32")
        flat = x.reshape(x.shape[0], -1)
        spec[k] = (off, off + flat.shape[1], tuple(x.shape[1:]), x.dtype)
        off += flat.shape[1]
        cols.append(flat.float())
    return torch.cat(cols, dim=1), spec


def unpack_fields(rows: torch.Tensor, spec: dict) -> dict[str, torch.Tensor]:
    """Inverse of ``pack_fields`` for an ``[m, F]`` block of packed rows."""
    return {k: rows[:, a:b].reshape((rows.shape[0],) + shape).to(dtype)
            for k, (a, b, shape, dtype) in spec.items()}


def clip_grads_by_global_norm_(grads: list[torch.Tensor], max_norm: float, mesh=None,
                               split: list[bool] | None = None) -> torch.Tensor:
    """optax ``clip_by_global_norm``, in place: ``g · max/‖g‖`` only when
    ``‖g‖ ≥ max``. (``torch.nn.utils.clip_grad_norm_`` divides by
    ``‖g‖ + 1e-6`` and scales whenever the norm exceeds the bound, which is
    not the reference's update.) No host sync: the choice is a tensor op.
    Returns the global norm before clipping.

    ``split[i]`` marks a gradient this rank holds one ``model`` split of:
    the squares of those are summed over ``model`` once, the replicated
    ones counted once, so every rank clips by the whole net's norm."""
    if split is None or not any(split):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        sq = torch.square(torch.stack(torch._foreach_norm(grads)))
        mask = torch.tensor(split, device=sq.device)
        part = mesh.sum_(torch.where(mask, sq, 0.0).sum(), group="model")
        norm = torch.sqrt(torch.where(mask, 0.0, sq).sum() + part)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def clip_adam_plain_(opt: torch.optim.Adam, grads: list[torch.Tensor], max_norm: float,
                     mesh=None, split: list[bool] | None = None) -> None:
    """``clip_grads_by_global_norm_`` then ``opt.step()``, in place."""
    clip_grads_by_global_norm_(grads, max_norm, mesh, split)
    opt.step()


def clip_adam_(opt: torch.optim.Adam, grads: list[torch.Tensor], max_norm: float,
               mesh=None, split: list[bool] | None = None) -> None:
    """optax's ``chain(clip_by_global_norm(max_norm), adam)`` on ``opt``'s
    params, whose gradients are ``grads`` in ``opt``'s order: the kernels
    ``grad_sq_norms`` and ``clip_adam`` (``kernels.ppo``) on the card,
    ``clip_adam_plain_`` on the CPU. ``split`` (under a ``mesh``) marks the
    gradients this rank holds one ``model`` split of, whose squares are
    summed over ``model`` between the two launches, so every rank clips by
    the whole net's norm."""
    if grads and grads[0] is not None and grads[0].device.type == "cpu":
        return clip_adam_plain_(opt, grads, max_norm, mesh, split)
    sq = ppo_kernels.grad_sq_norms(grads)
    if split is not None and any(split):
        mask = torch.tensor(split, device=sq.device)
        part = mesh.sum_(torch.where(mask, sq, 0.0), group="model")
        sq = torch.where(mask, part, sq)
    ppo_kernels.clip_adam(opt, grads, sq, max_norm)


def clip_adam_plain_norm_(opt: torch.optim.Adam, grads: list[torch.Tensor],
                          max_norm: float) -> None:
    """``clip_adam_plain_``'s update to the bit, with Adam's step on the
    card in the ``clip_adam`` kernel: ``clip_grads_by_global_norm_`` (the
    float32 norm of ``torch._foreach_norm``), then the kernel with its own
    clip off (zero squares, a scale of exactly 1), whose Adam rounds op for
    op as ``torch.optim.Adam``'s. So a captured sweep (``SweepGraph``)
    reads Adam's step terms on the card, while the norm is summed as the
    plain path sums it: a norm summed otherwise (``grad_sq_norms``' float64
    sum) moves the clip scale by an ulp, which a long chain of grad steps
    can grow. ``clip_adam_plain_`` on the CPU."""
    if grads and grads[0] is not None and grads[0].device.type == "cpu":
        return clip_adam_plain_(opt, grads, max_norm)
    clip_grads_by_global_norm_(grads, max_norm)
    ppo_kernels.clip_adam(opt, grads, grads[0].new_zeros(len(grads)), max_norm)


def frozen_copy(net: nn.Module) -> nn.Module:
    """A target network: a copy of ``net`` whose params take no gradients."""
    return copy.deepcopy(net).requires_grad_(False)


@torch.no_grad()
def hard_update(target: list[torch.Tensor], online: list[torch.Tensor]) -> None:
    """target ← online, in place."""
    torch._foreach_copy_(target, online)


@torch.no_grad()
def soft_update(target: list[torch.Tensor], online: list[torch.Tensor], tau: float) -> None:
    """Polyak update in place, in the reference's form ``(1-τ)·t + τ·o``
    (``lerp`` computes ``t + τ·(o-t)``, which rounds differently)."""
    torch._foreach_mul_(target, 1.0 - tau)
    torch._foreach_add_(target, torch._foreach_mul(online, tau))


@torch.no_grad()
def clip_grads_by_value_(grads: list[torch.Tensor], clip: float) -> None:
    """Per-parameter gradient clamp ±clip, in place (reference dqn_cartpole.py:163-165)."""
    torch._foreach_clamp_min_(grads, -clip)
    torch._foreach_clamp_max_(grads, clip)


def set_grads(params: list[torch.nn.Parameter], loss: torch.Tensor, mesh=None) -> None:
    """``p.grad = ∂loss/∂p`` for exactly these params. Unlike ``backward``
    this leaves other modules the loss reads (a critic under an actor loss)
    without gradients, so no step has to clear them. Under a ``mesh`` the
    gradients are averaged over ``data``."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    if mesh is not None:
        mesh.mean_([p.grad for p in params])


def mesh_mean(values: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Scalars averaged over ``data`` (metrics of a minibatch share),
    detached; unchanged without a mesh."""
    if mesh is None:
        return [v.detach() if v.requires_grad else v for v in values]
    vec = torch.stack([v.detach().float() for v in values])
    mesh.mean_([vec])
    return list(vec.unbind())


def grad_step(net: nn.Module, opt: torch.optim.Optimizer,
              loss_fn: Callable[[nn.Module, dict], tuple[torch.Tensor, dict]], mb: dict,
              max_grad_norm: float, mesh=None) -> dict[str, torch.Tensor]:
    """One clipped Adam step of ``loss_fn(net, mb)``; returns its metrics,
    detached. A parameter the loss does not read (PPG's other value head,
    ppo_lstm's frozen RND target) gets a zero gradient, so Adam still
    decays its moments and counts the step, as optax does. Under a
    ``mesh``, ``mb`` is this rank's share: gradients and metrics are
    averaged over ``data`` in one all-reduce before the clip. The clip and
    Adam are ``clip_adam_plain_norm_``: Adam's step in the ``clip_adam``
    kernel on the card, so that a captured sweep (``SweepGraph``) reads its
    step terms there."""
    loss, metrics = loss_fn(net, mb)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    params = list(net.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        vec = torch.stack([v.float() for v in metrics.values()])
        mesh.mean_([p.grad for p in params] + [vec])
        metrics = dict(zip(metrics.keys(), vec.unbind()))
    clip_adam_plain_norm_(opt, [p.grad for p in params], max_grad_norm)
    return metrics


def rollout_scan(step: Callable[[Any], tuple[Any, Any]], carry: Any,
                 steps: int) -> tuple[Any, Any]:
    """The port's ``lax.scan``: ``step(carry) -> (carry', out)`` run ``steps``
    times, each in a ``rollout.step`` span; the last carry, and each leaf of
    ``out`` stacked over the steps in ``out``'s structure (NamedTuples too)."""
    history = []
    for _ in range(steps):
        with span("rollout.step"):
            carry, out = step(carry)
        leaves, spec = tree_flatten(out)
        history.append(leaves)
    return carry, tree_unflatten([torch.stack(x) for x in zip(*history)], spec)


def sweep(packed: torch.Tensor, perms: torch.Tensor, n_mb: int,
          step: Callable[[int, int, torch.Tensor], Any]) -> Any:
    """The epoch × minibatch scan: per epoch, ``packed`` gathered by its row
    of ``perms`` and cut into ``n_mb`` minibatches, ``step(epoch, i, rows)``
    on each. A step's metrics are a vector or a dict of scalars; returns
    their means over every step, as the same (the ``[M]`` vector or dict)."""
    history, names = [], None
    for epoch, perm in enumerate(perms):
        for i, rows in enumerate(packed[perm].reshape(n_mb, -1, packed.shape[1])):
            metrics = step(epoch, i, rows)
            if isinstance(metrics, dict):
                names, metrics = list(metrics), torch.stack(list(metrics.values()))
            history.append(metrics)
    means = torch.stack(history).mean(dim=0)
    return means if names is None else dict(zip(names, means.unbind()))


def to_chunks(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """``[T, B, ...]`` cut into each env column's ``seq_len``-step chunks:
    ``[T/L·B, L, ...]``, the first chunk of every column first."""
    n_chunks, b = x.shape[0] // seq_len, x.shape[1]
    x = x.reshape((n_chunks, seq_len) + tuple(x.shape[1:])).movedim(2, 1)
    return x.reshape((n_chunks * b, seq_len) + tuple(x.shape[3:]))


def adam(params: list[torch.nn.Parameter], lr: float, eps: float,
         foreach: bool) -> torch.optim.Adam:
    """``torch.optim.Adam`` with its state made at construction, as optax's
    ``init`` makes it: step 0 and zero moments. Its bias-corrected update
    equals optax's ``adam`` up to rounding."""
    opt = torch.optim.Adam(params, lr=lr, eps=eps, foreach=foreach)
    for p in params:
        opt.state[p] = {
            "step": torch.tensor(0.0),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
        }
    return opt


def param_key(net: nn.Module) -> tuple:
    """Each of ``net``'s params by name, address and size: what a captured
    graph that reads them needs to hold (a restore into a fresh state
    replaces them)."""
    return tuple((n, p.data_ptr(), p.numel()) for n, p in net.named_parameters())


def graph_key(net: nn.Module, opt: torch.optim.Adam) -> tuple[tuple, tuple]:
    """What a captured sweep of ``net`` and its Adam ``opt`` reads and writes
    outside its own pool and buffers: ``kernels.ppo.adam_key`` (Adam's state
    and group by identity, the options but the lr, the addresses of params,
    ``exp_avg`` and ``exp_avg_sq``, the step tensors) and ``param_key(net)``.
    With it, the objects the key names by identity, to be held while the key
    is."""
    key, holds = ppo_kernels.adam_key(opt)
    return (key, param_key(net)), (*holds, list(net.parameters()))


class CapturedGraph:
    """What ``SweepGraph`` and ``RolloutGraph`` share: a side stream that
    warms up and captures, the capture itself, and the counters.

    The first run of a holder is a warm-up: its body runs eagerly on the side
    stream that captures later, so what PyTorch and the kernels make lazily
    per stream or per process (cuBLAS's workspace, the reductions' scratch,
    the kernels' libraries) exists before any capture. A capture records the
    launches and runs none; ``kernels.LAUNCHES``' increments made while
    capturing are taken back, and each replay adds them. A failed capture
    raises. ``captures`` and ``replays`` count how often the graph route
    engaged."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.warm = False
        self.graph = self.key = self.holds = None
        self.launches: dict[str, int] = {}
        self.captures = self.replays = 0

    def _side(self):
        """The side stream as the current one, after the work queued so far."""
        if not self.cuda:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def _join(self) -> None:
        """The current stream after the side stream's work."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def _warm_up(self, body: Callable[[], Any]) -> Any:
        """``body()`` run eagerly on the side stream; its tensors kept from
        the side stream's pool while the current stream reads them."""
        with self._side():
            out = body()
        self._join()
        if self.cuda:
            current = torch.cuda.current_stream(self.device)
            for x in tree_flatten(out)[0]:
                if isinstance(x, torch.Tensor):
                    x.record_stream(current)
        self.warm = True
        return out

    def _record(self, body: Callable[[], Any], generators=()) -> tuple[Any, Any]:
        """``(graph, out)``: ``body()`` captured on the side stream, the
        random ``generators`` it draws from registered with the graph, so
        that each replay draws from their offsets at the time and advances
        them as the eager body would. Garbage is collected first, as
        ``torch.cuda.graph`` does: a graph of an earlier trainer that the
        collector freed during the capture would end it."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = dict(kernels.LAUNCHES)
        try:
            with self._side():
                graph.capture_begin()
                try:
                    out = body()
                finally:
                    graph.capture_end()
        finally:
            self.launches = {k: kernels.LAUNCHES[k] - n for k, n in before.items()}
            kernels.LAUNCHES.update(before)
        self._join()
        return graph, out

    def _replay_graph(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)
        self.replays += 1


class SweepGraph(CapturedGraph):
    """One iteration's SGD sweep as ONE replay of a captured CUDA graph: the
    port's counterpart of the jit cache of the JAX ``Trainer.train_iter``
    (``gymrl_tpu/algos/base.py``), whose executable runs the whole epoch ×
    minibatch scan. The kernels and their order are the eager sweep's; only
    who issues the launches changes.

    ``run(net, opt, body, inputs)`` copies ``inputs`` into the holder's
    static buffers and runs ``body(static)``, the eager sweep of ``steps``
    Adam steps of ``opt`` on ``net``, returning a tensor or a dict of them:
      * the first run is ``CapturedGraph``'s warm-up;
      * a run whose ``graph_key`` differs from the captured one (a restore's
        ``load_state_dict`` replaces Adam's state) captures ``body`` anew on
        that stream, never replaying a stale graph, then replays it; later
        runs replay it.
    Capture records the launches and runs none, so the host effects of the
    body are kept out of it or taken back, and applied once per replay:
      * Adam's CPU step counts: under ``kernels.ppo.device_terms`` grad step
        i's ``clip_adam`` reads its ``(step_size, bc2)`` from row i of a
        buffer on the card and counts nothing; before each replay the rows
        come from ``kernels.ppo.adam_run_terms`` through pinned memory, and
        after it the counts are set where ``steps`` more leave them;
      * ``kernels.LAUNCHES``, as ``CapturedGraph`` takes them back;
      * ``opt.zero_grad(set_to_none=True)``: every step's backward makes its
        grads in the graph's pool; after a replay ``p.grad`` is the last
        step's, as after the eager sweep.
    The returned tensors are copies: the next replay overwrites the graph's.
    Each route is a span of ``utils.profiling``: ``sgd.warmup``,
    ``sgd.capture``, ``sgd.replay``.
    """

    def __init__(self, device: torch.device, steps: int):
        super().__init__(device)
        self.steps = steps
        self.static: dict[str, torch.Tensor] = {}
        self.terms = torch.empty((steps, 2), dtype=torch.float32, device=device)
        self.host_terms = torch.empty((steps, 2), dtype=torch.float32, pin_memory=self.cuda)
        self.copied = None  # the event after the last copy out of host_terms
        self.out = None
        self.grads: list[torch.Tensor] = []

    def run(self, net: nn.Module, opt: torch.optim.Adam,
            body: Callable[[dict[str, torch.Tensor]], Any],
            inputs: dict[str, torch.Tensor]) -> Any:
        for name, x in inputs.items():
            held = self.static.get(name)
            if held is None or held.shape != x.shape or held.dtype != x.dtype:
                held = self.static[name] = torch.empty_like(x)
                self.graph = None  # it reads the buffer this one replaces
            held.copy_(x)
        if not self.warm:
            with span("sgd.warmup"):
                return self._warm_up(lambda: body(self.static))
        key, holds = graph_key(net, opt)
        if self.graph is None or key != self.key:
            self.graph = self.out = None  # its pool goes with its last tensors
            with span("sgd.capture"):
                self._capture(net, opt, body)
            self.key, self.holds = key, holds
        with span("sgd.replay"):
            return self._replay(net, opt)

    def _capture(self, net: nn.Module, opt: torch.optim.Adam, body) -> None:
        opt.zero_grad(set_to_none=True)  # each backward makes its grads in the graph's pool
        with ppo_kernels.device_terms(self.terms) as run:
            graph, out = self._record(lambda: body(self.static))
        if run.taken != self.steps:
            raise RuntimeError(f"the captured sweep stepped Adam {run.taken} times on the "
                               f"step terms, not {self.steps}")
        self.graph, self.out = graph, out
        self.grads = [p.grad for p in net.parameters()]
        self.captures += 1

    def _replay(self, net: nn.Module, opt: torch.optim.Adam) -> Any:
        terms, count = ppo_kernels.adam_run_terms(opt, self.steps)
        if self.copied is not None:
            self.copied.synchronize()  # the last replay's copy has read the pinned rows
        self.host_terms.copy_(torch.from_numpy(terms))
        self.terms.copy_(self.host_terms, non_blocking=self.cuda)
        if self.cuda:
            self.copied = torch.cuda.Event()
            self.copied.record()
        self._replay_graph()
        for state in opt.state.values():
            state["step"].fill_(count)
        for p, g in zip(net.parameters(), self.grads):
            p.grad = g
        return tree_map(torch.Tensor.clone, self.out)


class RolloutGraph(CapturedGraph):
    """A T-step rollout (``rollout_scan``) as ONE replay of a captured CUDA
    graph: the port's counterpart of the JAX trainer's jitted rollout scan.
    The kernels and their order are the eager rollout's (the forward, the
    Gumbel draw, the log-prob, the env's step, reset draws, reset and
    selects, the stacks); only who issues the launches changes.

    ``run(net, noise, carry, body)`` runs ``body(carry) -> (carry', out)``,
    the eager rollout of ``net`` drawing from ``noise`` (a plain ``Noise``),
    and returns ``(carry', out)``:
      * the first run is ``CapturedGraph``'s warm-up;
      * a run whose key differs from the captured one (``param_key(net)``,
        the noise's generator by identity, the carry's structure, shapes and
        dtypes) captures ``body`` anew, never replaying a stale graph, then
        replays it; later runs replay it.
    The carry (a tree of tensors) lives in static buffers the graph reads;
    the captured body ends by copying ``carry'`` into them, so after a
    replay they hold ``carry'`` and are what ``run`` returns. The next run's
    carry is then those same tensors and nothing is copied; a carry that is
    not (a restore, an external reset: decided by identity) is copied in
    first. ``out`` lives in the graph's pool and the next replay overwrites
    it: consume or copy it before then.

    The noise's generator is registered with the graph: each replay draws
    from its offset at the time and advances it as the eager rollout would,
    and the capture draws nothing, so the stream of draws (epoch
    permutations, a checkpoint's generator state) is the eager one's. Each
    route is a span of ``utils.profiling``: ``rollout.warmup``,
    ``rollout.capture``, ``rollout.replay``.
    """

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.static: list[torch.Tensor] = []
        self.out = None

    def run(self, net: nn.Module, noise: Noise, carry: Any,
            body: Callable[[Any], tuple[Any, Any]]) -> tuple[Any, Any]:
        if not self.warm:
            with span("rollout.warmup"):
                return self._warm_up(lambda: body(carry))
        leaves, spec = tree_flatten(carry)
        key = (param_key(net), id(noise.generator), spec,
               tuple((x.shape, x.dtype) for x in leaves))
        if self.graph is None or key != self.key:
            self.graph = self.out = None  # its pool goes with its last tensors
            self.static = [torch.empty_like(x) for x in leaves]
        for held, x in zip(self.static, leaves):
            if held is not x:
                held.copy_(x)
        if self.graph is None:
            with span("rollout.capture"):
                self.graph, self.out = self._record(lambda: self._carried(body, spec),
                                                    [noise.generator])
            self.key, self.holds = key, (list(net.parameters()), noise.generator)
            self.captures += 1
        with span("rollout.replay"):
            self._replay_graph()
        return tree_unflatten(self.static, spec), self.out

    def _carried(self, body, spec) -> Any:
        """``body`` on the static carry, ending with ``carry'`` copied into it."""
        carry, out = body(tree_unflatten(self.static, spec))
        pairs = [(a, b) for a, b in zip(self.static, tree_flatten(carry)[0]) if a is not b]
        if pairs:
            torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])
        return out


class RolloutSizes:
    """What a PPO-family config derives from ``num_envs`` and ``rollout_steps``."""

    @property
    def batch_total(self) -> int:
        return self.num_envs * self.rollout_steps


class SeqRolloutSizes(RolloutSizes):
    """A recurrent config's rollout cut into ``seq_len``-step chunks
    (``to_chunks``), minibatches of ``seq_minibatch`` training items."""

    @property
    def seqs_per_rollout(self) -> int:
        if self.rollout_steps % self.seq_len:
            raise ValueError(f"seq_len {self.seq_len} must divide rollout_steps "
                             f"{self.rollout_steps}")
        return (self.rollout_steps // self.seq_len) * self.num_envs

    @property
    def n_train_items(self) -> int:
        """The rows minibatches are cut from: one per chunk."""
        return self.seqs_per_rollout

    @property
    def num_minibatches(self) -> int:
        n = self.n_train_items
        mb = min(self.seq_minibatch, n)
        if n % mb:
            raise ValueError(f"{n} sequences must divide into minibatches of {mb}")
        return n // mb


def assert_flat_tp_ok(mesh) -> None:
    """The flat-optimizer guard of every PPO-family trainer: one Adam over
    every tensor as one multi-tensor update cannot hold ``model`` splits
    (the JAX package's flat master vector cannot carry per-leaf TP
    layouts). Called at construction, which a restored state also passes."""
    if mesh is not None and mesh.model_size > 1:
        raise ValueError(f"flat_optimizer is incompatible with model-axis TP "
                         f"(mesh model={mesh.model_size})")


class Trainer:
    """Base: holds cfg + device (+ mesh); subclasses implement the API."""

    def __init__(self, cfg, device: str | torch.device = "cuda", mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device_for(device))
        n = getattr(cfg, "num_envs", None)
        self.local_envs = n if mesh is None else mesh.local_count(n, "num_envs")
        # Whether a trainer that captures its rollout and its SGD sweep
        # (PPOTrainer, PPOLSTMTrainer), on a CUDA device without a mesh,
        # replays them as CUDA graphs (RolloutGraph, SweepGraph); False runs
        # them eagerly. The counterpart of the JAX Trainer's ``donate``.
        self.graphs = True

    def _graphed(self) -> bool:
        """Whether the rollout and the SGD sweep run as CUDA graphs here."""
        return self.graphs and self.device.type == "cuda" and self.mesh is None

    def _iter_out(self, stats, metrics: dict, **scalars: float) -> IterOut:
        """An iteration's ``IterOut``: its episode statistics ``(return,
        length, done)``, and ``metrics`` with ``scalars`` as device scalars."""
        return IterOut(*stats, metrics=metrics | {k: torch.full((), v, device=self.device)
                                                  for k, v in scalars.items()})

    @torch.no_grad()
    def _rollout_route(self, net: nn.Module, noise, carry: Any,
                       step: Callable[[Any], tuple[Any, Any]]) -> tuple[Any, Any, Any]:
        """``rollout_scan`` of ``step(carry) -> (carry', (rollout, stats))``
        in a ``rollout`` span: ``(carry', rollout, stats)``. On a CUDA device
        without a mesh, while ``graphs`` is on and ``noise`` is a plain
        ``Noise``, one replay of ``self.rollout_graph`` (made at the first
        run, its eager warm-up): ``carry'`` is the graph's static carry and
        the rollout lives in its pool, both overwritten by the next replay
        (a caller that keeps an earlier state copies it); the statistics are
        copies. Else eager (a test's replay of the JAX keys, ``ShardedNoise``)."""
        with span("rollout"):
            scan = functools.partial(rollout_scan, step, steps=self.cfg.rollout_steps)
            if not (self._graphed() and type(noise) is Noise):
                carry, (roll, stats) = scan(carry)
                return carry, roll, stats
            if self.rollout_graph is None:
                self.rollout_graph = RolloutGraph(self.device)
            carry, (roll, stats) = self.rollout_graph.run(net, noise, carry, scan)
            return carry, roll, tuple(x.clone() for x in stats)  # the next replay overwrites

    def _sweep_route(self, ts, body: Callable[[dict[str, torch.Tensor]], Any],
                     inputs: dict[str, torch.Tensor]) -> Any:
        """``body(inputs)``: the epoch × minibatch sweep of ``ts``'s net and
        Adam, returning its metrics' means (a vector or a dict of scalars).
        On a CUDA device without a mesh, while ``graphs`` is on, one replay
        of ``self.sweep_graph`` (made at the first run, its eager warm-up):
        ``body`` reads its inputs from the graph's static buffers, and the
        means are copies of the graph's, of the structure ``body`` gave at
        the capture. Else eager."""
        if not self._graphed():
            return body(inputs)
        if self.sweep_graph is None:
            self.sweep_graph = SweepGraph(self.device,
                                          self.cfg.num_epochs * self.cfg.num_minibatches)
        return self.sweep_graph.run(ts.params, ts.opt_state, body, inputs)

    # -- the mesh's hooks: identities without one -------------------------------
    def _noise(self, seed: int):
        """The trainer's noise source: this data rank's view of one seeded
        ``Noise`` under a mesh (``ShardedNoise``)."""
        noise = Noise(self.device, seed)
        if self.mesh is None:
            return noise
        return ShardedNoise(noise, self.mesh.data_rank, self.mesh.data_size)

    def _check_split(self, n: int, what: str) -> None:
        """Refuse, at construction, a learner batch that ``data`` does not divide."""
        if self.mesh is not None:
            self.mesh.local_count(n, what)

    def _gather(self, tree, axis: int = 0):
        """Every rank's env rows of ``tree`` along ``axis``, in rank order."""
        return gather_pytree_batch(tree, self.mesh, axis)

    def _share(self, tree, axis: int = 0):
        """This rank's share of a minibatch ``tree`` that every rank holds whole."""
        return constrain_batch(tree, self.mesh, axis)

    def init(self, seed: int = 0) -> Any:
        raise NotImplementedError

    def train_iter(self, ts, timer: PhaseTimer | None = None) -> tuple[Any, IterOut]:
        raise NotImplementedError

    def policy(self, ts, obs, noise, deterministic: bool = True):
        raise NotImplementedError

    # -- carry-through policy surface ----------------------------------------
    def policy_reset(self, batch: int):
        """Initial policy carry for a fresh batch of episodes (None = stateless)."""
        return None

    def policy_step(self, ts, carry, obs, noise, deterministic: bool = True):
        """One policy step threading ``carry``: returns (carry', action[b])."""
        return carry, self.policy(ts, obs, noise, deterministic)

    @torch.no_grad()
    def eval_episodes(self, ts, noise, n_episodes: int):
        """Deterministic eval: n parallel fresh episodes until each is done,
        the policy's carry (a recurrent hidden) threaded through each.

        Rewards count only until each instance's first done (latched mask),
        so stopping once every episode is done gives the reference's result
        without stepping to ``max_steps``. Returns (returns f32[n], lengths i32[n]).
        """
        env = self.venv.env
        params = self.venv.params
        state, obs = env.reset_batch(params, noise, n_episodes)
        carry = self.policy_reset(n_episodes)
        done = torch.zeros(n_episodes, dtype=torch.bool, device=obs.device)
        ret = torch.zeros(n_episodes, device=obs.device)
        length = torch.zeros(n_episodes, dtype=torch.int32, device=obs.device)
        for _ in range(env.max_steps):
            carry, action = self.policy_step(ts, carry, obs, noise)
            sr = env.step_batch(params, state, action, noise)
            alive = ~done
            ret = ret + sr.reward * alive
            length = length + alive.to(torch.int32)
            done = done | sr.terminated | sr.truncated
            state, obs = sr.state, sr.obs
            if bool(done.all()):
                break
        return ret, length


class RecurrentTrainer(Trainer):
    """What the recurrent trainers (recurrent PPO, PPG, ppo_lstm) share: the
    memoryless ``policy`` view of ``policy_step``, and epochs of shuffled
    minibatches over packed sequence rows. A subclass gives
    ``policy_reset``, ``policy_step`` and a config with ``num_minibatches``
    and ``max_grad_norm``."""

    _warned_stateless_policy = False

    @torch.no_grad()
    def policy(self, ts, obs, noise, deterministic: bool = True):
        """MEMORYLESS view (a fresh carry on every call): it ignores the
        cell's memory, and exists only so every trainer has ``policy``.
        Recurrent behaviour is ``policy_step`` / ``eval_episodes``."""
        if not self._warned_stateless_policy:
            get_logger().warning(f"{type(self).__name__}.policy() is memoryless (h=0 each "
                                 "call); use policy_step/eval_episodes for recurrent eval")
            self._warned_stateless_policy = True
        return self.policy_step(ts, self.policy_reset(obs.shape[0]), obs, noise,
                                deterministic)[1]

    def _grad_step(self, ts, rows: torch.Tensor, spec: dict, loss_fn) -> dict[str, torch.Tensor]:
        """One clipped Adam step (``grad_step``) on a minibatch of packed
        rows (this rank's share of them under a mesh)."""
        return grad_step(ts.params, ts.opt_state, loss_fn, unpack_fields(self._share(rows), spec),
                         self.cfg.max_grad_norm, self.mesh)

    def _epochs(self, ts, packed: torch.Tensor, spec: dict, perms: torch.Tensor,
                loss_fn) -> dict[str, torch.Tensor]:
        """Epochs of shuffled minibatches (``sweep``), one permutation per
        epoch; returns the metrics averaged over every gradient step."""
        return sweep(packed, perms, self.cfg.num_minibatches,
                     lambda epoch, i, rows: self._grad_step(ts, rows, spec, loss_fn))
