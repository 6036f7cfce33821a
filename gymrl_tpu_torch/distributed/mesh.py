"""Process mesh and collectives on ``torch.distributed`` (counterpart of
``gymrl_tpu/distributed/mesh.py``).

The JAX package runs one controller over many devices and lets XLA insert
the collectives. Here every device is driven by its own process, so every
reduction the unsharded program makes over the env batch is a collective
written by hand at the place it happens. The rule every trainer follows:
each rank computes exactly what the unsharded trainer computes, on its share
of the rows.

Axes, as in the JAX package:
  * ``data`` — env-batch / gradient data parallelism. Rank ``d`` of ``D``
    steps envs ``[d·B/D, (d+1)·B/D)``; learner minibatches are split the
    same way and gradients are averaged over ``data``.
  * ``model`` — tensor parallelism of PPO's trunk (``algos/ppo.py``).

Rank ``r`` sits at ``(data, model) = divmod(r, M)``, the row-major layout
of ``make_mesh``'s ``devices.reshape(n_data, n_model)`` in the JAX package.

Every collective is built on ``all_reduce`` (and ``barrier``): an
all-gather is the all-reduce of a zero-filled buffer in which each rank
writes its own rows, which is exact because ``x + 0 = x``.
So one code path runs under NCCL (one rank per card) and under gloo with
CUDA tensors (several ranks sharing one card; gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` but not for ``all_gather``) and on the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

# How long a rank waits on a peer before the collective raises.
DEFAULT_TIMEOUT_S = 300.0


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group and return this process's rank.

    With ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` the group is built from these; without them from
    ``torchrun``'s environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).
    ``backend`` defaults to NCCL when CUDA is available, else gloo. A
    collective that waits longer than ``timeout_s`` on a peer raises.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs: dict[str, Any] = dict(backend=backend,
                                  timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    else:
        kwargs.update(init_method="env://")
    dist.init_process_group(**kwargs)
    return dist.get_rank()


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


class AllReduceSum(torch.autograd.Function):
    """Sum over a process group in the forward, identity in the backward:
    the all-reduce after Megatron's row-parallel product. Each rank's
    partial product feeds a sum that every rank then holds, so the gradient
    of the sum with respect to a rank's partial is the sum's own gradient.
    Reduced in float32, so a bf16 forward rides any backend."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.float().contiguous()
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class Mesh:
    """A ``(data, model)`` grid over the current process group: this rank's
    coordinates, its device and the two process groups it belongs to.
    ``shape`` is ``{"data": D, "model": M}``, as a JAX ``Mesh``'s."""

    def __init__(self, n_data: int, n_model: int, device: torch.device):
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data * n_model != world:
            raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks, "
                             f"the process group has {world}")
        self.shape = {"data": n_data, "model": n_model}
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, n_model)
        self.device = device
        self.backend = dist.get_backend()
        # every rank creates every group, in the same order
        data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                       for m in range(n_model)]
        model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                        for d in range(n_data)]
        self.data_group = data_groups[self.model_rank]
        self.model_group = model_groups[self.data_rank]

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data_size}, model={self.model_size}, rank={self.rank}, "
                f"coords=({self.data_rank}, {self.model_rank}), device={self.device}, "
                f"backend={self.backend})")

    def device_for(self, device: str | torch.device) -> torch.device:
        """The mesh's device, for a trainer asked for ``device``'s type."""
        if torch.device(device).type != self.device.type:
            raise ValueError(f"trainer asked for {device!r}, its mesh runs on {self.device}")
        return self.device

    # -- rows of the env batch -------------------------------------------------
    def local_count(self, n: int, what: str = "rows") -> int:
        """This rank's share of ``n`` rows; refuses an ``n`` that ``data`` does not divide."""
        if n % self.data_size:
            raise ValueError(f"{what}: {n} does not split over data={self.data_size} ranks")
        return n // self.data_size

    def shard(self, x: torch.Tensor, axis: int = 0, group: str = "data") -> torch.Tensor:
        """This rank's block of ``x`` along ``axis`` over ``group`` (a view)."""
        size = self.shape[group]
        if x.shape[axis] % size:
            raise ValueError(f"{x.shape[axis]} rows do not split over {group}={size} ranks")
        n = x.shape[axis] // size
        rank = self.data_rank if group == "data" else self.model_rank
        return x.narrow(axis, rank * n, n)

    def gather(self, x: torch.Tensor, axis: int = 0, group: str = "data") -> torch.Tensor:
        """The ranks' blocks of ``x`` concatenated along ``axis`` in rank order
        over ``group``."""
        return self.gather_many([x], axis, group)[0]

    def gather_many(self, xs: list[torch.Tensor], axis: int = 0,
                    group: str = "data") -> list[torch.Tensor]:
        """``gather`` of every tensor of ``xs`` in ONE all-reduce: each rank
        writes its tensors, as float64 (exact for float32, bool and integers
        below 2^53), into its row of a zero-filled ``[size, n]`` buffer."""
        size = self.shape[group]
        if size == 1 or not xs:
            return list(xs)
        rank = self.data_rank if group == "data" else self.model_rank
        sizes = [x.numel() for x in xs]
        buf = torch.zeros((size, sum(sizes)), dtype=torch.float64, device=xs[0].device)
        torch.cat([x.reshape(-1).to(torch.float64) for x in xs], out=buf[rank])
        dist.all_reduce(buf, group=self._group(group))
        out = []
        for x, part in zip(xs, buf.split(sizes, dim=1)):
            blocks = part.reshape((size,) + tuple(x.shape)).unbind(0)
            out.append(torch.cat(blocks, dim=axis).to(x.dtype))
        return out

    # -- reductions -------------------------------------------------------------
    def _group(self, group: str):
        return self.data_group if group == "data" else self.model_group

    def sum_(self, x: torch.Tensor, group: str = "data") -> torch.Tensor:
        """In-place sum of ``x`` over ``group``; returns ``x``."""
        dist.all_reduce(x, group=self._group(group))
        return x

    def mean_(self, tensors: list[torch.Tensor]) -> None:
        """Average every tensor of ``tensors`` over ``data``, in place, with
        ONE all-reduce of their concatenation."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        if self.data_size > 1:
            flat.div_(self.data_size)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``model``, differentiable (``AllReduceSum``)."""
        return AllReduceSum.apply(x, self.model_group)

    def barrier(self) -> None:
        if self.device.type == "cuda" and self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """A ``(data, model)`` mesh over the current process group.

    ``n_data`` defaults to ``world // n_model``. Each rank runs on
    ``cuda:(local_rank % device_count)`` unless ``device`` is given
    (``"cpu"`` for the CPU tests)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if device is None:
        device = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", _local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return Mesh(n_data, n_model, device)


# -- layouts: the counterpart of the JAX shardings ------------------------------
# A layout entry is None (replicated) or ``(axis_name, dim)``: the leaf is
# split along ``dim`` over ``axis_name`` ("data" or "model").

def batch_sharding(batch_axis: int = 0) -> tuple[str, int]:
    """The layout of a leaf whose ``batch_axis`` is the env batch."""
    return ("data", batch_axis)


def train_state_shardings(ts: Any) -> dict[str, Any]:
    """The layout of a train state, keyed by field, for the fields that are
    not replicated. The DP design of the JAX package: every rank >= 1 leaf
    of ``vec_state`` and the reward scaler's per-env ``ret`` split on
    ``data`` along dim 0, the recurrent ``hidden`` too, the n-step
    ``window`` along dim 1. The replay and the PER sum-tree replicate (a
    per-shard tree would sample each rank's own priorities, not the global
    ones: ``gymrl_tpu/distributed/mesh.py:76-83``); so do params, optimizer
    moments, normalization stats, the noise source and the counters. PPO's
    trunk split on ``model`` is the net's own ``model_split``
    (``utils/checkpoint.py`` reads both)."""
    out: dict[str, Any] = {}
    fields = getattr(ts, "_fields", ())
    if "vec_state" in fields:
        out["vec_state"] = batch_sharding(0)
    if "hidden" in fields:
        out["hidden"] = batch_sharding(0)
    if "reward_scaler" in fields:
        out["reward_scaler"] = {"ret": batch_sharding(0)}
    if "window" in fields and getattr(ts, "window", None) is not None:
        out["window"] = batch_sharding(1)
    return out


def constrain_batch(tree: Any, mesh: Mesh | None, batch_axis: int = 0) -> Any:
    """This data rank's share of every tensor of ``tree`` along
    ``batch_axis``: a sampled learner minibatch, which every rank holds
    whole (the replay is replicated), becomes the rank's share of the
    gradient computation. Identity without a mesh."""
    if mesh is None:
        return tree
    return map_tensors(lambda x: mesh.shard(x, batch_axis) if x.dim() > batch_axis else x, tree)


def gather_pytree_batch(tree: Any, mesh: Mesh | None, axis: int = 0) -> Any:
    """The inverse of ``constrain_batch``: every tensor of ``tree``
    gathered over ``data`` along ``axis``, in one all-reduce. Identity
    without a mesh."""
    if mesh is None or mesh.data_size == 1:
        return tree
    leaves: list[torch.Tensor] = []
    map_tensors(leaves.append, tree)
    it = iter(mesh.gather_many(leaves, axis))
    return map_tensors(lambda _: next(it), tree)


def map_tensors(fn, tree: Any) -> Any:
    """``fn`` over the tensors of ``tree`` (tensors, NamedTuples, tuples,
    lists, dicts and None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    raise TypeError(f"cannot map over a {type(tree).__name__}")
