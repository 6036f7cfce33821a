"""Rank-side scenarios of ``test_torch_distributed.py``: each rank of a
gloo world on the CPU runs every scenario it is handed and returns what the
tests hold. Imports torch and the port only (no JAX), so a rank starts fast.

A scenario is a dict naming its function (``fn``) with its arguments. Trainers are named
``(module, class, config factory)`` with the factory's keywords, so a rank
builds the same trainer as the test process.
"""

from __future__ import annotations

import importlib

import torch
import torch.distributed as dist

from gymrl_tpu_torch.core.noise import ShardedNoise
from gymrl_tpu_torch.distributed.mesh import make_mesh
from gymrl_tpu_torch.utils.checkpoint import (
    flat_state, gathered_state, restore_checkpoint, save_checkpoint, state_tree,
)


def build(kind: tuple[str, str, str], cfg: dict, mesh=None):
    """The trainer named ``kind`` with config ``factory(**cfg)``, on the CPU."""
    module, cls, factory = kind
    m = importlib.import_module(module)
    return getattr(m, cls)(getattr(m, factory)(**cfg), device="cpu", mesh=mesh)


def _key(args) -> tuple:
    """A draw's arguments, comparable across processes (an env by its class)."""
    return tuple(type(a).__name__ if hasattr(a, "step_draws") else
                 (tuple(a) if isinstance(a, torch.Size) else a) for a in args)


class Recorder:
    """A noise source that logs every draw of ``inner`` in call order."""

    def __init__(self, inner):
        self.inner = inner
        self.log: list = []

    def __getattr__(self, name):
        if name in ("inner", "log"):
            raise AttributeError(name)
        fn = getattr(self.inner, name)

        def call(*args):
            out = fn(*args)
            self.log.append((name, _key(args), out))
            return out
        return call


class Playback:
    """Hands out a ``Recorder``'s log in order, checking that every draw is
    asked for with the same method and arguments (the global shapes)."""

    def __init__(self, log: list):
        self.log = list(log)
        self.pos = 0

    def __getattr__(self, name):
        if name in ("log", "pos"):
            raise AttributeError(name)

        def call(*args):
            want_name, want_args, out = self.log[self.pos]
            if (name, _key(args)) != (want_name, want_args):
                raise AssertionError(f"draw {self.pos}: asked {name}{_key(args)}, "
                                     f"recorded {want_name}{want_args}")
            self.pos += 1
            return out
        return call


def _result(trainer, ts, outs, mesh) -> dict:
    """What a ``train`` scenario returns: the whole state (gathered, the
    same on every rank), every iteration's metrics and episodes, and this
    rank's local shapes."""
    whole = flat_state(gathered_state(ts, mesh))
    local = {k: tuple(v.shape) for k, v in flat_state(state_tree(ts)).items()
             if isinstance(v, torch.Tensor)}
    return {"state": whole, "local_shapes": local,
            "metrics": [{k: float(v) for k, v in o.metrics.items()} for o in outs],
            "ep_return": [o.ep_return.clone() for o in outs],
            "ep_done": [o.ep_done.clone() for o in outs],
            "env_steps": ts.env_steps, "local_envs": trainer.local_envs}


def train(mesh_shape, kind, cfg, iters=1, seed=0, state_path=None, draws=None):
    """``iters`` iterations of a trainer under a ``(data, model)`` mesh, from
    ``init(seed)`` or from a saved unsharded state, drawing from ``draws``
    (a ``Recorder``'s log) when given."""
    mesh = make_mesh(*mesh_shape, device="cpu")
    trainer = build(kind, cfg, mesh)
    ts = trainer.init(seed)
    if state_path is not None:
        ts = restore_checkpoint(state_path, ts, mesh)
    if draws is not None:
        ts = ts._replace(noise=ShardedNoise(Playback(draws), mesh.data_rank, mesh.data_size))
    outs = []
    for _ in range(iters):
        ts, out = trainer.train_iter(ts)
        outs.append(out)
    used = None
    if draws is not None:  # a playback has no generator state to gather
        used = ts.noise.inner.pos
        ts = ts._replace(noise=trainer.init(seed).noise)
    return _result(trainer, ts, outs, mesh) | {"draws_used": used}


def allreduce(mesh_shape=None):
    """``initialize_multihost``'s group at work: rank r adds r + 1."""
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    return {"total": float(x), "rank": dist.get_rank(), "world": dist.get_world_size()}


def refuse(mesh_shape, kind, cfg):
    """Construct a trainer the mesh cannot hold; returns the refusal's
    message (None if it was built)."""
    mesh = make_mesh(*mesh_shape, device="cpu")
    try:
        build(kind, cfg, mesh)
    except ValueError as e:
        return str(e)
    return None


def checkpoint_roundtrip(mesh_shape, kind, cfg, path):
    """Save under the mesh, restore into a fresh ``init(7)`` state of the same
    mesh; returns the entries that differ, the local and saved shapes of the
    split trunk, and whether one more iteration from the restored state
    equals one from the saved state, to the bit."""
    mesh = make_mesh(*mesh_shape, device="cpu")
    trainer = build(kind, cfg, mesh)
    ts, _ = trainer.train_iter(trainer.init(0))
    save_checkpoint(path, ts, mesh)
    fresh = build(kind, cfg, mesh).init(7)
    restored = restore_checkpoint(path, fresh, mesh)
    want, got = flat_state(state_tree(ts)), flat_state(state_tree(restored))
    differ = [k for k in want if not (torch.equal(want[k], got[k])
                                      if isinstance(want[k], torch.Tensor) else want[k] == got[k])]
    saved = torch.load(path, weights_only=True)
    a, out_a = trainer.train_iter(ts)
    b, out_b = trainer.train_iter(restored)
    same = all(torch.equal(x, y) for x, y in zip(a.params.parameters(), b.params.parameters()))
    out_a, out_b = ({k: float(v) for k, v in o.metrics.items()} for o in (out_a, out_b))
    return {"differ": differ,
            "local_trunk": tuple(restored.params.shared_0.weight.shape),
            "local_obs": tuple(restored.vec_state.obs.shape),
            "saved_trunk": tuple(saved["params"]["shared_0.weight"].shape),
            "saved_obs": tuple(saved["vec_state"]["obs"].shape),
            "saved_moment": tuple(saved["opt_state"]["state"][0]["exp_avg"].shape),
            "continues_equal": same and out_a == out_b,
            "env_steps": b.env_steps}


def run(rank: int, world: int, scenarios: dict) -> dict:
    """Every scenario, in the same order on every rank."""
    out = {}
    for name, sc in scenarios.items():
        sc = dict(sc)
        out[name] = globals()[sc.pop("fn")](**sc)
    return out
