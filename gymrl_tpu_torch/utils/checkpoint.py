"""Checkpoint / resume (counterpart of ``gymrl_tpu/utils/checkpoint.py``).

The train state — params, targets, optimizer moments and step counts, the
n-step window, env batch, the recurrent trainers' GRU hidden per env,
normalization stats and reward scaler, PER β, the noise generator's state
and the counters — is one ``torch.save`` file, so a restore puts training
and eval-time normalization back exactly. The replay is left out, as the
JAX package's ``_strip_replay`` leaves it out after gymRL's
``ModelLoader``, which never saves a buffer: a train state's whole
``replay`` field (the transitions, the PER sum-tree and max priority, the
write position and fill) is saved as None, and a restore keeps the
example's fresh, empty replay. An off-policy trainer therefore resumes on
an empty buffer and waits for ``batch_size`` rows before it updates again.

Restore is strict for every other field. The file must have exactly the
structure of the example state it is restored into, with every tensor of
the same shape and dtype; anything else raises ``ValueError`` naming the
first mismatch. There is no fallback that keeps fresh values for fields
that do not fit.

Under a mesh (``distributed/mesh.py``) the file holds the whole state: save
gathers every split leaf (the env batch over ``data``, PPO's trunk split
and its Adam moments over ``model``) and rank 0 writes it. Restore loads
the whole file on every rank, checks it against the example's whole shapes
and keeps this rank's rows and splits, as the JAX package's restore places
every leaf on its example leaf's sharding.
"""

from __future__ import annotations

import os
from typing import Any

import torch
from torch import nn

from gymrl_tpu_torch.core.noise import Noise, ShardedNoise
from gymrl_tpu_torch.distributed.mesh import train_state_shardings

_SCALARS = (bool, int, float, str, type(None))


def checkpoint_path(algo: str, env_name: str, root: str = "./checkpoints") -> str:
    """./checkpoints/{algo}_{env}.pt — reference utils/model.py:332 layout."""
    return os.path.abspath(os.path.join(root, f"{algo}_{env_name}.pt"))


def _to_tree(x: Any) -> Any:
    """Nested dicts/lists of tensors and Python scalars describing ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (nn.Module, torch.optim.Optimizer, Noise, ShardedNoise)):
        return _to_tree(x.state_dict())
    if hasattr(x, "_fields"):  # NamedTuple
        return {f: _to_tree(getattr(x, f)) for f in x._fields}
    if isinstance(x, dict):
        return {k: _to_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_tree(v) for v in x]
    if isinstance(x, _SCALARS):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def state_tree(ts: Any) -> Any:
    """The nested dicts and lists of tensors and scalars that a checkpoint
    of ``ts`` holds (this rank's part of it under a mesh)."""
    return _to_tree(ts)


def flat_state(tree: Any, prefix: str = "ts") -> dict[str, Any]:
    """``state_tree``'s leaves by dotted path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_state(sub, f"{prefix}.{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat_state(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def _check_same(example: Any, loaded: Any, path: str = "ts") -> None:
    """Raise ValueError unless ``loaded`` has ``example``'s structure, and
    every tensor its shape and dtype."""
    if isinstance(example, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"checkpoint mismatch at {path}: expected a mapping")
        if set(example) != set(loaded):
            missing = sorted(map(str, set(example) - set(loaded)))
            extra = sorted(map(str, set(loaded) - set(example)))
            raise ValueError(
                f"checkpoint mismatch at {path}: missing keys {missing}, "
                f"unexpected keys {extra}"
            )
        for k in example:
            _check_same(example[k], loaded[k], f"{path}.{k}")
    elif isinstance(example, list):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(example):
            raise ValueError(f"checkpoint mismatch at {path}: expected {len(example)} entries")
        for i, (e, v) in enumerate(zip(example, loaded)):
            _check_same(e, v, f"{path}[{i}]")
    elif isinstance(example, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"checkpoint mismatch at {path}: expected a tensor")
        if loaded.shape != example.shape or loaded.dtype != example.dtype:
            raise ValueError(
                f"checkpoint mismatch at {path}: file has {loaded.dtype}{list(loaded.shape)}, "
                f"state has {example.dtype}{list(example.shape)}"
            )
    elif type(loaded) is not type(example):
        raise ValueError(
            f"checkpoint mismatch at {path}: file has {type(loaded).__name__}, "
            f"state has {type(example).__name__}"
        )


def _load(example: Any, tree: Any) -> Any:
    """``example`` with ``tree``'s values: modules, optimizers, noise and
    bare parameters (SAC's ``log_alpha``) are loaded in place, NamedTuples
    rebuilt, other tensors moved to the example's device."""
    if isinstance(example, (nn.Module, torch.optim.Optimizer, Noise, ShardedNoise)):
        example.load_state_dict(tree)
        return example
    if hasattr(example, "_fields"):
        return type(example)(**{f: _load(getattr(example, f), tree[f]) for f in example._fields})
    if isinstance(example, dict):
        return {k: _load(v, tree[k]) for k, v in example.items()}
    if isinstance(example, (list, tuple)):
        return type(example)(_load(e, v) for e, v in zip(example, tree))
    if isinstance(example, nn.Parameter):  # an optimizer holds it: load in place
        with torch.no_grad():
            example.copy_(tree)
        return example
    if isinstance(example, torch.Tensor):
        return tree.to(example.device)
    return tree


def _modules(x: Any, out: list) -> list:
    """Every ``nn.Module`` of a state, in field order."""
    if isinstance(x, nn.Module):
        out.append(x)
    elif hasattr(x, "_fields") or isinstance(x, (list, tuple)):
        for v in x:
            _modules(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _modules(v, out)
    return out


def _layout(x: Any, spec: Any, split: dict[int, int]) -> Any:
    """A tree shaped as ``_to_tree(x)`` whose leaves are each tensor's
    layout (``mesh.train_state_shardings``): None, or ``(axis name, dim)``.
    ``spec`` is the field's layout, a dict of its subfields' or one for all
    its tensors; ``split`` maps ``id(param)`` to the dim of its ``model``
    split."""
    if isinstance(x, torch.Tensor):
        return spec if spec is not None and x.dim() > spec[1] else None
    if isinstance(x, nn.Module):
        named = dict(x.named_parameters())
        return {k: (("model", split[id(named[k])]) if k in named and id(named[k]) in split
                    else None) for k in x.state_dict()}
    if isinstance(x, torch.optim.Optimizer):
        params = [p for g in x.param_groups for p in g["params"]]
        tree = _to_tree(x.state_dict())
        for i, st in tree["state"].items():
            dim = split.get(id(params[i]))
            tree["state"][i] = {k: (("model", dim) if dim is not None and k != "step" else None)
                                for k in st}
        tree["param_groups"] = _layout(tree["param_groups"], None, split)
        return tree
    if isinstance(x, (Noise, ShardedNoise)):
        return _layout(_to_tree(x), None, split)
    if hasattr(x, "_fields"):
        return {f: _layout(getattr(x, f), spec.get(f) if isinstance(spec, dict) else spec, split)
                for f in x._fields}
    if isinstance(x, dict):
        return {k: _layout(v, spec, split) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_layout(v, spec, split) for v in x]
    return None


def state_layout(ts: Any) -> Any:
    """The layout of every tensor of ``_to_tree(ts)`` under a mesh."""
    split = {id(p): m.model_split[k] for m in _modules(ts, [])
             for k, p in m.named_parameters() if k in getattr(m, "model_split", {})}
    return _layout(ts, train_state_shardings(ts), split)


def _over(tree: Any, layout: Any, fn) -> Any:
    """``fn(tensor, (axis name, dim))`` on every split tensor of ``tree``."""
    if isinstance(tree, dict):
        return {k: _over(v, layout[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_over(v, lay, fn) for v, lay in zip(tree, layout)]
    if isinstance(tree, torch.Tensor) and layout is not None:
        return fn(tree, layout)
    return tree


def _strip_replay(ts: Any) -> Any:
    """``ts`` with its ``replay`` field set to None (never checkpointed)."""
    if hasattr(ts, "_replace") and hasattr(ts, "replay"):
        return ts._replace(replay=None)
    return ts


def gathered_state(ts: Any, mesh=None) -> Any:
    """``state_tree(ts)`` with every split leaf gathered whole over its mesh
    axis: the same tree on every rank, and the unsharded trainer's layout.
    Every rank of the mesh calls this."""
    tree = _to_tree(ts)
    if mesh is None:
        return tree
    return _over(tree, state_layout(ts), lambda x, lay: mesh.gather(x, lay[1], lay[0]))


def save_checkpoint(path: str, ts: Any, mesh=None) -> str:
    """Write ``ts`` to ``path``, its replay left out. Under a ``mesh`` every
    rank calls this: split leaves are gathered whole and rank 0 writes the
    file."""
    path = os.path.abspath(path)
    tree = gathered_state(_strip_replay(ts), mesh)
    if mesh is None or mesh.rank == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        mesh.barrier()  # the file exists for every rank after the call
    return path


def restore_checkpoint(path: str, example_ts: Any, mesh=None) -> Any:
    """Restore into ``example_ts`` (a fresh state of the same trainer config),
    raising ``ValueError`` on any structure, shape or dtype mismatch. The
    example's replay is kept: the file holds none. Under a ``mesh`` the
    file's whole tensors are checked against the example's whole shapes,
    and this rank keeps its rows and splits."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    stripped = _strip_replay(example_ts)
    example = _to_tree(stripped)
    if mesh is None:
        _check_same(example, tree)
        restored = _load(stripped, tree)
    else:
        layout = state_layout(stripped)

        def whole(x, lay):
            shape = list(x.shape)
            shape[lay[1]] *= mesh.shape[lay[0]]
            return torch.empty(shape, dtype=x.dtype, device="meta")

        _check_same(_over(example, layout, whole), tree)
        restored = _load(stripped, _over(tree, layout,
                                         lambda x, lay: mesh.shard(x, lay[1], lay[0]).clone()))
    if stripped is not example_ts:
        restored = restored._replace(replay=example_ts.replay)
    return restored
