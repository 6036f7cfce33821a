"""Checkpoint / resume (counterpart of ``gymrl_tpu/utils/checkpoint.py``).

The whole train state — params, targets, optimizer moments and step
counts, replay contents (with the PER sum-tree and max priority), the
n-step window, env batch, the recurrent trainers' GRU hidden per env,
normalization stats and reward scaler, PER β, the noise generator's state
and the counters — is one ``torch.save`` file, so a restore puts training
and eval-time normalization back exactly.

Restore is strict. The file must have exactly the structure of the example
state it is restored into, with every tensor of the same shape and dtype;
anything else raises ``ValueError`` naming the first mismatch. There is no
fallback that keeps fresh values for fields that do not fit.
"""

from __future__ import annotations

import os
from typing import Any

import torch
from torch import nn

from gymrl_tpu_torch.core.noise import Noise

_SCALARS = (bool, int, float, str, type(None))


def checkpoint_path(algo: str, env_name: str, root: str = "./checkpoints") -> str:
    """./checkpoints/{algo}_{env}.pt — reference utils/model.py:332 layout."""
    return os.path.abspath(os.path.join(root, f"{algo}_{env_name}.pt"))


def _to_tree(x: Any) -> Any:
    """Nested dicts/lists of tensors and Python scalars describing ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (nn.Module, torch.optim.Optimizer, Noise)):
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
    if isinstance(example, (nn.Module, torch.optim.Optimizer, Noise)):
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


def save_checkpoint(path: str, ts: Any) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_tree(ts), tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, example_ts: Any) -> Any:
    """Restore into ``example_ts`` (a fresh state of the same trainer config),
    raising ``ValueError`` on any structure, shape or dtype mismatch."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    _check_same(_to_tree(example_ts), tree)
    return _load(example_ts, tree)
