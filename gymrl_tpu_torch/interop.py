"""Carry weights and state between the JAX package and the port.

Numpy in, numpy or torch out; nothing here imports JAX. Flax ``Dense``
kernels are ``[in, out]`` and torch weights ``[out, in]``, so
``weight = kernel.T``; flax ``Conv`` kernels are HWIO and the port's
``Conv`` weights OIHW; module names map one to one, nested modules by
dotted path (``{"q1": {"fc1": ...}}`` → ``q1.fc1.weight``). A vector
raveled by ``jax.flatten_util.ravel_pytree`` (the JAX package's flat
optimizer keeps its Adam moments so) is split with ``unravel_flax``, which
follows the same leaf order: a dict's keys sorted at every level.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from gymrl_tpu_torch.envs.lunarlander import LunarLanderState
from gymrl_tpu_torch.envs.rollout import VecState
from gymrl_tpu_torch.replay.per import PERState
from gymrl_tpu_torch.replay.uniform import ReplayState


def _field(x: Any, name: str):
    return x[name] if isinstance(x, Mapping) else getattr(x, name)


def _tensor(x, device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A flax params tree (``{"params": {...}}`` or its inner dict) of
    numpy-convertible leaves → a torch ``state_dict``. A ``kernel`` leaf is a
    ``Dense`` weight (transposed) or a ``Conv`` weight (HWIO → OIHW); every
    other leaf keeps its name and layout (a bias, ``NoisyDense``'s and
    ``NoisyConv2d``'s ``kernel_mu``/``kernel_sigma``/``bias_mu``/
    ``bias_sigma``, ``PReLU``'s 0-dim ``negative_slope``, ``LayerNorm``'s
    ``scale``); a dict is a module, by dotted path."""
    state: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, f"{prefix}{name}.")
            elif name == "kernel":
                k = np.array(child, np.float32)
                k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
                state[f"{prefix}weight"] = torch.from_numpy(k.copy())
            else:
                state[f"{prefix}{name}"] = torch.from_numpy(np.array(child, np.float32))

    walk(tree.get("params", tree), "")
    return state


def params_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``params_from_flax``: ``{"params": {...}}`` of numpy."""
    root: dict[str, Any] = {}
    for key, value in state.items():
        *path, kind = key.split(".")
        node = root
        for name in path:
            node = node.setdefault(name, {})
        arr = value.detach().cpu().numpy()
        if kind == "weight":
            node["kernel"] = (arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T).copy()
        else:
            node[kind] = arr.copy()
    return {"params": root}


def _flax_leaves(tree: Mapping, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    """``(path, leaf)`` in ``jax.tree_util``'s order: a dict's keys sorted at
    every level."""
    out = []
    for name in sorted(tree):
        child = tree[name]
        if isinstance(child, Mapping):
            out.extend(_flax_leaves(child, prefix + (name,)))
        else:
            out.append((prefix + (name,), np.asarray(child)))
    return out


def ravel_flax(tree: Mapping) -> np.ndarray:
    """``jax.flatten_util.ravel_pytree``'s vector of a params tree: every
    leaf raveled in C order, concatenated in ``jax.tree_util`` order."""
    return np.concatenate([leaf.ravel() for _, leaf in _flax_leaves(tree)])


def unravel_flax(vector, like: Mapping) -> dict:
    """Inverse of ``ravel_flax``: ``vector`` split into a tree shaped as
    ``like``."""
    vector = np.asarray(vector)
    leaves = _flax_leaves(like)
    total = sum(leaf.size for _, leaf in leaves)
    if total != vector.size:
        raise ValueError(f"a vector of {vector.size} entries for a tree of {total}")
    root: dict[str, Any] = {}
    off = 0
    for path, leaf in leaves:
        node = root
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = vector[off:off + leaf.size].reshape(leaf.shape)
        off += leaf.size
    return root


def _scale_by_adam_state(opt_state: Any):
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state (``optax.adam`` is a chain: a tuple of states)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _scale_by_adam_state(s)
            if found is not None:
                return found
    return None


def load_adam_state(opt: torch.optim.Adam, params: nn.Module | torch.Tensor,
                    opt_state: Any) -> None:
    """Put an optax Adam state (numpy leaves) into the torch Adam ``opt`` over
    ``params`` (a module, or one parameter such as a 0-dim ``log_alpha``):
    ``count`` → ``step``, ``mu`` → ``exp_avg``, ``nu`` → ``exp_avg_sq``.
    For a module the moments are a params tree, or one raveled vector (the
    JAX package's ``flat_optimizer``), split in ``ravel_pytree``'s leaf
    order of the module's flax tree."""
    adam_state = _scale_by_adam_state(opt_state)
    if adam_state is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optax state")
    step = torch.tensor(float(np.asarray(adam_state.count)))
    if isinstance(params, nn.Module):
        mu, nu = adam_state.mu, adam_state.nu
        if not isinstance(mu, Mapping):  # one raveled vector
            like = params_to_flax(dict(params.named_parameters()))
            mu, nu = unravel_flax(mu, like), unravel_flax(nu, like)
        mu, nu = params_from_flax(mu), params_from_flax(nu)
        named = list(params.named_parameters())
        moments = [(p, mu[name], nu[name]) for name, p in named]
    else:
        moments = [(params, _tensor(adam_state.mu), _tensor(adam_state.nu))]
    for p, m, v in moments:
        opt.state[p] = {
            "step": step.clone(),
            "exp_avg": m.to(device=p.device, dtype=p.dtype).reshape(p.shape).clone(),
            "exp_avg_sq": v.to(device=p.device, dtype=p.dtype).reshape(p.shape).clone(),
        }


def adam_state_to_flax(opt: torch.optim.Adam, net: nn.Module, flat: bool):
    """The torch Adam ``opt`` over ``net`` as optax's ``(count, mu, nu)``:
    numpy params trees, or with ``flat`` raveled vectors in
    ``ravel_pytree``'s order (the inverse of ``load_adam_state``)."""
    named = list(net.named_parameters())
    mu = params_to_flax({n: opt.state[p]["exp_avg"] for n, p in named})
    nu = params_to_flax({n: opt.state[p]["exp_avg_sq"] for n, p in named})
    count = np.int32(int(opt.state[named[0][1]]["step"]))
    if flat:
        mu, nu = ravel_flax(mu), ravel_flax(nu)
    return count, mu, nu


def state_from_numpy(state: Any, cls: type | tuple, device: str | torch.device = "cpu"):
    """A batched env state (a NamedTuple or mapping of numpy arrays with the
    reference's field names) → the port's state class ``cls``. For a state
    that nests another (``PixelState`` holds its engine's), ``cls`` is a
    port state of that structure, whose nested classes the result takes."""
    if not isinstance(cls, tuple):
        return cls(**{f: _tensor(_field(state, f), device) for f in cls._fields})
    return type(cls)(**{
        f: (state_from_numpy(_field(state, f), like, device) if isinstance(like, tuple)
            else _tensor(_field(state, f), device))
        for f, like in zip(cls._fields, cls)})


def state_to_numpy(state: Any) -> dict[str, Any]:
    return {f: state_to_numpy(x) if isinstance(x, tuple) else x.detach().cpu().numpy()
            for f, x in zip(state._fields, state)}


def lander_state_from_numpy(state: Any, device: str | torch.device = "cpu") -> LunarLanderState:
    return state_from_numpy(state, LunarLanderState, device)


def vec_state_from_numpy(vstate: Any, device: str | torch.device = "cpu",
                         state_cls: type | tuple = LunarLanderState) -> VecState:
    """A reference ``VecState`` of numpy arrays → the port's; ``state_cls``
    is the env's state class, or a port env state (``state_from_numpy``)."""
    return VecState(
        env_state=state_from_numpy(_field(vstate, "env_state"), state_cls, device),
        **{f: _tensor(_field(vstate, f), device) for f in ("obs", "ep_return", "ep_length")},
    )


def vec_state_to_numpy(vstate: VecState) -> dict[str, Any]:
    return {
        "env_state": state_to_numpy(vstate.env_state),
        **{f: getattr(vstate, f).detach().cpu().numpy() for f in ("obs", "ep_return", "ep_length")},
    }


def replay_from_numpy(ref_replay: Any, data_cls: type,
                      device: str | torch.device = "cpu") -> ReplayState | PERState:
    """A reference ``ReplayState`` or ``PERState`` of numpy arrays → the
    port's; ``data_cls`` is the port's transition class."""
    data = data_cls(*(_tensor(_field(ref_replay.data, f), device) for f in data_cls._fields))
    common = dict(data=data, pos=int(ref_replay.pos), size=int(ref_replay.size))
    if hasattr(ref_replay, "tree"):
        return PERState(tree=_tensor(ref_replay.tree, device),
                        max_priority=_tensor(ref_replay.max_priority, device), **common)
    return ReplayState(**common)


def replay_to_numpy(replay: ReplayState | PERState) -> dict[str, Any]:
    out = {"data": state_to_numpy(replay.data), "pos": replay.pos, "size": replay.size}
    if isinstance(replay, PERState):
        out.update(tree=replay.tree.detach().cpu().numpy(),
                   max_priority=replay.max_priority.detach().cpu().numpy())
    return out


def _norm_stats(ts, ref_ts, dev) -> dict:
    """The obs statistics and reward scaler of ``ref_ts`` as the port's."""
    rms = type(ts.obs_rms)
    scaler = ref_ts.reward_scaler
    return dict(
        obs_rms=rms(*(_tensor(x, dev) for x in ref_ts.obs_rms)),
        reward_scaler=type(ts.reward_scaler)(
            rms=rms(*(_tensor(x, dev) for x in scaler.rms)),
            ret=_tensor(scaler.ret, dev), gamma=float(np.asarray(scaler.gamma))),
    )


def train_state_from_reference(trainer, ref_ts: Any, noise=None):
    """A whole ``jax.device_get``-ed ``DQNTrainState``,
    ``OffPolicyTrainState``, ``FamilyTrainState``, ``RNNTrainState``,
    ``FullTrainState``, ``LSTMTrainState`` or ``QLearningTrainState`` → the
    port trainer's state (a Q-table with its counters, or):
    nets, targets and Adam states (a raveled flat optimizer's too), replay
    contents (and the PER sum-tree) with ``pos`` and ``size``, the env
    batch, the n-step window, the recurrent hidden, normalization
    statistics, β and the counters. The JAX key has no torch counterpart:
    ``noise`` replaces it (default: the fresh state's own ``Noise``); so do
    the per-env keys of a FlappyBird batch, which are dropped."""
    ts = trainer.init(0)
    dev = trainer.device
    vec_state = vec_state_from_numpy(ref_ts.vec_state, dev, ts.vec_state.env_state)
    noise = ts.noise if noise is None else noise
    if hasattr(ref_ts, "q_table"):  # tabular Q-learning
        return ts._replace(q_table=_tensor(ref_ts.q_table, dev), vec_state=vec_state,
                           noise=noise, env_steps=int(ref_ts.env_steps),
                           sample_count=int(ref_ts.sample_count))
    if not hasattr(ref_ts, "replay"):  # the on-policy trainers
        ts.params.load_state_dict(params_from_flax(ref_ts.params))
        load_adam_state(ts.opt_state, ts.params, ref_ts.opt_state)
        extra = {}
        if hasattr(ref_ts, "hidden"):
            extra["hidden"] = _tensor(ref_ts.hidden, dev)
        if hasattr(ref_ts, "reward_scaler"):
            extra.update(_norm_stats(ts, ref_ts, dev))
        return ts._replace(vec_state=vec_state, noise=noise, env_steps=int(ref_ts.env_steps),
                           **extra)
    common = dict(
        replay=replay_from_numpy(ref_ts.replay, type(ts.replay.data), dev),
        vec_state=vec_state, noise=noise, env_steps=int(ref_ts.env_steps),
    )
    if hasattr(ref_ts, "target_params"):  # DQN and the DQN family
        ts.params.load_state_dict(params_from_flax(ref_ts.params))
        ts.target_params.load_state_dict(params_from_flax(ref_ts.target_params))
        load_adam_state(ts.opt_state, ts.params, ref_ts.opt_state)
        common.update(episodes=_tensor(ref_ts.episodes, dev),
                      target_syncs=_tensor(ref_ts.target_syncs, dev))
        if not hasattr(ref_ts, "beta"):
            return ts._replace(**common)
        window = ref_ts.window
        return ts._replace(
            **common,
            window=None if window is None else type(ts.window)(
                *(_tensor(x, dev) for x in window)),
            **_norm_stats(ts, ref_ts, dev),
            learn_steps=int(ref_ts.learn_steps),
            beta=_tensor(ref_ts.beta, dev),
        )
    for name, net in ts.nets.items():
        if isinstance(net, nn.Module):
            net.load_state_dict(params_from_flax(ref_ts.nets[name]))
        else:
            with torch.no_grad():
                net.copy_(_tensor(ref_ts.nets[name]))
        load_adam_state(ts.opts[name], net, ref_ts.opts[name])
    for name, target in ts.targets.items():
        target.load_state_dict(params_from_flax(ref_ts.targets[name]))
    return ts._replace(**common, learn_steps=int(ref_ts.learn_steps))
