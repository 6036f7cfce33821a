"""Carry weights and env state between the JAX package and the port.

Numpy in, numpy or torch out; nothing here imports JAX. Flax ``Dense``
kernels are ``[in, out]`` and torch weights ``[out, in]``, so
``weight = kernel.T``; module names map one to one.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from gymrl_tpu_torch.envs.lunarlander import LunarLanderState
from gymrl_tpu_torch.envs.rollout import VecState


def _field(x: Any, name: str):
    return x[name] if isinstance(x, Mapping) else getattr(x, name)


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A flax params tree (``{"params": {name: {"kernel", "bias"}}}`` or its
    inner dict) of numpy-convertible leaves → a torch ``state_dict``."""
    layers = tree.get("params", tree)
    state = {}
    for name, leaf in layers.items():
        state[f"{name}.weight"] = torch.from_numpy(np.array(leaf["kernel"], np.float32).T.copy())
        if "bias" in leaf:
            state[f"{name}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
    return state


def params_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``params_from_flax``: ``{"params": {name: {"kernel", "bias"}}}`` of numpy."""
    layers: dict[str, dict[str, np.ndarray]] = {}
    for key, value in state.items():
        name, kind = key.rsplit(".", 1)
        arr = value.detach().cpu().numpy()
        layers.setdefault(name, {})["kernel" if kind == "weight" else "bias"] = (
            arr.T.copy() if kind == "weight" else arr.copy()
        )
    return {"params": layers}


def lander_state_from_numpy(state: Any, device: str | torch.device = "cpu") -> LunarLanderState:
    """A batched lander state (a NamedTuple or mapping of numpy arrays with
    the reference's field names) → the port's ``LunarLanderState``."""
    return LunarLanderState(**{
        f: torch.from_numpy(np.array(_field(state, f))).to(device)
        for f in LunarLanderState._fields
    })


def lander_state_to_numpy(state: LunarLanderState) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).detach().cpu().numpy() for f in LunarLanderState._fields}


def vec_state_from_numpy(vstate: Any, device: str | torch.device = "cpu") -> VecState:
    """A reference ``VecState`` of numpy arrays (lander env) → the port's."""
    return VecState(
        env_state=lander_state_from_numpy(_field(vstate, "env_state"), device),
        **{f: torch.from_numpy(np.array(_field(vstate, f))).to(device)
           for f in ("obs", "ep_return", "ep_length")},
    )


def vec_state_to_numpy(vstate: VecState) -> dict[str, Any]:
    return {
        "env_state": lander_state_to_numpy(vstate.env_state),
        **{f: getattr(vstate, f).detach().cpu().numpy() for f in ("obs", "ep_return", "ep_length")},
    }
