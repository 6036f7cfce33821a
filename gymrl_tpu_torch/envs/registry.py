"""Environment registry (counterpart of ``gymrl_tpu/envs/registry.py``).

Only the engines the port has so far are registered; an unknown name
raises ``KeyError`` listing them.
"""

from __future__ import annotations

from gymrl_tpu_torch.envs.base import Env
from gymrl_tpu_torch.envs.cartpole import CartPole
from gymrl_tpu_torch.envs.flappybird import FlappyBird
from gymrl_tpu_torch.envs.lunarlander import LunarLander
from gymrl_tpu_torch.envs.pendulum import Pendulum
from gymrl_tpu_torch.envs.rollout import VecEnv

_REGISTRY: dict[str, type[Env]] = {
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
    "LunarLander-v2": LunarLander,
    "LunarLander-v3": LunarLander,
    "FlappyBird-v0": FlappyBird,
}


def make(name: str, **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown env '{name}'. The port has: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def make_vec(name: str, num_envs: int, env_kwargs: dict | None = None) -> VecEnv:
    env = make(name, **(env_kwargs or {}))
    return VecEnv(env, env.default_params(), num_envs)
