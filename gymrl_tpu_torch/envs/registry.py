"""Environment registry (counterpart of ``gymrl_tpu/envs/registry.py``).

Every engine of the JAX package is registered under the same name; an
unknown name raises ``KeyError`` listing them.
"""

from __future__ import annotations

from gymrl_tpu_torch.envs.base import Env
from gymrl_tpu_torch.envs.cartpole import CartPole
from gymrl_tpu_torch.envs.cliffwalking import CliffWalking
from gymrl_tpu_torch.envs.flappybird import FlappyBird
from gymrl_tpu_torch.envs.frozenlake import FrozenLake
from gymrl_tpu_torch.envs.lunarlander import LunarLander
from gymrl_tpu_torch.envs.mountaincar import MountainCar
from gymrl_tpu_torch.envs.pendulum import Pendulum
from gymrl_tpu_torch.envs.pixels import CartPolePixels
from gymrl_tpu_torch.envs.rollout import VecEnv

_REGISTRY: dict[str, type[Env]] = {
    "CartPolePixels-v0": CartPolePixels,
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
    "MountainCar-v0": MountainCar,
    "FrozenLake-v1": FrozenLake,
    "CliffWalking-v0": CliffWalking,
    "LunarLander-v2": LunarLander,
    "LunarLander-v3": LunarLander,
    "FlappyBird-v0": FlappyBird,
}


def make(name: str, **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown env '{name}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def make_vec(name: str, num_envs: int, env_kwargs: dict | None = None) -> VecEnv:
    env = make(name, **(env_kwargs or {}))
    return VecEnv(env, env.default_params(), num_envs)
