from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit
from gymrl_tpu_torch.envs.registry import make, make_vec
from gymrl_tpu_torch.envs.rollout import VecEnv, VecState, VecTransition

__all__ = [
    "Env", "StepResult", "time_limit", "make", "make_vec",
    "VecEnv", "VecState", "VecTransition",
]
