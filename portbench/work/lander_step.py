"""Work of one ``lander_step`` launch over the env batch, as
``chip_smoke.py`` phase 18 counts it (:2717-2720, :2909-2928), discrete
actions without wind.

Bytes: each input the windless step reads, once (pos, vel f32[2], angle,
omega, prev_shaping, sleep_time f32, terrain f32[11], t i32, the action i32,
the dispersion f32[2]: 92 B) and each output written once (the state but
the terrain and the wind indices, which pass through: 38 B; obs f32[8],
reward f32, terminated and truncated bool: 38 B): 168 B an env, 1,376,256 B
at 8192 envs. Operations: 2,580 float32 operations an env, counted in
``lunarlander.cu`` (1,960 of them the 10-sweep × 4-point contact solve).
"""

BYTES_PER_ENV = 92 + 38 + 38
OPS_PER_ENV = 2580


def launch_bytes(cfg: dict) -> int:
    return BYTES_PER_ENV * cfg["num_envs"]


def launch_ops(cfg: dict) -> int:
    return OPS_PER_ENV * cfg["num_envs"]


def least_s(cfg: dict, peaks: dict) -> float:
    return max(launch_bytes(cfg) / peaks["hbm_bytes_per_s"],
               launch_ops(cfg) / peaks["f32_flops_per_s"])
