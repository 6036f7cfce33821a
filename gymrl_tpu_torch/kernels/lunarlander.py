"""Wrappers of the LunarLander step and reset kernels (``lunarlander.cu``).

``lander_step(params, state, action, disp)`` computes what
``LunarLander.step_from_plain`` computes and ``lander_reset(params, draws)``
what ``LunarLander.reset_from_plain`` computes, for a batch on a CUDA
device, each in one launch: the step with a tile of two lanes per env,
the reset with one thread per env (the launchers pick the grid), its
outputs in three allocations (``_reset_outputs``).
``LunarLander.step_from`` / ``reset_from`` call them for every CUDA batch;
a tensor on another device is refused here, before anything is built.

The kernels' constants are ``-D`` defines made by ``defines()`` from the
Python module's constants, each rounded to float32 as the plain path
applies it: ``tensor / c`` on a CUDA tensor is PyTorch's product with the
reciprocal of ``c`` rounded to float32 (``LL_INV_*``), and ``c1 / c2`` of
two Python floats is a double quotient rounded once. So the ``.cu`` holds
no second copy.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.envs import lunarlander as ll
from gymrl_tpu_torch.envs.base import StepResult
from gymrl_tpu_torch.kernels import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lunarlander.cu")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C launchers' parameters in order (``lunarlander.cu``, ``extern "C"``).
STEP_ARGTYPES = [_P] * 27 + [_I] * 4 + [_F] * 4 + [_I, _P]
RESET_ARGTYPES = [_P] * 16 + [_I] * 2 + [_F] * 3 + [_I, _P]
TRIG_CHECK_ARGTYPES = [_P, _I, _P]

_LIB: ctypes.CDLL | None = None


def _reciprocal(c: float) -> np.float32:
    """What PyTorch's CUDA kernel multiplies by for ``tensor / c``: the
    double reciprocal of the Python float, rounded to float32 (for
    ``BODY_MASS`` one ulp from the reciprocal of its float32)."""
    return np.float32(1.0 / c)


def defines() -> dict[str, str]:
    """Every ``-D`` define of ``lunarlander.cu``: the float32 constants, as
    the plain path applies each, in hexadecimal literals (a body point
    array as one define per entry, ``LL_LEG_X0`` ...: nvcc splits a define's
    value at commas), and the integer shapes."""
    c = ll._make_consts(torch.device("cpu"))
    floats = {
        "LL_DT": ll.DT,
        "LL_INV_FPS": _reciprocal(ll.FPS),
        "LL_INV_SCALE": _reciprocal(ll.SCALE),
        "LL_INV_BODY_MASS": _reciprocal(ll.BODY_MASS),
        "LL_INV_BODY_INERTIA": _reciprocal(ll.BODY_INERTIA),
        "LL_INV_WIND_INERTIA": _reciprocal(ll.WIND_INERTIA),
        "LL_INV_DX": _reciprocal(ll._DX),
        "LL_DT_OVER_MASS": ll.DT / ll.BODY_MASS,
        "LL_COM_Y": ll.COM_Y,
        "LL_MAIN_POWER": ll.MAIN_ENGINE_POWER,
        "LL_SIDE_POWER": ll.SIDE_ENGINE_POWER,
        "LL_SIDE_AWAY": ll.SIDE_ENGINE_AWAY,
        "LL_SIDE_HEIGHT": ll.SIDE_ENGINE_HEIGHT,
        "LL_MAIN_Y": ll.MAIN_ENGINE_Y_LOCATION / ll.SCALE,
        "LL_WIND_FREQ": ll.WIND_FREQ,
        "LL_WIND_FREQ_PI": ll.WIND_FREQ_PI,
        "LL_WIND_LEVER": ll.WIND_TORQUE_LEVER,
        "LL_CONTACT_FRICTION": ll.CONTACT_FRICTION,
        "LL_BAUMGARTE": ll.BAUMGARTE,
        "LL_LINEAR_SLOP": ll.LINEAR_SLOP,
        "LL_MAX_CORRECTION": ll.MAX_CORRECTION,
        "LL_SLEEP_LIN_TOL": ll.SLEEP_LIN_TOL,
        "LL_SLEEP_ANG_TOL": ll.SLEEP_ANG_TOL,
        "LL_TIME_TO_SLEEP": ll.TIME_TO_SLEEP,
        "LL_X_MAX": ll._X_MAX,
        "LL_HELIPAD_Y": ll.HELIPAD_Y,
        "LL_TERRAIN_SMOOTH": ll.TERRAIN_SMOOTH,
        "LL_MAIN_FUEL": ll.MAIN_FUEL,
        "LL_SIDE_FUEL": ll.SIDE_FUEL,
        "LL_SPAWN_X": c.spawn[0], "LL_SPAWN_Y": c.spawn[1],
        "LL_OBS_OFF_X": c.obs_pos_off[0], "LL_OBS_OFF_Y": c.obs_pos_off[1],
        "LL_OBS_SCALE_X": c.obs_pos_scale[0], "LL_OBS_SCALE_Y": c.obs_pos_scale[1],
        "LL_OBS_VEL_SCALE_X": c.obs_vel_scale[0], "LL_OBS_VEL_SCALE_Y": c.obs_vel_scale[1],
    }
    points = {"LL_LEG_X": c.leg_x, "LL_LEG_Y": c.leg_y,
              "LL_HULL_X": c.pts_x[ll.N_LEG:], "LL_HULL_Y": c.pts_y[ll.N_LEG:]}
    out = {name: build.float_literal(float(v)) for name, v in floats.items()}
    for name, values in points.items():
        out.update((f"{name}{i}", build.float_literal(v)) for i, v in enumerate(values.tolist()))
    pad = np.flatnonzero(ll._PAD)
    out.update(LL_CHUNKS=str(ll.CHUNKS), LL_N_LEG=str(ll.N_LEG), LL_N_HULL=str(len(ll.HULL_PTS)),
               LL_SWEEPS=str(ll.SOLVER_SWEEPS), LL_PAD_MASK=str(int(sum(1 << int(k) for k in pad))))
    return out


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("lunarlander", SOURCE, defines())
        lib.lander_step_launch.argtypes = STEP_ARGTYPES
        lib.lander_step_launch.restype = ctypes.c_int
        lib.lander_reset_launch.argtypes = RESET_ARGTYPES
        lib.lander_reset_launch.restype = ctypes.c_int
        lib.trig_check_launch.argtypes = TRIG_CHECK_ARGTYPES
        lib.trig_check_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_device(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel, but its input is on {x.device}; "
                         f"the plain path is LunarLander.{what.split('_')[1]}_from_plain")


def _expect(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the batch on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, the kernel takes {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, the kernel takes {shape}")
    return x.contiguous()  # a no-op unless a view arrives


def _launch(fn, tensors, scalars, device: torch.device, what: str) -> None:
    kernels.launch(fn, [*tensors, *scalars], device, what)


def _dt_g(params) -> float:
    return float(np.float32(ll.DT) * np.float32(params.gravity))


def lander_step(params: ll.LunarLanderParams, state: ll.LunarLanderState,
                action: torch.Tensor, disp: torch.Tensor, continuous: bool = False,
                max_steps: int = ll.LunarLander.max_steps) -> StepResult:
    """One step of a batch on the card: ``step_from_plain``'s result, with
    ``terrain`` (and, without wind, the wind indices) passed through."""
    _check_device(state.angle, "lander_step")
    dev = state.angle.device
    num = state.angle.shape[0]
    f32, i32 = torch.float32, torch.int32
    if continuous:
        if not action.is_floating_point():
            raise TypeError(f"a continuous action is {action.dtype}, not a float tensor")
        action = _expect("action", action.float(), f32, (num, 2), dev)
    else:
        if action.is_floating_point() or action.is_complex() or action.dtype == torch.bool:
            raise TypeError(f"a discrete action is {action.dtype}, not an integer tensor")
        action = _expect("action", action.to(i32), i32, (num,), dev)
    wind = bool(params.enable_wind)
    ins = [
        _expect("pos", state.pos, f32, (num, 2), dev),
        _expect("vel", state.vel, f32, (num, 2), dev),
        _expect("angle", state.angle, f32, (num,), dev),
        _expect("omega", state.omega, f32, (num,), dev),
        _expect("prev_shaping", state.prev_shaping, f32, (num,), dev),
        _expect("sleep_time", state.sleep_time, f32, (num,), dev),
        _expect("terrain", state.terrain, f32, (num, ll.CHUNKS), dev),
        _expect("wind_idx", state.wind_idx, i32, (num,), dev),
        _expect("torque_idx", state.torque_idx, i32, (num,), dev),
        _expect("t", state.t, i32, (num,), dev),
        _expect("leg_contact", state.leg_contact, torch.bool, (num, 2), dev),
        action,
        _expect("disp", disp, f32, (num, 2), dev),
    ]

    def empty(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pos, vel, angle, omega = empty((num, 2)), empty((num, 2)), empty(num), empty(num)
    shaping, sleep_time, t = empty(num), empty(num), empty(num, i32)
    wind_idx = empty(num, i32) if wind else ins[7]
    torque_idx = empty(num, i32) if wind else ins[8]
    leg_contact = empty((num, 2), torch.bool)
    obs, reward = empty((num, 8)), empty(num)
    terminated, truncated = empty(num, torch.bool), empty(num, torch.bool)
    if num > 0:
        lib = _library()
        _launch(lib.lander_step_launch,
                [*ins, pos, vel, angle, omega, shaping, sleep_time, wind_idx, torque_idx, t,
                 leg_contact, obs, reward, terminated, truncated],
                [num, int(continuous), int(wind), int(max_steps),
                 float(params.dispersion_scale), float(params.wind_power),
                 float(params.turbulence_power), _dt_g(params)], dev, "lander_step")
        kernels.LAUNCHES["lunarlander_step"] += 1
    new_state = ll.LunarLanderState(
        pos=pos, vel=vel, angle=angle, omega=omega, terrain=ins[6], prev_shaping=shaping,
        sleep_time=sleep_time, wind_idx=wind_idx, torque_idx=torque_idx,
        leg_contact=leg_contact, t=t)
    return StepResult(new_state, obs, reward, terminated, truncated)


def _reset_outputs(num: int, dev: torch.device):
    """The reset's state and obs, uninitialised, in three allocations: one
    float32 buffer cut into obs, pos, vel, terrain and the four float fields,
    in that order, so that obs lies on 16 bytes and pos and vel on 8 (the
    kernel's float4 and float2 stores), one int32 buffer cut into the three
    counters, and ``leg_contact``. Each field is a contiguous tensor of its
    own shape; no field's elements overlap another's."""
    sizes = (8 * num, 2 * num, 2 * num, ll.CHUNKS * num, num, num, num, num)
    obs, pos, vel, terrain, angle, omega, shaping, sleep_time = torch.empty(
        sum(sizes), dtype=torch.float32, device=dev).split(sizes)
    wind_idx, torque_idx, t = torch.empty((3, num), dtype=torch.int32, device=dev)
    state = ll.LunarLanderState(
        pos=pos.view(num, 2), vel=vel.view(num, 2), angle=angle, omega=omega,
        terrain=terrain.view(num, ll.CHUNKS), prev_shaping=shaping, sleep_time=sleep_time,
        wind_idx=wind_idx, torque_idx=torque_idx,
        leg_contact=torch.empty((num, 2), dtype=torch.bool, device=dev), t=t)
    return state, obs.view(num, 8)


def lander_reset(params: ll.LunarLanderParams, draws: ll.ResetDraws):
    """A batched reset on the card: ``reset_from_plain``'s ``(state, obs)``,
    with ``pos`` materialised."""
    _check_device(draws.height_u, "lander_reset")
    dev = draws.height_u.device
    num = draws.height_u.shape[0]
    f32, i32 = torch.float32, torch.int32
    ins = [
        _expect("height_u", draws.height_u, f32, (num, ll.CHUNKS + 1), dev),
        _expect("force", draws.force, f32, (num, 2), dev),
        _expect("wind_idx", draws.wind_idx, i32, (num,), dev),
        _expect("torque_idx", draws.torque_idx, i32, (num,), dev),
    ]

    state, obs = _reset_outputs(num, dev)
    if num > 0:
        lib = _library()
        _launch(lib.lander_reset_launch,
                [*ins, state.pos, state.vel, state.angle, state.omega, state.terrain,
                 state.prev_shaping, state.sleep_time, state.wind_idx, state.torque_idx,
                 state.leg_contact, state.t, obs],
                [num, int(bool(params.enable_wind)), float(params.wind_power),
                 float(params.turbulence_power), _dt_g(params)], dev, "lander_reset")
        kernels.LAUNCHES["lunarlander_reset"] += 1
    return state, obs


def trig_mismatches(device: torch.device) -> tuple[int, int]:
    """How many of the 2^32 float32 inputs get another sin or cos from the
    kernels' own ``lib_sinf`` / ``lib_sincosf`` than from the CUDA math
    library's ``sinf`` / ``cosf`` on ``device`` (``trig_check``; two NaNs
    agree). The kernels keep the library's bits only if both are 0."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"trig_mismatches runs on a CUDA device, not {device}")
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    _launch(_library().trig_check_launch, [counts], [], counts.device, "trig_check")
    return tuple(int(x) for x in counts.cpu())
