"""Plain PyTorch LunarLander, batched: the yardstick's copy of the env.

A frozen copy of the port's plain path (``gymrl_tpu_torch/envs/lunarlander.py``
``reset_from_plain`` :291-321 and ``_physics_step`` :340-528, with
``envs/base.py`` ``time_limit`` :87-89 and ``envs/rollout.py`` ``VecEnv.step``
:343-371), discrete actions without wind, as the benchmark's configurations
run it. Later changes to the program do not change it. It imports nothing of
the program and runs as eager PyTorch on any device; the program's CUDA
kernels are judged against it.

The draws are the program's, in its order (``reference/draws.py`` and
``VecLander``'s ``reset_draws`` / ``step_draws``, copies of the lander's
:247-256): on one device and seed they are the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.draws import Draws

FPS = 50.0
DT = 1.0 / FPS
SCALE = 30.0
MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6
INITIAL_RANDOM = 1000.0
SIDE_ENGINE_HEIGHT = 14.0
SIDE_ENGINE_AWAY = 12.0
MAIN_ENGINE_Y_LOCATION = 4.0
W = 600.0 / SCALE
H = 400.0 / SCALE
CHUNKS = 11
HELIPAD_Y = H / 4.0
LEG_DOWN = 18.0 / SCALE
BODY_MASS = 4.9588888
COM_Y = 0.09840133
BODY_INERTIA = 0.90152451
GRAVITY = -10.0
MAX_STEPS = 1000
OBS_DIM = 8
N_ACTIONS = 4
HULL_PTS = np.array(
    [(-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17)], np.float32) / SCALE


def _leg_corners() -> np.ndarray:
    pts = []
    for i, rel in ((-1, +0.4), (+1, -0.4)):
        c, s = np.cos(rel), np.sin(rel)
        rot = np.array([[c, -s], [s, c]])
        anchor = np.array([i * 20.0 / SCALE, 18.0 / SCALE])
        center = -rot @ anchor
        for corner in (np.array([-2.0 / SCALE, -8.0 / SCALE]),
                       np.array([2.0 / SCALE, -8.0 / SCALE])):
            pts.append(center + rot @ corner)
    return np.array(pts, np.float32)


LEG_PTS = _leg_corners()
N_LEG = LEG_PTS.shape[0]
CONTACT_FRICTION = float(np.sqrt(0.1 * 0.2))
SOLVER_SWEEPS = 10
BAUMGARTE = 0.2
LINEAR_SLOP = 0.005
SLEEP_LIN_TOL = 0.01
SLEEP_ANG_TOL = 2.0 / 180.0 * np.pi
TIME_TO_SLEEP = 0.5
MAX_CORRECTION = 0.2
TERRAIN_SMOOTH = 0.33
MAIN_FUEL = 0.30
SIDE_FUEL = 0.03
_DX = W / (CHUNKS - 1)
_X_MAX = CHUNKS - 1 - 1e-6
_PAD = (np.arange(CHUNKS + 1) >= CHUNKS // 2 - 2) & (np.arange(CHUNKS + 1) <= CHUNKS // 2 + 2)


class State(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    angle: torch.Tensor
    omega: torch.Tensor
    terrain: torch.Tensor
    prev_shaping: torch.Tensor
    sleep_time: torch.Tensor
    wind_idx: torch.Tensor
    torque_idx: torch.Tensor
    leg_contact: torch.Tensor
    t: torch.Tensor


class Consts(NamedTuple):
    leg_x: torch.Tensor
    leg_y: torch.Tensor
    pts_x: torch.Tensor
    pts_y: torch.Tensor
    pad: torch.Tensor
    spawn: torch.Tensor
    obs_pos_off: torch.Tensor
    obs_pos_scale: torch.Tensor
    obs_vel_scale: torch.Tensor


def consts(device: torch.device) -> Consts:
    pts = np.concatenate([LEG_PTS, HULL_PTS], axis=0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return Consts(leg_x=t(LEG_PTS[:, 0]), leg_y=t(LEG_PTS[:, 1]),
                  pts_x=t(pts[:, 0]), pts_y=t(pts[:, 1]), pad=t(_PAD, torch.bool),
                  spawn=t([W / 2.0, H]), obs_pos_off=t([W / 2.0, HELIPAD_Y + LEG_DOWN]),
                  obs_pos_scale=t([W / 2.0, H / 2.0]), obs_vel_scale=t([W / 2.0, H / 2.0]))


def _body_points(pos, c, s, lx, ly):
    c, s = c[:, None], s[:, None]
    return pos[:, 0:1] + (lx * c - ly * s), pos[:, 1:2] + (lx * s + ly * c)


def _segment_lookup(terrain, x):
    xi = torch.clamp(x / _DX, 0.0, _X_MAX)
    i0 = torch.floor(xi)
    frac = xi - i0
    idx = i0.long()
    return torch.gather(terrain, 1, idx), torch.gather(terrain, 1, idx + 1), frac


def _height(t0, t1, frac):
    return t0 * (1.0 - frac) + t1 * frac


def _normal(t0, t1):
    slope = (t1 - t0) / _DX
    norm = torch.sqrt(slope * slope + 1.0)
    return (-slope) / norm, torch.reciprocal(norm)


def _obs(c: Consts, pos, vel, angle, omega, leg_contact):
    return torch.cat([(pos - c.obs_pos_off) / c.obs_pos_scale, vel * c.obs_vel_scale / FPS,
                      angle[:, None], (20.0 * omega / FPS)[:, None], leg_contact.float()], dim=1)


def _shaping(obs):
    o = obs.unbind(1)
    return (-100.0 * torch.sqrt(o[0] * o[0] + o[1] * o[1])
            - 100.0 * torch.sqrt(o[2] * o[2] + o[3] * o[3])
            - 100.0 * torch.abs(o[4]) + 10.0 * o[6] + 10.0 * o[7])


def physics_step(c: Consts, state: State, action, disp):
    """One step; ``action=None`` is the reset step (no engines, no
    contacts, no reward). Returns ``(state, obs, reward, terminated,
    truncated)``."""
    contacts = action is not None
    pos, vel, angle, omega = state.pos, state.vel, state.angle, state.omega
    s, co = torch.sin(angle), torch.cos(angle)
    com = torch.stack([pos[:, 0] - s * COM_Y, pos[:, 1] + co * COM_Y], dim=1)

    if contacts:
        a = action.to(torch.int32)
        m_power = (a == 2).float()
        side_on = (a == 1) | (a == 3)
        direction = torch.where(side_on, a.float() - 2.0, 0.0)
        s_power = side_on.float()
        d = disp / SCALE * 1.0
        d0, d1 = d[:, 0], d[:, 1]

        def apply_impulse(vel, omega, impulse, point):
            vel = vel + impulse / BODY_MASS
            r = point - com
            omega = omega + (r[:, 0] * impulse[:, 1] - r[:, 1] * impulse[:, 0]) / BODY_INERTIA
            return vel, omega

        x_m = MAIN_ENGINE_Y_LOCATION / SCALE + 2.0 * d0
        o_m = torch.stack([s * x_m - co * d1, -(co * x_m) - s * d1], dim=1)
        vel, omega = apply_impulse(vel, omega, -o_m * MAIN_ENGINE_POWER * m_power[:, None],
                                   pos + o_m)
        y_s = 3.0 * d1 + direction * SIDE_ENGINE_AWAY / SCALE
        ox_s = s * d0 - co * y_s
        oy_s = -(co * d0) - s * y_s
        o_s = torch.stack([ox_s, oy_s], dim=1)
        impulse_pos_s = torch.stack([pos[:, 0] + ox_s - s * 17.0 / SCALE,
                                     pos[:, 1] + oy_s + co * SIDE_ENGINE_HEIGHT / SCALE], dim=1)
        vel, omega = apply_impulse(vel, omega, -o_s * SIDE_ENGINE_POWER * s_power[:, None],
                                   impulse_pos_s)

    dt_g = float(np.float32(DT) * np.float32(GRAVITY))
    vel = torch.stack([vel[:, 0], vel[:, 1] + dt_g], dim=1)

    if contacts:
        wx, wy = _body_points(pos, co, s, c.leg_x, c.leg_y)
        t0, t1, frac = _segment_lookup(state.terrain, wx)
        touching = (_height(t0, t1, frac) - wy) > 0.0
        nx, ny = _normal(t0, t1)
        rx = wx - com[:, 0:1]
        ry = wy - com[:, 1:2]
        tx, ty = ny, -nx
        rn = rx * ny - ry * nx
        rt = rx * ty - ry * tx
        neg_k_n = -(1.0 / BODY_MASS + rn * rn / BODY_INERTIA)
        neg_k_t = -(1.0 / BODY_MASS + rt * rt / BODY_INERTIA)
        n_pts = torch.stack([nx, ny], dim=2)
        t_pts = torch.stack([tx, ty], dim=2)
        r_perp = torch.stack([-ry, rx], dim=2)

        def push(vel, omega, d, direction, r_perp):
            impulse = d[:, None] * direction
            return (vel + impulse / BODY_MASS,
                    omega + (impulse * r_perp).sum(dim=1) / BODY_INERTIA)

        acc_n = [torch.zeros_like(omega) for _ in range(N_LEG)]
        acc_t = [torch.zeros_like(omega) for _ in range(N_LEG)]
        for _ in range(SOLVER_SWEEPS):
            for i in range(N_LEG):
                n_i, t_i, rp_i = n_pts[:, i], t_pts[:, i], r_perp[:, i]
                touch_i = touching[:, i]
                u = vel + omega[:, None] * rp_i
                vn = (u * n_i).sum(dim=1)
                d_n = torch.where(touch_i, vn / neg_k_n[:, i], 0.0)
                new_n = torch.clamp_min(acc_n[i] + d_n, 0.0)
                d_n = new_n - acc_n[i]
                acc_n[i] = new_n
                vel, omega = push(vel, omega, d_n, n_i, rp_i)
                u = vel + omega[:, None] * rp_i
                vt = (u * t_i).sum(dim=1)
                d_t = torch.where(touch_i, vt / neg_k_t[:, i], 0.0)
                hi = CONTACT_FRICTION * acc_n[i]
                new_t = torch.clamp(acc_t[i] + d_t, -hi, hi)
                d_t = new_t - acc_t[i]
                acc_t[i] = new_t
                vel, omega = push(vel, omega, d_t, t_i, rp_i)

    pos = pos + DT * vel
    angle = angle + DT * omega

    if contacts:
        s2, co2 = torch.sin(angle), torch.cos(angle)
        wx2, wy2 = _body_points(pos, co2, s2, c.leg_x, c.leg_y)
        pen2 = _height(*_segment_lookup(state.terrain, wx2)) - wy2
        deep = torch.argmax(pen2, dim=1, keepdim=True)
        pen_deep = torch.gather(pen2, 1, deep)[:, 0]
        x_deep = torch.gather(wx2, 1, deep)
        corr = BAUMGARTE * torch.clamp_min(pen_deep - LINEAR_SLOP, 0.0)
        t0d, t1d, _ = _segment_lookup(state.terrain, x_deep)
        ndx, ndy = _normal(t0d, t1d)
        pos = pos + torch.clamp(corr, 0.0, MAX_CORRECTION)[:, None] * torch.cat([ndx, ndy], dim=1)
        wx3, wy3 = _body_points(pos, co2, s2, c.pts_x, c.pts_y)
        gap = _height(*_segment_lookup(state.terrain, wx3)) - wy3
        leg_touch = gap[:, :N_LEG] > -LINEAR_SLOP
        leg_contact = torch.stack([leg_touch[:, 0] | leg_touch[:, 1],
                                   leg_touch[:, 2] | leg_touch[:, 3]], dim=1)
        body_hit = (gap[:, N_LEG:] > 0.0).any(dim=1)
    else:
        leg_contact = torch.zeros_like(state.leg_contact)

    speed = torch.sqrt((vel * vel).sum(dim=1))
    quiet = (speed < SLEEP_LIN_TOL) & (torch.abs(omega) < SLEEP_ANG_TOL)
    sleep_time = torch.where(quiet, state.sleep_time + DT, 0.0)
    t = state.t + 1
    obs = _obs(c, pos, vel, angle, omega, leg_contact)
    shaping = _shaping(obs)
    new_state = State(pos, vel, angle, omega, state.terrain, shaping, sleep_time,
                      state.wind_idx, state.torque_idx, leg_contact, t)
    if not contacts:
        return new_state, obs, None, None, None
    asleep = sleep_time >= TIME_TO_SLEEP
    reward = shaping - state.prev_shaping - m_power * MAIN_FUEL - s_power * SIDE_FUEL
    crashed = body_hit | (torch.abs(obs[:, 0]) >= 1.0)
    terminated = crashed | asleep
    reward = torch.where(crashed, -100.0, torch.where(asleep, 100.0, reward))
    truncated = (t >= MAX_STEPS) & ~terminated
    return new_state, obs, reward, terminated, truncated


def reset(c: Consts, draws) -> tuple[State, torch.Tensor]:
    height, force, wind_idx, torque_idx = draws
    dev = height.device
    num = height.shape[0]
    height = torch.where(c.pad, HELIPAD_Y, height)
    prev = torch.roll(height, 1, dims=1)[:, :CHUNKS]
    smooth = TERRAIN_SMOOTH * (prev + height[:, :CHUNKS] + height[:, 1:])
    zeros = torch.zeros(num, device=dev)
    zeros_i = torch.zeros(num, dtype=torch.int32, device=dev)
    state = State(c.spawn.expand(num, 2), force * (DT / BODY_MASS), zeros, zeros, smooth,
                  zeros, zeros, wind_idx, torque_idx,
                  torch.zeros((num, 2), dtype=torch.bool, device=dev), zeros_i)
    new_state, obs, *_ = physics_step(c, state, None, None)
    return new_state._replace(t=zeros_i), obs


def _select(done, a, b):
    if isinstance(a, torch.Tensor):
        p = done.reshape(done.shape + (1,) * (a.dim() - done.dim()))
        return torch.where(p, a, b)
    return type(a)(*(_select(done, x, y) for x, y in zip(a, b)))


class VecLander:
    """``num`` landers with same-step autoreset; ``step`` returns the new
    carry and ``(reward, next_obs, terminated, done, final_return,
    final_length)``. ``obs_dim`` and ``n_actions`` are the sizes the PPO
    reference builds its net to."""

    obs_dim = OBS_DIM
    n_actions = N_ACTIONS

    def __init__(self, num: int, draws: Draws):
        self.num, self.draws = num, draws
        self.c = consts(draws.device)

    def reset_draws(self):
        d, n = self.draws, self.num
        return (d.uniform((n, CHUNKS + 1), 0.0, H / 2.0),
                d.uniform((n, 2), -INITIAL_RANDOM, INITIAL_RANDOM),
                d.randint(-9999, 9999, (n,)),
                d.randint(-9999, 9999, (n,)))

    def step_draws(self) -> torch.Tensor:
        return self.draws.uniform((self.num, 2), -1.0, 1.0)

    def reset(self):
        state, obs = reset(self.c, self.reset_draws())
        dev = obs.device
        return (state, obs, torch.zeros(self.num, device=dev),
                torch.zeros(self.num, dtype=torch.int32, device=dev))

    def step(self, carry, action):
        state, obs, ep_return, ep_length = carry
        disp = self.step_draws()
        st, next_obs, reward, terminated, truncated = physics_step(self.c, state, action, disp)
        done = terminated | truncated
        ep_return = ep_return + reward
        ep_length = ep_length + 1
        reset_state, reset_obs = reset(self.c, self.reset_draws())
        carry = (_select(done, reset_state, st), _select(done, reset_obs, next_obs),
                 torch.where(done, 0.0, ep_return), torch.where(done, 0, ep_length))
        out = (reward, next_obs, terminated, done, torch.where(done, ep_return, 0.0),
               torch.where(done, ep_length, 0))
        return carry, out
