"""Batched PyTorch LunarLander (counterpart of ``gymrl_tpu/envs/lunarlander.py``).

The same rigid-body model as the JAX engine, written over an explicit batch
axis instead of a ``vmap``-ed per-env function. Every constant, the order of
the physics (wind → engine impulses with dispersion → gravity → 10-sweep ×
4-point accumulated-impulse contact solve → integration → Baumgarte
correction along the deepest leg → contact flags → sleep → shaping and
terminal rewards) and the order of each floating-point operation follow the
reference, so the two agree to float32 rounding; the engine's docstring
there explains the model and its one deliberate approximation.

Random draws are arguments, not side effects:
  * ``reset_from(params, ResetDraws)`` takes the terrain heights, the
    initial force and the wind/torque indices;
  * ``step_from(params, state, action, disp)`` takes the U(-1, 1) engine
    dispersion ``disp[B, 2]``.
``reset_draws`` / ``step_draws`` make those draws from a ``Noise``.

On a CUDA device ``reset_from`` and ``step_from`` launch the hand-written
kernels of ``gymrl_tpu_torch/kernels/lunarlander.cu`` (one thread per env);
elsewhere they run the plain PyTorch path, ``reset_from_plain`` /
``step_from_plain``, which the kernels match op for op and which the tests
hold to the JAX engine.

``continuous=True`` gives the Box(2) variant: actions ``[B, 2]`` in ±1, main
throttle in [0.5, 1] when ``a[0] > 0``, side throttle in [0.5, 1] only when
``|a[1]| > 0.5``, fired on the side of ``sign(a[1])``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit

# -- Scalar constants (gymnasium lunar_lander.py values) ----------------------
FPS = 50.0
DT = 1.0 / FPS
SCALE = 30.0
MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6
INITIAL_RANDOM = 1000.0
SIDE_ENGINE_HEIGHT = 14.0
SIDE_ENGINE_AWAY = 12.0
MAIN_ENGINE_Y_LOCATION = 4.0
VIEWPORT_W, VIEWPORT_H = 600.0, 400.0
W = VIEWPORT_W / SCALE  # 20.0
H = VIEWPORT_H / SCALE  # 13.3333
CHUNKS = 11
HELIPAD_Y = H / 4.0
LEG_DOWN = 18.0 / SCALE

# -- Rigid-body constants (Box2D's mass computation; see the JAX engine) -------
BODY_MASS = 4.9588888  # lander fixture + 2 legs
COM_Y = 0.09840133  # combined COM in the lander frame is (0, COM_Y)
BODY_INERTIA = 0.90152451  # about combined COM
WIND_INERTIA = 0.92
WIND_TORQUE_LEVER = 0.011

# Lander hull vertices in lander frame (crash contact points).
HULL_PTS = np.array(
    [(-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17)], np.float32
) / SCALE


def _leg_corners() -> np.ndarray:
    """Leg bottom corners in the lander frame with the joints pinned at their
    ±0.4 rad stops (the reference's geometry, computed the same way)."""
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


LEG_PTS = _leg_corners()  # [4, 2]; rows 0-1 = +x leg, 2-3 = -x leg
N_LEG = LEG_PTS.shape[0]

CONTACT_FRICTION = float(np.sqrt(0.1 * 0.2))  # Box2D mixes √(ground·leg)
SOLVER_SWEEPS = 10
BAUMGARTE = 0.2
LINEAR_SLOP = 0.005
SLEEP_LIN_TOL = 0.01  # m/s (b2_linearSleepTolerance)
SLEEP_ANG_TOL = 2.0 / 180.0 * np.pi  # rad/s (b2_angularSleepTolerance)
TIME_TO_SLEEP = 0.5  # s
MAX_CORRECTION = 0.2  # largest Baumgarte push per step
WIND_FREQ = 0.02  # wind and turbulence: tanh(sin(WIND_FREQ·i) + sin(WIND_FREQ_PI·i))
WIND_FREQ_PI = math.pi * 0.01
TERRAIN_SMOOTH = 0.33  # the reference's 3-tap terrain smoothing weight
MAIN_FUEL = 0.30  # reward cost per step of each engine at full power
SIDE_FUEL = 0.03

_DX = W / (CHUNKS - 1)
_X_MAX = CHUNKS - 1 - 1e-6  # the terrain lookup's clamp, in chunk units
# Helipad chunk indices flattened at reset (CHUNKS // 2 ± 2, inclusive).
_PAD = (np.arange(CHUNKS + 1) >= CHUNKS // 2 - 2) & (np.arange(CHUNKS + 1) <= CHUNKS // 2 + 2)


class LunarLanderParams(NamedTuple):
    gravity: float = -10.0
    enable_wind: bool = False
    wind_power: float = 15.0
    turbulence_power: float = 1.5
    dispersion_scale: float = 1.0  # 1.0; tests zero it for determinism


class LunarLanderState(NamedTuple):
    pos: torch.Tensor  # f32[B, 2] — lander body origin (not COM), world frame
    vel: torch.Tensor  # f32[B, 2]
    angle: torch.Tensor  # f32[B]
    omega: torch.Tensor  # f32[B]
    terrain: torch.Tensor  # f32[B, CHUNKS] — smoothed chunk heights
    prev_shaping: torch.Tensor  # f32[B]
    sleep_time: torch.Tensor  # f32[B] — seconds below sleep tolerance
    wind_idx: torch.Tensor  # i32[B]
    torque_idx: torch.Tensor  # i32[B]
    leg_contact: torch.Tensor  # bool[B, 2] — (+x leg, -x leg)
    t: torch.Tensor  # i32[B]


class ResetDraws(NamedTuple):
    """The uniforms one batched reset consumes (the reference's per-env
    ``split(key, 5)`` draws, in their final ranges)."""

    height_u: torch.Tensor  # f32[B, CHUNKS + 1] — terrain heights, U(0, H/2)
    force: torch.Tensor  # f32[B, 2] — initial force, U(-INITIAL_RANDOM, INITIAL_RANDOM)
    wind_idx: torch.Tensor  # i32[B] — randint(-9999, 9999)
    torque_idx: torch.Tensor  # i32[B] — randint(-9999, 9999)


class _Consts(NamedTuple):
    """Small constant tensors, made once per device (no host copy per step)."""

    leg_x: torch.Tensor  # f32[4]
    leg_y: torch.Tensor
    pts_x: torch.Tensor  # f32[10] — leg corners then hull vertices
    pts_y: torch.Tensor
    pad: torch.Tensor  # bool[CHUNKS + 1]
    spawn: torch.Tensor  # f32[2] — (W/2, H)
    obs_pos_off: torch.Tensor  # f32[2]
    obs_pos_scale: torch.Tensor  # f32[2]
    obs_vel_scale: torch.Tensor  # f32[2]


def _make_consts(device: torch.device) -> _Consts:
    pts = np.concatenate([LEG_PTS, HULL_PTS], axis=0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return _Consts(
        leg_x=t(LEG_PTS[:, 0]), leg_y=t(LEG_PTS[:, 1]),
        pts_x=t(pts[:, 0]), pts_y=t(pts[:, 1]),
        pad=t(_PAD, torch.bool),
        spawn=t([W / 2.0, H]),
        obs_pos_off=t([W / 2.0, HELIPAD_Y + LEG_DOWN]),
        obs_pos_scale=t([W / 2.0, H / 2.0]),
        obs_vel_scale=t([W / 2.0, H / 2.0]),
    )


def _on_card(x: torch.Tensor) -> bool:
    """Whether a lander batch runs on the kernels (a CUDA tensor) or on the
    plain path."""
    return x.is_cuda


def _body_points(pos, c, s, lx, ly):
    """World coordinates ``[B, P]`` of body-frame points (lx, ly)[P]:
    ``pos + R(angle) @ p``, as the reference's ``pos + p @ R.T``."""
    c, s = c[:, None], s[:, None]
    wx = pos[:, 0:1] + (lx * c - ly * s)
    wy = pos[:, 1:2] + (lx * s + ly * c)
    return wx, wy


def _segment_lookup(terrain: torch.Tensor, x: torch.Tensor):
    """(t0, t1, frac) of the terrain segment under world x[B, P].

    ``torch.gather`` in place of the reference's one-hot contraction, which
    its docstring states is bit-identical to plain indexing.
    """
    xi = torch.clamp(x / _DX, 0.0, _X_MAX)
    i0 = torch.floor(xi)
    frac = xi - i0
    idx = i0.long()
    t0 = torch.gather(terrain, 1, idx)
    t1 = torch.gather(terrain, 1, idx + 1)  # i0 ≤ CHUNKS-2: no wraparound
    return t0, t1, frac


def _height(t0, t1, frac):
    return t0 * (1.0 - frac) + t1 * frac


def _normal(t0, t1):
    """Unit normal (nx, ny) of the segments with end heights t0, t1."""
    slope = (t1 - t0) / _DX
    norm = torch.sqrt(slope * slope + 1.0)
    return (-slope) / norm, torch.reciprocal(norm)


class LunarLander(Env):
    """Discrete 4-action lander; ``continuous=True`` gives the Box(2) variant."""

    name = "LunarLander-v3"
    obs_shape = (8,)
    max_steps = 1000

    def __init__(self, continuous: bool = False, enable_wind: bool = False,
                 gravity: float = -10.0, wind_power: float = 15.0,
                 turbulence_power: float = 1.5):
        self.continuous = bool(continuous)
        if self.continuous:
            self.n_actions = None
            self.act_dim = 2
            self.action_bound = 1.0
        else:
            self.n_actions = 4
        self._init_params = LunarLanderParams(
            gravity=float(gravity),
            enable_wind=bool(enable_wind),
            wind_power=float(wind_power),
            turbulence_power=float(turbulence_power),
            dispersion_scale=1.0,
        )
        self._consts: dict[torch.device, _Consts] = {}

    def default_params(self) -> LunarLanderParams:
        return self._init_params

    def _c(self, device: torch.device) -> _Consts:
        if device not in self._consts:
            self._consts[device] = _make_consts(device)
        return self._consts[device]

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int) -> ResetDraws:
        return ResetDraws(
            height_u=noise.uniform((num, CHUNKS + 1), 0.0, H / 2.0),
            force=noise.uniform((num, 2), -INITIAL_RANDOM, INITIAL_RANDOM),
            wind_idx=noise.randint(-9999, 9999, (num,)),
            torque_idx=noise.randint(-9999, 9999, (num,)),
        )

    def step_draws(self, noise, num: int) -> torch.Tensor:
        return noise.uniform((num, 2), -1.0, 1.0)

    # -- observation / shaping -------------------------------------------------
    def _obs(self, c: _Consts, pos, vel, angle, omega, leg_contact) -> torch.Tensor:
        return torch.cat(
            [
                (pos - c.obs_pos_off) / c.obs_pos_scale,
                vel * c.obs_vel_scale / FPS,
                angle[:, None],
                (20.0 * omega / FPS)[:, None],
                leg_contact.float(),
            ],
            dim=1,
        )

    @staticmethod
    def _shaping(obs: torch.Tensor) -> torch.Tensor:
        o = obs.unbind(1)
        return (
            -100.0 * torch.sqrt(o[0] * o[0] + o[1] * o[1])
            - 100.0 * torch.sqrt(o[2] * o[2] + o[3] * o[3])
            - 100.0 * torch.abs(o[4])
            + 10.0 * o[6]
            + 10.0 * o[7]
        )

    # -- reset -----------------------------------------------------------------
    def reset_from(self, params: LunarLanderParams, draws: ResetDraws):
        """Pure batched reset: the ``lander_reset`` kernel on a CUDA device,
        ``reset_from_plain`` elsewhere."""
        if _on_card(draws.height_u):
            from gymrl_tpu_torch.kernels.lunarlander import lander_reset
            return lander_reset(params, draws)
        return self.reset_from_plain(params, draws)

    def reset_from_plain(self, params: LunarLanderParams, draws: ResetDraws):
        """The plain batched reset: terrain smoothing with the ``height[-1]``
        wraparound quirk, the initial-force body, and the reset step."""
        height = draws.height_u
        dev = height.device
        c = self._c(dev)
        num = height.shape[0]
        height = torch.where(c.pad, HELIPAD_Y, height)
        prev = torch.roll(height, 1, dims=1)[:, :CHUNKS]  # i=0 → height[-1]
        smooth = TERRAIN_SMOOTH * (prev + height[:, :CHUNKS] + height[:, 1:])

        zeros = torch.zeros(num, device=dev)
        zeros_i = torch.zeros(num, dtype=torch.int32, device=dev)
        state = LunarLanderState(
            pos=c.spawn.expand(num, 2),
            vel=draws.force * (DT / BODY_MASS),  # v += dt·F/m happens in the reset step
            angle=zeros,
            omega=zeros,
            terrain=smooth,
            prev_shaping=zeros,
            sleep_time=zeros,
            wind_idx=draws.wind_idx,
            torque_idx=draws.torque_idx,
            leg_contact=torch.zeros((num, 2), dtype=torch.bool, device=dev),
            t=zeros_i,
        )
        # The reset step (gymnasium's reset ends with step(0)) needs no
        # contact solve: the lander spawns above any terrain. Its no-op
        # action makes both engine impulses exactly zero, so they are skipped.
        result = self._physics_step(params, state, None, None)
        return result.state._replace(t=zeros_i), result.obs

    # -- step ------------------------------------------------------------------
    def step_from(self, params: LunarLanderParams, state: LunarLanderState,
                  action: torch.Tensor, disp: torch.Tensor) -> StepResult:
        """Pure batched step; ``disp[B, 2]`` is the U(-1, 1) dispersion draw.
        The ``lander_step`` kernel on a CUDA device, ``step_from_plain``
        elsewhere."""
        if _on_card(state.angle):
            from gymrl_tpu_torch.kernels.lunarlander import lander_step
            return lander_step(params, state, action, disp, continuous=self.continuous,
                               max_steps=self.max_steps)
        return self.step_from_plain(params, state, action, disp)

    def step_from_plain(self, params: LunarLanderParams, state: LunarLanderState,
                        action: torch.Tensor, disp: torch.Tensor) -> StepResult:
        """The plain batched step, eager PyTorch on any device."""
        return self._physics_step(params, state, action, disp)

    def _physics_step(self, params: LunarLanderParams, state: LunarLanderState,
                      action, disp) -> StepResult:
        """One physics step; ``action=None`` is the reset step, which has no
        engines, no contacts and no reward."""
        c = self._c(state.angle.device)
        contacts = action is not None
        pos, vel, angle, omega = state.pos, state.vel, state.angle, state.omega
        wind_idx, torque_idx = state.wind_idx, state.torque_idx

        # Wind + turbulence (applied as forces; only when no leg touches).
        # With wind off the reference adds exact zeros, which is skipped here.
        if params.enable_wind:
            airborne = ~state.leg_contact.any(dim=1)
            wi = wind_idx.float()
            ti = torque_idx.float()
            wind_mag = torch.tanh(
                torch.sin(WIND_FREQ * wi) + torch.sin(WIND_FREQ_PI * wi)
            ) * params.wind_power
            torque_mag = torch.tanh(
                torch.sin(WIND_FREQ * ti) + torch.sin(WIND_FREQ_PI * ti)
            ) * params.turbulence_power
            dvx = torch.where(airborne, DT * wind_mag / BODY_MASS, 0.0)
            vel = torch.stack([vel[:, 0] + dvx, vel[:, 1]], dim=1)
            wind_torque = torque_mag - WIND_TORQUE_LEVER * torch.cos(angle) * wind_mag
            omega = omega + torch.where(airborne, DT * wind_torque / WIND_INERTIA, 0.0)
            step = airborne.to(torch.int32)
            wind_idx = wind_idx + step
            torque_idx = torque_idx + step

        s, co = torch.sin(angle), torch.cos(angle)  # tip = (s, co); side = (-co, s)
        com = torch.stack([pos[:, 0] - s * COM_Y, pos[:, 1] + co * COM_Y], dim=1)

        if contacts:
            if self.continuous:
                a = torch.clamp(action.float(), -1.0, 1.0)
                main, side = a[:, 0], a[:, 1]
                m_power = torch.where(main > 0.0, (torch.clamp(main, 0.0, 1.0) + 1.0) * 0.5, 0.0)
                direction = torch.sign(side)
                s_power = torch.where(torch.abs(side) > 0.5,
                                      torch.clamp(torch.abs(side), 0.5, 1.0), 0.0)
            else:
                a = action.to(torch.int32)
                m_power = (a == 2).float()
                side_on = (a == 1) | (a == 3)
                direction = torch.where(side_on, a.float() - 2.0, 0.0)
                s_power = side_on.float()
            d = disp / SCALE * params.dispersion_scale
            d0, d1 = d[:, 0], d[:, 1]

            def apply_impulse(vel, omega, impulse, point):
                vel = vel + impulse / BODY_MASS
                r = point - com
                omega = omega + (r[:, 0] * impulse[:, 1] - r[:, 1] * impulse[:, 0]) / BODY_INERTIA
                return vel, omega

            # Main engine (gymnasium's exact offset geometry incl. noise terms).
            x_m = MAIN_ENGINE_Y_LOCATION / SCALE + 2.0 * d0
            o_m = torch.stack([s * x_m - co * d1, -(co * x_m) - s * d1], dim=1)
            vel, omega = apply_impulse(
                vel, omega, -o_m * MAIN_ENGINE_POWER * m_power[:, None], pos + o_m
            )

            # Side engines — the 17-vs-14 height asymmetry quirk preserved.
            y_s = 3.0 * d1 + direction * SIDE_ENGINE_AWAY / SCALE
            ox_s = s * d0 - co * y_s
            oy_s = -(co * d0) - s * y_s
            o_s = torch.stack([ox_s, oy_s], dim=1)
            impulse_pos_s = torch.stack(
                [pos[:, 0] + ox_s - s * 17.0 / SCALE,
                 pos[:, 1] + oy_s + co * SIDE_ENGINE_HEIGHT / SCALE],
                dim=1,
            )
            vel, omega = apply_impulse(
                vel, omega, -o_s * SIDE_ENGINE_POWER * s_power[:, None], impulse_pos_s
            )

        # Gravity (Box2D: v += dt·g before the contact velocity solve). The
        # product dt·g is rounded in float32, as the reference computes it.
        dt_g = float(np.float32(DT) * np.float32(params.gravity))
        vel = torch.stack([vel[:, 0], vel[:, 1] + dt_g], dim=1)

        if contacts:
            # Contact velocity solve: sequential impulses over the 4 leg
            # corner points with accumulated-impulse clamping (Box2D's
            # scheme); hull contact is a crash and needs no impulse.
            wx, wy = _body_points(pos, co, s, c.leg_x, c.leg_y)  # [B, 4]
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
            n_pts = torch.stack([nx, ny], dim=2)  # [B, 4, 2]
            t_pts = torch.stack([tx, ty], dim=2)
            # u = vel + ω × r = vel + ω·(-r_y, r_x); the same vector gives the
            # torque of an impulse j: r × j = j · (-r_y, r_x).
            r_perp = torch.stack([-ry, rx], dim=2)

            def push(vel, omega, d, direction, r_perp):
                """Apply the accumulated-impulse increment d along direction."""
                impulse = d[:, None] * direction
                vel = vel + impulse / BODY_MASS
                omega = omega + (impulse * r_perp).sum(dim=1) / BODY_INERTIA
                return vel, omega

            acc_n = [torch.zeros_like(omega) for _ in range(N_LEG)]
            acc_t = [torch.zeros_like(omega) for _ in range(N_LEG)]
            for _ in range(SOLVER_SWEEPS):  # Gauss-Seidel sweeps × 4 points
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

        # Integrate positions (semi-implicit Euler, Box2D order).
        pos = pos + DT * vel
        angle = angle + DT * omega

        if contacts:
            # Positional correction: push the body out along the normal under
            # the deepest leg corner (argmax takes the first maximum, as in
            # the reference).
            s2, co2 = torch.sin(angle), torch.cos(angle)
            wx2, wy2 = _body_points(pos, co2, s2, c.leg_x, c.leg_y)
            pen2 = _height(*_segment_lookup(state.terrain, wx2)) - wy2
            deep = torch.argmax(pen2, dim=1, keepdim=True)
            pen_deep = torch.gather(pen2, 1, deep)[:, 0]
            x_deep = torch.gather(wx2, 1, deep)
            corr = BAUMGARTE * torch.clamp_min(pen_deep - LINEAR_SLOP, 0.0)
            t0d, t1d, _ = _segment_lookup(state.terrain, x_deep)
            ndx, ndy = _normal(t0d, t1d)
            n_deep = torch.cat([ndx, ndy], dim=1)  # [B, 2]
            pos = pos + torch.clamp(corr, 0.0, MAX_CORRECTION)[:, None] * n_deep

            # Contact flags after integration (obs + next-step wind gating):
            # leg corners and hull vertices in one terrain lookup.
            wx3, wy3 = _body_points(pos, co2, s2, c.pts_x, c.pts_y)
            gap = _height(*_segment_lookup(state.terrain, wx3)) - wy3
            leg_touch = gap[:, :N_LEG] > -LINEAR_SLOP
            # obs order: legs[0] is the i=-1 leg (at +x), legs[1] the i=+1 leg.
            leg_contact = torch.stack(
                [leg_touch[:, 0] | leg_touch[:, 1], leg_touch[:, 2] | leg_touch[:, 3]],
                dim=1,
            )
            body_hit = (gap[:, N_LEG:] > 0.0).any(dim=1)
        else:
            leg_contact = torch.zeros_like(state.leg_contact)

        # Sleep bookkeeping (+100 landing detection).
        speed = torch.sqrt((vel * vel).sum(dim=1))
        quiet = (speed < SLEEP_LIN_TOL) & (torch.abs(omega) < SLEEP_ANG_TOL)
        sleep_time = torch.where(quiet, state.sleep_time + DT, 0.0)

        t = state.t + 1
        obs = self._obs(c, pos, vel, angle, omega, leg_contact)
        shaping = self._shaping(obs)
        new_state = LunarLanderState(
            pos=pos, vel=vel, angle=angle, omega=omega,
            terrain=state.terrain, prev_shaping=shaping,
            sleep_time=sleep_time, wind_idx=wind_idx, torque_idx=torque_idx,
            leg_contact=leg_contact, t=t,
        )
        if not contacts:  # reset step: reward and flags are discarded
            return StepResult(new_state, obs, None, None, None)

        asleep = sleep_time >= TIME_TO_SLEEP
        reward = shaping - state.prev_shaping - m_power * MAIN_FUEL - s_power * SIDE_FUEL
        crashed = body_hit | (torch.abs(obs[:, 0]) >= 1.0)
        terminated = crashed | asleep
        reward = torch.where(crashed, -100.0, torch.where(asleep, 100.0, reward))
        truncated = time_limit(t, self.max_steps, terminated)
        return StepResult(new_state, obs, reward, terminated, truncated)
