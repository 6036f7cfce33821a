"""Pixel observations (counterpart of ``gymrl_tpu/envs/pixels.py``).

An engine's state is rasterized into a grayscale canvas on the device, and
``PixelWrapper`` applies the reference's Atari-style preprocessing to it:
float frames in [0, 1], ``frame_skip`` repeats of the action with the
rewards summed until the first done of the skip, and the last ``stack``
frames as the LAST axis, so observations are ``[B, H, W, stack]`` as in the
JAX package (the conv trunk takes them channels-last).

The rasterizers work on a batch: coordinates are ``[B]`` tensors (or
Python numbers shared by the batch), frames ``[B, H, W]``. Their coverage
is anti-aliased with a 1-px soft edge, so sub-pixel motion of the state
changes the frame continuously.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env, StepResult
from gymrl_tpu_torch.envs.cartpole import CartPole
from gymrl_tpu_torch.envs.rollout import tree_select


def _grid(h: int, w: int, coords, device):
    """Row and column indices ``[h, 1]`` / ``[1, w]`` on the coordinates'
    device (else ``device``), and each coordinate as ``[B, 1, 1]`` (a number
    stays a number)."""
    device = next((c.device for c in coords if isinstance(c, torch.Tensor)), device)
    rows = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return rows, cols, [c[:, None, None] if isinstance(c, torch.Tensor) else c for c in coords]


def rasterize_segment(h: int, w: int, x0, y0, x1, y1, thickness: float) -> torch.Tensor:
    """``[B, h, w]`` coverage of the pixels within ``thickness`` of the
    segment (x, y in pixel coordinates), falling linearly from 1 at
    ``thickness − 0.5`` to 0 at ``thickness + 0.5``."""
    rows, cols, (x0, y0, x1, y1) = _grid(h, w, (x0, y0, x1, y1), None)
    dx, dy = x1 - x0, y1 - y0
    len2 = dx * dx + dy * dy + 1e-8
    t = torch.clamp(((cols - x0) * dx + (rows - y0) * dy) / len2, 0.0, 1.0)
    px, py = x0 + t * dx, y0 + t * dy
    ex, ey = cols - px, rows - py
    dist = torch.sqrt(ex * ex + ey * ey)
    return torch.clamp(thickness + 0.5 - dist, 0.0, 1.0)


def rasterize_box(h: int, w: int, cx, cy, half_w, half_h, device=None) -> torch.Tensor:
    """``[B, h, w]`` anti-aliased coverage of an axis-aligned box centered at
    (cx, cy), a 1-px soft edge per axis; ``[h, w]`` on ``device`` when the
    center is given as numbers."""
    rows, cols, (cx, cy) = _grid(h, w, (cx, cy), device)
    cov_x = torch.clamp(half_w + 0.5 - torch.abs(cols - cx), 0.0, 1.0)
    cov_y = torch.clamp(half_h + 0.5 - torch.abs(rows - cy), 0.0, 1.0)
    return cov_x * cov_y


class PixelState(NamedTuple):
    inner: Any  # the wrapped engine's batched state
    frames: torch.Tensor  # f32[B, H, W, stack], newest last
    t: torch.Tensor  # i32[B]


class PixelWrapper(Env):
    """A state engine and a renderer as a pixel-observation Env.

    ``render(params, inner_state) -> [B, H, W]`` frames in [0, 1];
    subclasses set ``screen_hw`` and ``render``. A step's draws are a list
    of ``frame_skip`` draws of the inner engine's step. After the first done
    inside the skip the inner state stays frozen and no reward is added
    (the ``live`` mask). The wrapper's own limit is
    ``max(1, inner.max_steps // frame_skip)`` steps, OR-ed into the inner
    truncation, so it may be true together with ``terminated``.
    """

    stack: int = 4
    frame_skip: int = 1
    screen_hw: tuple[int, int] = (48, 48)

    def __init__(self, inner: Env):
        self.inner = inner
        self.n_actions = inner.n_actions
        self.act_dim = inner.act_dim
        self.action_bound = inner.action_bound
        self.max_steps = max(1, inner.max_steps // self.frame_skip)
        h, w = self.screen_hw
        self.obs_shape = (h, w, self.stack)
        self.name = f"{inner.name}-pixels"

    def default_params(self):
        return self.inner.default_params()

    def render(self, params, inner_state) -> torch.Tensor:
        raise NotImplementedError

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int):
        return self.inner.reset_draws(noise, num)

    def step_draws(self, noise, num: int) -> list:
        return [self.inner.step_draws(noise, num) for _ in range(self.frame_skip)]

    # -- pure functions ------------------------------------------------------
    def reset_from(self, params, draws):
        inner_state, _ = self.inner.reset_from(params, draws)
        frame = self.render(params, inner_state)
        frames = frame[..., None].repeat(1, 1, 1, self.stack)
        t = torch.zeros(frame.shape[0], dtype=torch.int32, device=frame.device)
        state = PixelState(inner=inner_state, frames=frames, t=t)
        return state, frames

    def step_from(self, params, state: PixelState, action: torch.Tensor, draws) -> StepResult:
        inner = state.inner
        reward = torch.zeros(state.t.shape, device=state.frames.device)
        terminated = torch.zeros(state.t.shape, dtype=torch.bool, device=state.frames.device)
        truncated = terminated
        for d in draws:
            res = self.inner.step_from(params, inner, action, d)
            live = ~(terminated | truncated)
            reward = reward + res.reward * live
            inner = tree_select(live, res.state, inner)
            terminated = terminated | (res.terminated & live)
            truncated = truncated | (res.truncated & live)
        frame = self.render(params, inner)
        frames = torch.cat([state.frames[..., 1:], frame[..., None]], dim=-1)
        t = state.t + 1
        truncated = truncated | (t >= self.max_steps)
        new_state = PixelState(inner=inner, frames=frames, t=t)
        return StepResult(new_state, frames, reward, terminated, truncated)


class CartPolePixels(PixelWrapper):
    """CartPole on a 48×48 grayscale canvas: the track line, the cart box and
    the pole segment. One frame shows the state but the velocities, which
    the 4-frame stack supplies. Registered as ``CartPolePixels-v0``; its
    ``name`` (``CartPole-v1-pixels``) names its checkpoints."""

    stack: int = 4
    frame_skip: int = 1
    screen_hw: tuple[int, int] = (48, 48)

    def __init__(self):
        super().__init__(CartPole())

    def render(self, params, s) -> torch.Tensor:
        h, w = self.screen_hw
        world_w = 2.0 * params.x_threshold  # the visible track span
        scale = w / world_w
        cart_cx = (s.x + params.x_threshold) * scale
        cart_cy = 0.75 * h
        pole_len_px = 2.0 * params.length * scale * 2.0  # gym draws 2 × the half length
        tip_x = cart_cx + pole_len_px * torch.sin(s.theta)
        tip_y = cart_cy - pole_len_px * torch.cos(s.theta)

        track = rasterize_box(h, w, w / 2.0, cart_cy + 4.0, w / 2.0, 0.5, s.x.device)
        cart = rasterize_box(h, w, cart_cx, cart_cy, 4.0, 2.5)
        pole = rasterize_segment(h, w, cart_cx, cart_cy, tip_x, tip_y, 1.2)
        return torch.clamp(0.3 * track + 0.6 * cart + 1.0 * pole, 0.0, 1.0)
