"""Batched PyTorch FlappyBird (counterpart of ``gymrl_tpu/envs/flappybird.py``).

The JAX package's re-creation of flappy-bird-gymnasium's "FlappyBird-v0"
numeric mode (``use_lidar=False``, 12 features), constant for constant and
operation for operation: screen 288x512, ground at y=400, pipes 52 wide
with a 100 px gap moving -4 px/frame, three pipe pairs spaced 0.5·W + 52
apart with gap centres uniform in [0.2·H, 400 − 0.2·H); the bird at x=57.6,
34x24, flap sets the velocity to -9, gravity +1 per frame capped at +10;
+0.1 per frame alive, +1 per pipe passed, -0.5 for touching the top, -1 on
death (pipe or ground); 10,000-step time limit.

Observation: for the last / next / next-next pipe (pipes ordered by x; the
"last" is the most recent one behind the bird, or the nearest if none is)
``(x/W, top-pipe bottom/H, bottom-pipe top/H)``, then ``y/H``,
``vel/10``, ``rotation/90``.

Random draws are arguments, as in every engine of the port: ``reset_from``
takes the ``[B, 3]`` gap centres of the fresh pipes, ``step_from`` the
``[B, 3]`` gap centres a pipe takes if it respawns this step. The JAX state
keeps a PRNG key per env for its respawn draws; this state keeps none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymrl_tpu_torch.envs.base import Env, StepResult, time_limit

SCREEN_W, SCREEN_H = 288.0, 512.0
GROUND_Y = 400.0  # base line (screen_height * 0.79)
PIPE_W = 52.0
PIPE_GAP = 100.0
PIPE_VEL_X = -4.0
PIPE_SPACING = 0.5 * SCREEN_W + PIPE_W  # horizontal distance between pipe pairs
PLAYER_X = 0.2 * SCREEN_W
PLAYER_W, PLAYER_H = 34.0, 24.0
FLAP_VEL = -9.0
GRAVITY = 1.0
MAX_VEL_Y = 10.0
N_PIPES = 3


class FlappyBirdParams(NamedTuple):
    gap_low: float = 0.2 * SCREEN_H  # lowest gap-centre y
    gap_high: float = GROUND_Y - 0.2 * SCREEN_H  # highest gap-centre y


class FlappyBirdState(NamedTuple):
    player_y: torch.Tensor  # f32[B]
    player_vel: torch.Tensor  # f32[B]
    rotation: torch.Tensor  # f32[B] — degrees, a visual-only feature
    pipe_x: torch.Tensor  # f32[B, 3]
    gap_y: torch.Tensor  # f32[B, 3] — gap-centre y per pipe
    score: torch.Tensor  # i32[B] — pipes passed
    t: torch.Tensor  # i32[B]


class FlappyBird(Env):
    name = "FlappyBird-v0"
    n_actions = 2  # 0 = idle, 1 = flap
    obs_shape = (12,)
    max_steps = 10_000

    def default_params(self) -> FlappyBirdParams:
        return FlappyBirdParams()

    @staticmethod
    def _obs(state: FlappyBirdState) -> torch.Tensor:
        order = torch.argsort(state.pipe_x, dim=1, stable=True)
        xs = torch.gather(state.pipe_x, 1, order)
        gaps = torch.gather(state.gap_y, 1, order)
        behind = xs + PIPE_W < PLAYER_X
        n_behind = behind.sum(dim=1)
        last = torch.where(n_behind > 0, n_behind - 1, 0)
        idx = torch.stack([last, torch.clamp(last + 1, max=N_PIPES - 1),
                           torch.clamp(last + 2, max=N_PIPES - 1)], dim=1)
        x_i = torch.gather(xs, 1, idx)
        gap_i = torch.gather(gaps, 1, idx)
        top_y = gap_i - PIPE_GAP / 2.0  # bottom edge of the top pipe
        bot_y = gap_i + PIPE_GAP / 2.0  # top edge of the bottom pipe
        pipes = torch.stack([x_i / SCREEN_W, top_y / SCREEN_H, bot_y / SCREEN_H], dim=2)
        player = torch.stack([state.player_y / SCREEN_H, state.player_vel / MAX_VEL_Y,
                              state.rotation / 90.0], dim=1)
        return torch.cat([pipes.reshape(-1, 3 * N_PIPES), player], dim=1)

    # -- draws ---------------------------------------------------------------
    def reset_draws(self, noise, num: int) -> torch.Tensor:
        p = self.default_params()
        return noise.uniform((num, N_PIPES), p.gap_low, p.gap_high)

    def step_draws(self, noise, num: int) -> torch.Tensor:
        p = self.default_params()
        return noise.uniform((num, N_PIPES), p.gap_low, p.gap_high)

    # -- pure functions ------------------------------------------------------
    def reset_from(self, params: FlappyBirdParams, gaps: torch.Tensor):
        """``gaps[B, 3]``: the gap centres of the three fresh pipes."""
        num, dev = gaps.shape[0], gaps.device
        state = FlappyBirdState(
            player_y=torch.full((num,), (SCREEN_H - PLAYER_H) / 2.0, device=dev),
            player_vel=torch.zeros(num, device=dev),
            rotation=torch.zeros(num, device=dev),
            pipe_x=(SCREEN_W + torch.arange(N_PIPES, dtype=torch.float32, device=dev)
                    * PIPE_SPACING).expand(num, N_PIPES).clone(),
            gap_y=gaps,
            score=torch.zeros(num, dtype=torch.int32, device=dev),
            t=torch.zeros(num, dtype=torch.int32, device=dev),
        )
        return state, self._obs(state)

    def step_from(self, params: FlappyBirdParams, state: FlappyBirdState,
                  action: torch.Tensor, new_gaps: torch.Tensor) -> StepResult:
        """``new_gaps[B, 3]``: the gap centres of pipes that respawn this step."""
        flap = action == 1
        # flap sets the impulse directly; gravity caps at the terminal fall speed
        vel = torch.where(flap, FLAP_VEL, torch.clamp(state.player_vel + GRAVITY, max=MAX_VEL_Y))
        y = state.player_y + vel
        hit_top = y < 0.0
        y = torch.clamp(y, min=0.0)
        # flap snaps up to 45°, otherwise rotates down 3°/frame to -90°
        rotation = torch.where(flap, 45.0, torch.clamp(state.rotation - 3.0, min=-90.0))

        pipe_x = state.pipe_x + PIPE_VEL_X
        # score: a pipe's trailing edge crossed the bird's x this frame
        passed = (pipe_x + PIPE_W < PLAYER_X) & (state.pipe_x + PIPE_W >= PLAYER_X)
        n_passed = passed.sum(dim=1, dtype=torch.int32)

        # respawn pipes that scrolled off-screen at the back of the train
        off = pipe_x < -PIPE_W
        rightmost = pipe_x.amax(dim=1, keepdim=True)
        pipe_x = torch.where(off, rightmost + PIPE_SPACING, pipe_x)
        gap_y = torch.where(off, new_gaps, state.gap_y)

        # collision: the bird's AABB against the pipe pairs', or the ground
        px0, px1 = PLAYER_X, PLAYER_X + PLAYER_W
        py0, py1 = y[:, None], (y + PLAYER_H)[:, None]
        overlap_x = (pipe_x < px1) & (pipe_x + PIPE_W > px0)
        top_edge = gap_y - PIPE_GAP / 2.0
        bot_edge = gap_y + PIPE_GAP / 2.0
        hit_pipe = (overlap_x & ((py0 < top_edge) | (py1 > bot_edge))).any(dim=1)
        hit_ground = y + PLAYER_H >= GROUND_Y
        died = hit_pipe | hit_ground

        reward = (0.1 + 1.0 * n_passed.float() - torch.where(hit_top, 0.5, 0.0)
                  - torch.where(died, 1.0, 0.0))
        t = state.t + 1
        new_state = FlappyBirdState(
            player_y=y, player_vel=vel, rotation=rotation, pipe_x=pipe_x, gap_y=gap_y,
            score=state.score + n_passed, t=t,
        )
        terminated = died
        truncated = time_limit(t, self.max_steps, terminated)
        return StepResult(new_state, self._obs(new_state), reward, terminated, truncated)
