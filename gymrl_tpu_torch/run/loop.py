"""Host-side training loop (counterpart of ``gymrl_tpu/run/loop.py``).

The reference UX, unchanged:
  * per-iteration console lines ``Episode | Reward | Avg(100) | Steps``
    (reference algorithms/dqn_cartpole.py:199-205),
  * avg-100-episode solve-threshold early stop (dqn_cartpole.py:207),
  * periodic deterministic evaluation with frozen normalization
    (utils/runner.py:156-158, 169-184),
  * periodic checkpoints and a final save (utils/runner.py:160-161),
  * TensorBoard metrics with NaN skipping (utils/runner.py:46-49),
  * SIGINT → graceful final evaluation (dqn_cartpole.py:256-272): the loop
    catches KeyboardInterrupt and returns; callers then run ``test()``.

Per iteration the host fetches only the small episode-stat arrays; the
metrics dict is fetched at console-log points. ``test(render=True)`` also
renders one deterministic episode to ``./exp/renders/{algo}_{env}.gif``
(the reference's human-rendered test episode, headless).
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.envs.render import RENDERERS, render, save_gif, state_row
from gymrl_tpu_torch.utils.checkpoint import checkpoint_path, restore_checkpoint, save_checkpoint
from gymrl_tpu_torch.utils.logging import MetricsWriter, get_logger

logger = get_logger()


class TrainLoop:
    def __init__(
        self,
        trainer,
        algo_name: str,
        *,
        log_metrics: bool = True,
        log_every: int = 20,  # train_iter calls between console lines
        eval_every: int = 0,  # env steps between evals; 0 = off
        save_every: int = 0,  # env steps between checkpoint saves; 0 = off
        eval_episodes: int = 5,
    ):
        self.trainer = trainer
        self.algo_name = algo_name
        self.env_name = trainer.venv.env.name
        self.writer = MetricsWriter(algo_name, self.env_name, enabled=log_metrics)
        self.log_every = log_every
        self.eval_every = eval_every
        self.save_every = save_every
        self.eval_episodes = eval_episodes
        self.ckpt_path = checkpoint_path(algo_name, self.env_name)

    # -- training -------------------------------------------------------------
    def train(
        self,
        total_env_steps: int,
        *,
        solve_threshold: float | None = None,
        seed: int = 0,
        load_model: bool = False,
        ts=None,
    ):
        trainer = self.trainer
        if ts is None:
            ts = trainer.init(seed)
            if load_model:
                try:
                    ts = restore_checkpoint(self.ckpt_path, ts, trainer.mesh)
                    logger.info(f"restored checkpoint from {self.ckpt_path}")
                except FileNotFoundError:
                    logger.warning(f"no checkpoint at {self.ckpt_path}; training from scratch")

        window: deque = deque(maxlen=100)
        curve: list = []  # (env_steps, avg100) at each console-log point
        episodes = 0
        iters = 0
        next_eval = self.eval_every or float("inf")
        next_save = self.save_every or float("inf")
        t0 = time.time()
        steps0 = ts.env_steps
        solved = False

        env_steps = steps0
        try:
            while env_steps < total_env_steps and not solved:
                ts, out = trainer.train_iter(ts)
                iters += 1
                env_steps = ts.env_steps

                done = out.ep_done.cpu().numpy()
                if done.any():
                    finals = out.ep_return.cpu().numpy()[done]
                    episodes += int(done.sum())
                    window.extend(finals.tolist())
                if iters % self.log_every == 0:
                    avg = float(np.mean(window)) if window else float("nan")
                    curve.append((env_steps, round(avg, 1)))
                    last = window[-1] if window else float("nan")
                    sps = (env_steps - steps0) / max(time.time() - t0, 1e-9)
                    # one fetch for the whole metrics dict
                    values = torch.stack(list(out.metrics.values())).cpu().tolist()
                    metrics = dict(zip(out.metrics.keys(), values))
                    self.writer.log(
                        {"reward/avg100": avg, "steps_per_s": sps, **metrics}, env_steps
                    )
                    logger.info(
                        f"Episode: {episodes} | Reward: {last:.1f} | "
                        f"Avg(100): {avg:.1f} | Steps: {env_steps} | {sps:,.0f} steps/s"
                    )

                if env_steps >= next_eval:
                    next_eval += self.eval_every
                    mean_r, _ = self.evaluate(ts, episodes=self.eval_episodes)
                    self.writer.log({"reward/eval": mean_r}, env_steps)
                    logger.info(f"eval: {mean_r:.1f} over {self.eval_episodes} episodes")
                if env_steps >= next_save:
                    next_save += self.save_every
                    save_checkpoint(self.ckpt_path, ts, trainer.mesh)

                if (
                    solve_threshold is not None
                    and len(window) == window.maxlen
                    and float(np.mean(window)) >= solve_threshold
                ):
                    logger.info(
                        f"solved: avg100 {float(np.mean(window)):.1f} ≥ {solve_threshold} "
                        f"after {episodes} episodes / {env_steps} steps"
                    )
                    solved = True
        except KeyboardInterrupt:
            logger.info("interrupted — running final evaluation")

        if self.save_every:
            save_checkpoint(self.ckpt_path, ts, trainer.mesh)
        return ts, {
            "episodes": episodes,
            "env_steps": ts.env_steps,
            "avg100": float(np.mean(window)) if window else float("nan"),
            "solved": solved,
            "wall_s": time.time() - t0,
            "curve": curve,
        }

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, ts, episodes: int = 5, seed: int = 1234):
        """Deterministic policy, frozen normalization (ref utils/runner.py:169-184)."""
        noise = Noise(self.trainer.device, seed)
        returns, lengths = self.trainer.eval_episodes(ts, noise, episodes)
        return float(returns.mean()), float(lengths.float().mean())

    def test(self, ts, episodes: int = 5, render: bool = False):
        """Reference ``test()``: a deterministic evaluation, logged, and with
        ``render`` one rendered episode saved as a GIF."""
        mean_r, mean_len = self.evaluate(ts, episodes)
        logger.info(f"test: mean reward {mean_r:.1f}, mean length {mean_len:.0f}")
        if render:
            path = self.render_episode(ts)
            if path:
                logger.info(f"render saved to {path}")
        return mean_r

    @torch.no_grad()
    def episode_frames(self, ts, seed: int = 0, max_frames: int = 1000):
        """One deterministic episode at B=1 without autoreset, the policy's
        carry (a recurrent hidden) threaded through it: the reset frame and
        one per step, as ``uint8[H, W, 3]``; ``None`` when no renderer is
        registered for the env."""
        env, params = self.trainer.venv.env, self.trainer.venv.params
        if env.name not in RENDERERS:
            logger.info(f"no renderer registered for {env.name}")
            return None
        noise = Noise(self.trainer.device, seed)
        state, obs = env.reset_batch(params, noise, 1)
        frames = [render(env, state_row(state))]
        carry = self.trainer.policy_reset(1)
        for _ in range(min(max_frames, env.max_steps)):
            carry, action = self.trainer.policy_step(ts, carry, obs, noise, deterministic=True)
            sr = env.step_batch(params, state, action, noise)
            state, obs = sr.state, sr.obs
            frames.append(render(env, state_row(state)))
            if bool(sr.terminated[0] | sr.truncated[0]):
                break
        return frames

    def render_episode(self, ts, seed: int = 0, max_frames: int = 1000):
        """``episode_frames`` saved as ``./exp/renders/{algo}_{env}.gif``;
        returns its path, or ``None`` when the env has no renderer."""
        frames = self.episode_frames(ts, seed, max_frames)
        if frames is None:
            return None
        os.makedirs("./exp/renders", exist_ok=True)
        return save_gif(frames, f"./exp/renders/{self.algo_name}_{self.env_name}.gif")


def run_benchmark(trainer_cls, cfg, algo_name: str, *, seed: int = 0,
                  device: str = "cuda", **loop_kwargs):
    """`BenchMark.train` equivalent (reference utils/runner.py:209-226)."""
    trainer = trainer_cls(cfg, device=device)
    loop = TrainLoop(trainer, algo_name, **loop_kwargs)
    ts, stats = loop.train(
        cfg.max_train_steps,
        solve_threshold=getattr(cfg, "solve_threshold", None),
        seed=seed,
    )
    return loop, ts, stats
