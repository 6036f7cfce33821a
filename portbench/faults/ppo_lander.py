"""Faults planted in the port's PPO trainer on the lander underneath a run,
to show that the comparison catches them (``portbench/tests`` and
``calibrate.py``; a benchmark run plants none). A configuration names its
faults (``"faults": "faults.ppo_lander:PLANTS"``). Each is
``plant(trainer)``, applied before the trainer's first iteration:

  * ``unchanged``: every grad step computes its loss and steps nothing, so
    an iteration returns the params and Adam's state as it found them;
  * ``half_batch``: every grad step's loss and gradient are the mean over
    the first half of its minibatch only;
  * ``answer``: the reward is altered where the env step produces it: the
    engines' fuel cost is left out.

One chip: no exchange between chips exists to leave out.
"""

from __future__ import annotations

import torch

MAIN_FUEL, SIDE_FUEL = 0.30, 0.03


def unchanged(trainer) -> None:
    d = trainer.obs_dim

    def step(ts, mb):
        with torch.no_grad():
            _, metrics = trainer._loss(ts.params, mb[:, :d], mb[:, d], mb[:, d + 1],
                                       mb[:, d + 2], mb[:, d + 3])
        return metrics.vec

    trainer._minibatch_step = step


def half_batch(trainer) -> None:
    full = trainer._minibatch_step
    trainer._minibatch_step = lambda ts, mb: full(ts, mb[: mb.shape[0] // 2])


def answer(trainer) -> None:
    env = trainer.venv.env
    step_from = env.step_from

    def altered(params, state, action, disp):
        r = step_from(params, state, action, disp)
        a = action.to(torch.int32)
        fuel = MAIN_FUEL * (a == 2).float() + SIDE_FUEL * ((a == 1) | (a == 3)).float()
        live = ~r.terminated
        return r._replace(reward=torch.where(live, r.reward + fuel, r.reward))

    env.step_from = altered


PLANTS = {"unchanged": unchanged, "half_batch": half_batch, "answer": answer}
