"""The port's recurrent full-tricks PPO (``gymrl_tpu_torch/algos/ppo_lstm.py``
``PPOLSTMTrainer``) as a side of the comparison (``benchlib/compare.py``),
the counterpart of ``reference/ppo_lstm.py`` ``Reference``: ``iterate`` is
one iteration of the timed path (``benchlib/program.py`` ``iteration``) with
its loss metrics, its finished episodes and, at the first iteration, its
rows: the chunks by field as ``_chunks`` hands them to the packing and the
update, with each step's ``done`` cut the same way (the judge resets the
hidden where the rollout did); ``leaves`` and ``moments`` read the params
and Adam's first moments of the train state. Its marks, env steps and
tiny schedule are the PPO family's (``benchlib/program.py`` ``OnPolicy``).
``Settings`` is the trainer's config as a cell's files name it.
"""

# No ``from __future__ import annotations``: ``benchlib.files.module`` runs
# this file outside ``sys.modules``, where a dataclass cannot read string
# annotations.
import dataclasses

import numpy as np
import torch

from benchlib import program
from gymrl_tpu_torch.algos.ppo_lstm import PPOLSTMConfig


@dataclasses.dataclass(frozen=True)
class Settings(PPOLSTMConfig):
    """``PPOLSTMConfig`` with its minibatch given in rows, as every traffic
    mix of the harness gives it (``minibatch_size``): the trainer takes
    ``minibatch_size / seq_len`` chunks a minibatch (``seq_minibatch``).
    Nothing else differs: the trainer runs as the CLI runs it."""

    minibatch_size: int = 1024

    def __post_init__(self):
        if self.minibatch_size % self.seq_len:
            raise ValueError(f"minibatch_size {self.minibatch_size} is no whole number of "
                             f"{self.seq_len}-step chunks")
        object.__setattr__(self, "seq_minibatch", self.minibatch_size // self.seq_len)


class Program(program.OnPolicy):
    METRICS = ("policy_loss", "value_loss", "entropy", "rnd_loss", "approx_kl", "clip_frac",
               "erc_clip_frac")
    # The program's hand-written kernels on this trainer's path, by their names in a
    # trace: a traced run prints their traced count beside ``kernels.LAUNCHES``'.
    KERNELS = ("lander_step", "lander_reset", "clip_adam")

    def __init__(self, trainer, ts):
        self.trainer, self.ts = trainer, ts
        self._rows = None
        chunks = trainer._chunks

        def tapped(roll, adv, returns):
            out = chunks(roll, adv, returns)
            L, B = trainer.cfg.seq_len, trainer.cfg.num_envs
            done = roll.done.reshape(-1, L, B).movedim(2, 1).reshape(-1, L)
            self._rows = {**{k: v.cpu() for k, v in out.items()}, "done": done.cpu()}
            del trainer._chunks
            return out

        trainer._chunks = tapped

    def iterate(self) -> dict:
        self.ts, out, done, finals = program.iteration(self.trainer, self.ts)
        rows, self._rows = self._rows, None
        return {"metrics": torch.stack([out.metrics[k] for k in self.METRICS]).tolist(),
                "episodes": (int(done.sum()), float(np.sum(finals, dtype=np.float64))),
                "rows": rows}

    @staticmethod
    def params_of(ts) -> dict[str, torch.Tensor]:
        """The parameters of a train state by name (also read after the window:
        a run whose parameters are not finite failed)."""
        return dict(ts.params.named_parameters())

    def leaves(self) -> dict[str, torch.Tensor]:
        return self.params_of(self.ts)

    def moments(self) -> dict[str, torch.Tensor]:
        opt = self.ts.opt_state
        return {k: opt.state[p]["exp_avg"] for k, p in self.leaves().items()}
