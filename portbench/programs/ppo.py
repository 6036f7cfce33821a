"""The port's PPO trainer (``gymrl_tpu_torch/algos/ppo.py`` ``PPOTrainer``)
as a side of the comparison (``benchlib/compare.py``), the counterpart of
``reference/ppo.py`` ``Reference``: ``iterate`` is one iteration of the
timed path (``benchlib/program.py`` ``iteration``) with its loss metrics,
its finished episodes and, at the first iteration, the packed rows as its
update takes them (``train_iter`` hands them to ``_sgd``); ``leaves`` and
``moments`` read the params and Adam's first moments of the train state.
Its marks, env steps and tiny schedule are the PPO family's
(``benchlib/program.py`` ``OnPolicy``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import program


class Program(program.OnPolicy):
    METRICS = ("policy_loss", "value_loss", "entropy", "clip_frac", "approx_kl")
    # The program's hand-written kernels on this trainer's path, by their names in a
    # trace: a traced run prints their traced count beside ``kernels.LAUNCHES``'.
    KERNELS = ("lander_step", "lander_reset", "ppo_loss_fwd", "ppo_loss_bwd", "grad_sq_norms",
               "clip_adam")

    def __init__(self, trainer, ts):
        self.trainer, self.ts = trainer, ts
        self._rows = None
        sgd = trainer._sgd

        def tapped(ts, packed, perms):
            self._rows = packed.cpu()
            del trainer._sgd
            return sgd(ts, packed, perms)

        trainer._sgd = tapped

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
