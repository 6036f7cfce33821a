"""The comparison that decides ``correct``: the program's first iterations
against the plain reference's, from the same seed.

Both sides show the same small interface: ``METRICS``, the names of an
iteration's loss metrics; ``iterate()``, one iteration's ``{"metrics": [...],
"episodes": (finished, sum of their returns), "rows": the rollout's rows as
the update takes them, or None}``; ``leaves()`` and ``moments()``, the
parameters and the optimizer's first moments by name. The reference side
(``reference/<name>.py``, named by the configuration's ``reference``) adds
``loss(cfg, metrics)`` and ``judge_rows(rows)``; the program side
(``programs/<name>.py``, its ``program``) reads the port's train state and
tells the harness how its trainer runs: ``PHASES``, the marks its
``train_iter`` makes (``benchlib/program.py`` ``phases``), and
``env_steps(cfg)``, the env steps of an iteration at the cell's settings.

``summarize`` drives a side through ``SETUP_ITERS`` iterations: each
iteration's metrics and episodes, every leaf's first moment after the first
iteration (the gradient as the optimizer took it), the first iteration's
rows, and every leaf's change over all of them. ``numbers`` reduces a pair
of summaries to the numbers compared:

  * ``loss``: the widest gap of an iteration's loss relative to the
    reference's;
  * ``moment``: the worst leaf's gap between the two sides' norms of the
    first moment, relative to the reference's norm of that leaf or of the
    median leaf, whichever is larger;
  * ``change``: the same of the norms of each leaf's change, leaving out the
    leaves whose reference moment is under a thousandth of the median
    leaf's (moved by round-off alone);
  * ``returns``: the widest gap of an iteration's mean finished-episode
    return, relative to the reference's (at least 1);
  * ``rollout``: what a fresh reference from the seed reads of the
    program's first rows (``judge_rows``; PPO: the widest gap of a row's
    recorded log-prob): the one number that reads the policy's forward
    before trajectories part.

A cell's ``limits/<cell>.json`` names the numbers it compares and their
limits; a number at or past its limit, or not finite, makes the run not
correct.
"""

from __future__ import annotations

import math
import statistics

import torch

from benchlib import files

SETUP_ITERS = 3
MOVED_BY_ROUNDING = 1e-3
NUMBERS = ("loss", "moment", "change", "returns", "rollout")


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) for k, v in tensors.items()}


def summarize(side, mark=None) -> dict:
    """``side`` driven through ``SETUP_ITERS`` iterations; ``mark(k)`` after
    iteration ``k``."""
    start = {k: v.detach().clone() for k, v in side.leaves().items()}
    metrics, episodes, moment, rows = [], [], {}, None
    for k in range(SETUP_ITERS):
        out = side.iterate()
        metrics.append(list(out["metrics"]))
        episodes.append(tuple(out["episodes"]))
        if k == 0:
            moment, rows = _norms(side.moments()), out["rows"]
        if mark is not None:
            mark(k)
    change = _norms({k: v.detach() - start[k] for k, v in side.leaves().items()})
    return {"metrics": metrics, "episodes": episodes, "moment": moment, "change": change,
            "rows": rows}


def reference(conf: dict, cfg: dict, seed: int, device: torch.device,
              f32_matmul: str = "ieee", bench_dir: str = files.BENCH_DIR):
    """The configuration's reference from ``seed``, on its reference env."""
    cls = files.obj(conf["reference"], bench_dir)
    return cls(cfg, seed, device, f32_matmul, files.obj(conf["reference_env"], bench_dir))


def reference_summary(conf: dict, cfg: dict, seed: int, device: torch.device,
                      f32_matmul: str = "ieee", bench_dir: str = files.BENCH_DIR) -> dict:
    return summarize(reference(conf, cfg, seed, device, f32_matmul, bench_dir))


def moved_by_rounding(ref: dict) -> list[str]:
    """The leaves the change leaves out: reference moment under
    ``MOVED_BY_ROUNDING`` of the median leaf's."""
    moved = MOVED_BY_ROUNDING * statistics.median(ref["moment"].values())
    return [k for k, v in ref["moment"].items() if v < moved]


def _worst_leaf(prog: dict, ref: dict, keep) -> float:
    scale = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], scale) for k in ref if keep(k))


def numbers(prog: dict, ref: dict, conf: dict, cfg: dict, seed: int, device: torch.device,
            bench_dir: str = files.BENCH_DIR) -> dict[str, float]:
    if set(prog["moment"]) != set(ref["moment"]):
        raise ValueError(f"leaves differ: {sorted(prog['moment'])} vs {sorted(ref['moment'])}")
    judge_side = reference(conf, cfg, seed, device, "ieee", bench_dir)
    loss_of = judge_side.loss
    loss = max(abs(loss_of(cfg, p) - loss_of(cfg, r)) / abs(loss_of(cfg, r))
               for p, r in zip(prog["metrics"], ref["metrics"]))
    left_out = moved_by_rounding(ref)
    returns = max(abs(ps / max(pn, 1) - rs / max(rn, 1)) / max(abs(rs / max(rn, 1)), 1.0)
                  for (pn, ps), (rn, rs) in zip(prog["episodes"], ref["episodes"]))
    return {
        "loss": loss,
        "moment": _worst_leaf(prog["moment"], ref["moment"], lambda k: True),
        "change": _worst_leaf(prog["change"], ref["change"], lambda k: k not in left_out),
        "returns": returns,
        "rollout": judge_side.judge_rows(prog["rows"]),
    }


def judge(nums: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, compared)``: each number of ``limits`` beside its limit."""
    compared = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] < c["limit"] for c in compared.values())
    return ok, compared
