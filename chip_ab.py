"""One tree's side of a parent/change comparison of the hand-written kernels on the card.

``chip_smoke.py`` measures each kernel; this script runs those of its
measurements that a parent commit's ``chip_smoke.py`` has as well, so that
two trees can be compared inside one call on one card. Unpack the parent
with ``git archive`` into a directory ``.gitignore`` lists, copy this file
into it, and run the two trees in turns, parent / change / change / parent:

    python chip_ab.py

It prints the card's name and power limit, then ``chip_smoke.py``'s own
lines: phase 18 (c) (the lander kernels at 64 and 8192 envs, on the states
that tree times), phase 19 (d) at the bench's, ``ppo_lunarlander``'s and
``ppo_cartpole``'s shapes, phase 19 (e), phase 2's bench and phase 17's
profile; and lines of its own: the ms of the loss head's backward through
autograd (``PPOHeadLoss``) at those three shapes, of one lander
``VecEnv.step`` (CUDA events over 100 steps from one state) at 64 and 8192
envs, the host ms of allocating a reset's outputs as twelve tensors and,
where the tree has it, as ``kernels.lunarlander._reset_outputs`` cuts them
from three, and last a summary: phase 2's SGD ms and env-steps/s and phase
17's busy share of each case. It needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ab: this needs a CUDA device", file=sys.stderr)
        return 1
    from gymrl_tpu_torch.utils.device import gpu_name_and_power_limit

    device = torch.device("cuda")
    cs.log(gpu_name_and_power_limit())
    cs.phase_kernels(device, envs=(64, 8192), steps=1)
    for name in ("bench", "ppo_lunarlander", "ppo_cartpole"):
        cs._update_times(device, name, cs.KERNEL_TIMED_CALLS)
        cs.log("ab head backward: " + json.dumps(head_backward_ms(device, name)))
    for name in ("bench", "ppo_lunarlander"):
        cs._step_launches(device, name)
    for num in (64, 8192):
        cs.log("ab VecEnv.step: " + json.dumps(vecenv_step_ms(device, num)))
        cs.log("ab reset outputs: " + json.dumps(reset_alloc_ms(device, num)))
    bench = cs.phase_bench(device)
    profile = cs.phase_profile(device)
    cs.log("ab summary: " + json.dumps({
        "sgd_ms": bench["phase_ms"]["sgd"], "env_steps_per_s": bench["env_steps_per_s"],
        "busy_share_untraced": {r["case"]: r["busy_share_untraced"] for r in profile},
        "launches_per_iter": {r["case"]: r["launches_per_iter"] for r in profile}}))
    return 0


def head_backward_ms(device: torch.device, name: str) -> dict:
    """ms of the loss head's backward alone through autograd (``PPOHeadLoss``
    at the case's first minibatch, the graph kept between calls)."""
    from gymrl_tpu_torch.kernels import ppo as kp

    trainer = cs._dist_trainer(name, device)
    ts, packed, perms = cs._rows_of(trainer)
    mb = cs._minibatches(trainer, packed, perms, 1)[0]
    logits, values = cs._net_outputs(trainer, ts.params, mb)
    lg, v = logits.clone().requires_grad_(True), values.clone().requires_grad_(True)
    loss, _ = kp.PPOHeadLoss.apply(lg, v, *cs._columns(trainer, mb), trainer.cfg)
    return {"case": name, "rows": mb.shape[0], "ms": cs._per_call_ms(
        device, lambda: torch.autograd.grad(loss, (lg, v), retain_graph=True))}


def vecenv_step_ms(device: torch.device, num: int) -> dict:
    """ms of one lander ``VecEnv.step`` (the step, the reset and the select),
    each of the timed steps from the same state."""
    from gymrl_tpu_torch.core.noise import Noise
    from gymrl_tpu_torch.envs.lunarlander import LunarLander
    from gymrl_tpu_torch.envs.rollout import VecEnv

    env = LunarLander()
    venv = VecEnv(env, env.default_params(), num)
    noise = Noise(device, 7)
    vs = venv.reset(noise)
    a = torch.randint(0, 4, (num,), dtype=torch.int32, device=device)
    return {"envs": num, "ms": cs._per_call_ms(device, lambda: venv.step(vs, a, noise))}


def reset_alloc_ms(device: torch.device, num: int) -> dict:
    """Host ms of a reset's outputs: twelve ``torch.empty``, and the tree's
    ``_reset_outputs`` where it has one."""
    from gymrl_tpu_torch.envs.lunarlander import CHUNKS
    from gymrl_tpu_torch.kernels import lunarlander as kl

    f32, i32 = torch.float32, torch.int32
    shapes = [((num, 2), f32), ((num, 2), f32), (num, f32), (num, f32), ((num, CHUNKS), f32),
              (num, f32), (num, f32), (num, i32), (num, i32), ((num, 2), torch.bool),
              (num, i32), ((num, 8), f32)]
    out = {"envs": num, "twelve_ms": cs._per_call_ms(device, lambda: [
        torch.empty(shape, dtype=dtype, device=device) for shape, dtype in shapes])}
    cut = getattr(kl, "_reset_outputs", None)
    if cut is not None:
        out["cut_ms"] = cs._per_call_ms(device, lambda: cut(num, device))
    return out


if __name__ == "__main__":
    sys.exit(main())
