"""One tree's side of a parent/change comparison of the hand-written kernels on the card.

``chip_smoke.py`` measures each kernel; this script runs those of its
measurements that a parent commit's ``chip_smoke.py`` has as well, so that
two trees can be compared inside one call on one card. Unpack the parent
with ``git archive`` into a directory ``.gitignore`` lists, copy this file
into it, and run the two trees in turns, parent / change / change / parent:

    python chip_ab.py

It prints the card's name and power limit, then ``chip_smoke.py``'s own
lines: phase 18 (c) (the lander kernels at 64 and 8192 envs, on the states
that tree times), phase 19 (d) at the bench's and ``ppo_lunarlander``'s
shapes, phase 19 (e) and phase 2's bench. It needs a CUDA device.
"""

from __future__ import annotations

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
    for name in ("bench", "ppo_lunarlander"):
        cs._update_times(device, name, cs.KERNEL_TIMED_CALLS)
    for name in ("bench", "ppo_lunarlander"):
        cs._step_launches(device, name)
    cs.phase_bench(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
