"""rollout_ms: the rollout: T steps of the policy forward, the Gumbel-max draw
and the env step with autoreset, in ms, averaged over the window's
iterations.

Read between two CUDA events the benchmark records on the card's stream
through ``train_iter``'s timer (``gymrl_tpu_torch/algos/ppo.py`` :305-365):
from the iteration's start to the "rollout" mark. On a host-bound phase the
events follow the host, so this is the phase's time as the iteration pays
it, not the device's busy time in it.
"""


def read(view):
    rows = [r["rollout"] for r in view.phases if "rollout" in r]
    return sum(rows) / len(rows) if rows else None
