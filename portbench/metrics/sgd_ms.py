"""sgd_ms: the update: the lr, the epochs' permutations and the SGD sweep (one
CUDA-graph replay), in ms, averaged over the window's iterations.

Read between two CUDA events the benchmark records on the card's stream
through ``train_iter``'s timer (``gymrl_tpu_torch/algos/ppo.py`` :305-365):
from the "gae" mark to the "sgd" mark. On a host-bound phase the events
follow the host, so this is the phase's time as the iteration pays it, not
the device's busy time in it.
"""


def read(view):
    rows = [r["sgd"] for r in view.phases if "sgd" in r]
    return sum(rows) / len(rows) if rows else None
