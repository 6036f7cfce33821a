"""step_mfu: the whole iteration's share of the card's peak, %.

Each dense layer's products an iteration needs (the configuration's
``model_work``, ``work/actor_critic.py`` for the PPO actor-critic:
the rollout's forward per env step and the next-value forward over every
successor, in the rollout's type; every epoch's forward and backward of
every row, in the SGD's), each at the peak of its type (bf16 989 TFLOP/s;
float32 67 TFLOP/s, or TF32 495 where the process lets float32 products run
in TF32), over the mean wall time of the window's iterations. A run whose
trace holds no kernel (no card) has nothing to read.
"""


def read(view):
    if not view.kernels or not view.iter_s:
        return None
    net = view.work(view.conf["model_work"])
    ideal = net.ideal_iteration_s(view.cfg, view.conf["env_sizes"], view.peaks, view.tf32)
    return 100.0 * ideal / (sum(view.iter_s) / len(view.iter_s))
