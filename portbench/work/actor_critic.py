"""Work of the actor-critic MLP (gymRL ``algorithms/ppo_lunarlander.py:63-118``):
the shared 2-layer tanh trunk, the actor's hidden layer and head, the critic's
hidden layer and head, each a dense layer ``in × out`` with a bias.

``sizes`` is the configuration's ``env_sizes`` (``{"obs": 8, "actions": 4}``
for LunarLander). ``macs_forward`` is one row's multiply-adds through every
layer: 199,936 at LunarLander's 8 observations, 4 actions and a width of
256. A row of SGD takes the forward, the weights' gradients (the forward's
MACs again) and the inputs' gradients of every layer but the first, whose
input, the observation, needs none. The step's ideal time counts each product at the
peak of the type it runs in.
"""


def layers(cfg: dict, sizes: dict) -> list[tuple[int, int]]:
    """``(in, out)`` of shared_0, shared_1, actor_0, actor_head, critic_0, critic_head."""
    obs, actions = sizes["obs"], sizes["actions"]
    h = cfg["hidden_dim"]
    return [(obs, h), (h, h), (h, h), (h, actions), (h, h), (h, 1)]


def macs_forward(cfg: dict, sizes: dict) -> int:
    return sum(i * o for i, o in layers(cfg, sizes))


def macs_sgd_row(cfg: dict, sizes: dict) -> int:
    first_in, first_out = layers(cfg, sizes)[0]
    return 3 * macs_forward(cfg, sizes) - first_in * first_out


def params(cfg: dict, sizes: dict) -> int:
    return sum(i * o + o for i, o in layers(cfg, sizes))


def tensors(cfg: dict, sizes: dict) -> int:
    return 2 * len(layers(cfg, sizes))


def ideal_iteration_s(cfg: dict, sizes: dict, peaks: dict, tf32: bool) -> float:
    """One iteration's products at peak: the rollout's forward per env step
    and the next-value forward over all T·B successors (in the rollout's
    type), and every epoch's forward and backward of every row (in the SGD's)."""
    f32 = peaks["tf32_flops_per_s" if tf32 else "f32_flops_per_s"]
    bf16 = peaks["bf16_flops_per_s"]
    n = cfg["num_envs"] * cfg["rollout_steps"]
    rollout = 2 * 2 * n * macs_forward(cfg, sizes) / (bf16 if cfg["rollout_bf16"] else f32)
    sgd = (2 * cfg["num_epochs"] * n * macs_sgd_row(cfg, sizes)
           / (bf16 if cfg["sgd_bf16"] else f32))
    return rollout + sgd
