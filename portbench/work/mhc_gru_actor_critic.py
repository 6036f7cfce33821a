"""Work of gymRL's recurrent full-tricks actor-critic
(``algorithms/ppo_lstm_lunarlander.py:446-520``): the mHC backbone (dim D,
N branches, ``mhc_layers`` blocks of two fuses), the GRU cell (hidden H),
the actor and critic ``SiluRMSMLP[512, ·]`` and the RND pair (two PSCNs of
width E and depth log2(E/16)).

Multiply-adds of one row through each product: the backbone's input map
(obs·D) and, per fuse, the product of the flattened branches with ``w``
(N·D · (N² + 2N)), the branch pooling (N·D), the branch mix (N·N·D) and the
block's linear map (D·D); the GRU's input maps (3·D·H) and hidden maps
(3·H·H); the heads (H·512 + 512·A and H·512 + 512); a PSCN (obs·E + Σ
(E/2^i)² over its deeper layers). Sinkhorn's rounds, the gates, the norms
and the activations are elementwise and not counted. At LunarLander's 8
observations and 4 actions, D 256, N 2, two blocks, H 512 and E 512: a
rollout step's forward is 2,175,488 MACs a row, a successor's 1,993,216, a
grad step's forward and backward 6,239,744; 2,179,067 parameters.

A grad step's row takes the forward, the target's forward included, and the
gradients of every weight and of every input that needs one: not the
observation's (the backbone's input map and the predictor's first layer),
not the frozen target's, and the hidden maps' input at a chunk's first step,
whose hidden is stored. The step's ideal time counts each product at the
float32 peak (TF32 where the process lets float32 products run in it).
"""

import math

HEAD_WIDTH = 512


def _widths(cfg: dict, sizes: dict) -> tuple[int, int, int, int, int]:
    return sizes["obs"], cfg["mhc_dim"], cfg["mhc_rate"], cfg["rnn_hidden"], sizes["actions"]


def pscn_layers(cfg: dict, sizes: dict) -> list[tuple[int, int]]:
    """``(in, out)`` of one RND PSCN's layers."""
    width, fan_in, out = cfg["rnd_embed"], sizes["obs"], []
    for _ in range(int(math.log2(cfg["rnd_embed"] // 16))):
        out.append((fan_in, width))
        fan_in = width = width // 2
    return out


def backbone_macs(cfg: dict, sizes: dict) -> int:
    obs, d, n, _, _ = _widths(cfg, sizes)
    fuse = n * d * (n * n + 2 * n) + n * d + n * n * d + d * d
    return obs * d + 2 * cfg["mhc_layers"] * fuse


def cell_macs(cfg: dict, sizes: dict) -> tuple[int, int]:
    """The GRU's input maps and hidden maps."""
    _, d, _, h, _ = _widths(cfg, sizes)
    return 3 * d * h, 3 * h * h


def heads_macs(cfg: dict, sizes: dict) -> int:
    h, a = cfg["rnn_hidden"], sizes["actions"]
    return h * HEAD_WIDTH + HEAD_WIDTH * a + h * HEAD_WIDTH + HEAD_WIDTH


def pscn_macs(cfg: dict, sizes: dict) -> int:
    return sum(i * o for i, o in pscn_layers(cfg, sizes))


def macs_successor(cfg: dict, sizes: dict) -> int:
    """One successor's value: the backbone, a cell step and the heads."""
    return backbone_macs(cfg, sizes) + sum(cell_macs(cfg, sizes)) + heads_macs(cfg, sizes)


def macs_step(cfg: dict, sizes: dict) -> int:
    """One rollout step's forward: the successor's products and the RND pair."""
    return macs_successor(cfg, sizes) + 2 * pscn_macs(cfg, sizes)


def macs_sgd_row(cfg: dict, sizes: dict) -> int:
    obs, d = sizes["obs"], cfg["mhc_dim"]
    x_maps, h_maps = cell_macs(cfg, sizes)
    pscn, bb, heads = pscn_macs(cfg, sizes), backbone_macs(cfg, sizes), heads_macs(cfg, sizes)
    backward = ((2 * pscn - obs * cfg["rnd_embed"]) + (2 * bb - obs * d) + 2 * x_maps
                + h_maps * (2 * cfg["seq_len"] - 1) // cfg["seq_len"] + 2 * heads)
    return macs_step(cfg, sizes) + backward


def params(cfg: dict, sizes: dict) -> int:
    obs, d, n, h, a = _widths(cfg, sizes)
    fuse = n * d * (n * n + 2 * n) + 3 + (n * n + 2 * n) + n * d
    backbone = obs * d + d + 2 * cfg["mhc_layers"] * (fuse + d * d + d) + d
    cell = 3 * (d * h + h) + 2 * h * h + h * h + h
    heads = 2 * (h * HEAD_WIDTH + 2 * HEAD_WIDTH) + HEAD_WIDTH * a + a + HEAD_WIDTH + 1
    rnd = 2 * sum(i * o + o + 1 for i, o in pscn_layers(cfg, sizes))
    return backbone + cell + heads + rnd


def ideal_iteration_s(cfg: dict, sizes: dict, peaks: dict, tf32: bool) -> float:
    """One iteration's products at peak: every rollout step's forward and
    every successor's, over the T·B rows, and every epoch's forward and
    backward of every row of every chunk."""
    f32 = peaks["tf32_flops_per_s" if tf32 else "f32_flops_per_s"]
    n = cfg["num_envs"] * cfg["rollout_steps"]
    rollout = 2 * n * (macs_step(cfg, sizes) + macs_successor(cfg, sizes))
    sgd = 2 * cfg["num_epochs"] * n * macs_sgd_row(cfg, sizes)
    return (rollout + sgd) / f32
