"""Prioritized Experience Replay on the device (counterpart of
``gymrl_tpu/replay/per.py``).

Capability parity with the reference's PER stack
(algorithms/ddqn_per_cartpole.py:67-150, rainbow_dqn_cartpole.py:116-265):
max-priority insertion, stratified segment sampling (segment i draws from
``[i·total/B, (i+1)·total/B)``), IS weights ``(N·p)^-β`` over the batch
max, and priority write-back with a running max.

The sum-tree is one dense f32 ``[2N]`` tensor on the device (leaves at
``[N, 2N)``, ``tree[1]`` the total), N a power of two. Its arithmetic is
the JAX package's, operation for operation: sums are never recomputed; a
write scatters the leaf deltas and then adds the same deltas one level up
at a time (``index_add_`` per level, duplicates accumulating), so the tree
carries the rounding of every past delta exactly as the reference's does.
Sampling descends all B segments in lockstep, one gather-compare-select
per level.

The data is a structure of arrays as in ``replay/uniform.py``; ``pos`` and
``size`` are Python ints (fixed by the number of pushes, so no test of them
waits for the device); ``max_priority`` is a 0-dim tensor on the device.
The tree and the storage are written in place; the returned state shares
them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gymrl_tpu_torch.replay.uniform import replay_init


class PERState(NamedTuple):
    data: Any  # NamedTuple of [capacity, ...] tensors
    tree: torch.Tensor  # f32[2·capacity]
    pos: int
    size: int
    max_priority: torch.Tensor  # f32[] — priority given to fresh transitions


def _levels(capacity: int) -> int:
    levels = capacity.bit_length() - 1
    if capacity < 1 or 2 ** levels != capacity:
        raise ValueError(f"PER capacity must be a power of two, got {capacity}")
    return levels


def per_init(example: Any, capacity: int, device: str | torch.device = "cpu") -> PERState:
    _levels(capacity)
    return PERState(
        data=replay_init(example, capacity, device).data,
        tree=torch.zeros(2 * capacity, device=device),
        pos=0,
        size=0,
        max_priority=torch.ones((), device=device),  # ref: initial max priority 1.0
    )


def _propagate(tree: torch.Tensor, node: torch.Tensor, delta: torch.Tensor) -> None:
    """Add ``delta`` at the leaf nodes ``node`` and at each of their
    ancestors, one level at a time, in place."""
    tree.index_add_(0, node, delta)
    for _ in range(_levels(tree.shape[0] // 2)):
        node = node // 2
        tree.index_add_(0, node, delta)


def per_push_batch(state: PERState, batch: Any) -> PERState:
    """Insert a batch at the ring position with the current max priority."""
    capacity = state.tree.shape[0] // 2
    b = batch[0].shape[0]
    device = state.tree.device
    idx = (state.pos + torch.arange(b, device=device)) % capacity
    if state.pos + b <= capacity:  # one contiguous slice
        for store, xs in zip(state.data, batch):
            store[state.pos:state.pos + b] = xs
    else:
        for store, xs in zip(state.data, batch):
            store[idx] = xs.to(store.dtype)
    node = idx + capacity
    delta = state.max_priority.expand(b) - state.tree[node]
    _propagate(state.tree, node, delta)
    return state._replace(pos=(state.pos + b) % capacity, size=min(state.size + b, capacity))


def per_sample(state: PERState, noise, batch_size: int,
               beta) -> tuple[Any, torch.Tensor, torch.Tensor]:
    """Stratified sample with ``noise.per_uniforms``. Returns (batch, leaf
    indices int64, IS weights). ``beta``: a float or a 0-dim tensor."""
    tree = state.tree
    capacity = tree.shape[0] // 2
    total = tree[1]
    seg = total / batch_size
    u = noise.per_uniforms(batch_size)
    target = (torch.arange(batch_size, dtype=torch.float32, device=tree.device) + u) * seg
    node = torch.ones(batch_size, dtype=torch.int64, device=tree.device)
    for _ in range(_levels(capacity)):
        left = 2 * node
        left_sum = tree[left]
        go_left = target < left_sum
        node = torch.where(go_left, left, left + 1)
        target = torch.where(go_left, target, target - left_sum)
    # numerical guard: never pick an unfilled slot
    leaf_idx = torch.clamp(node - capacity, max=max(state.size - 1, 0))

    priorities = tree[leaf_idx + capacity]
    probs = priorities / torch.clamp(total, min=1e-8)
    n = float(max(state.size, 1))
    weights = torch.pow(n * torch.clamp(probs, min=1e-8), -beta)
    weights = weights / torch.clamp(weights.max(), min=1e-8)  # ref: /max over batch
    batch = type(state.data)(*(store[leaf_idx] for store in state.data))
    return batch, leaf_idx, weights


def per_update_priorities(state: PERState, leaf_idx: torch.Tensor,
                          priorities: torch.Tensor) -> PERState:
    """Write back post-exponent priorities; track the running max for inserts.

    Duplicate indices in one batch are deduplicated (the first occurrence
    wins, by a ``[B, B]`` compare) so the level-wise delta propagation never
    counts a leaf twice."""
    capacity = state.tree.shape[0] // 2
    eq = leaf_idx[None, :] == leaf_idx[:, None]
    first = torch.tril(eq, diagonal=-1).sum(dim=1) == 0  # no earlier equal index
    node = leaf_idx + capacity
    delta = torch.where(first, priorities - state.tree[node], 0.0)
    _propagate(state.tree, node, delta)
    return state._replace(max_priority=torch.maximum(state.max_priority, priorities.max()))
