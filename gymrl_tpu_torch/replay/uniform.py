"""Uniform replay on the device (counterpart of ``gymrl_tpu/replay/uniform.py``).

A preallocated ring buffer, structure-of-arrays: one ``[capacity, ...]``
tensor per field of a transition NamedTuple, on the trainer's device. A
batched push writes ``B`` consecutive slots ``(pos + arange(B)) % capacity``.
Sampling draws uniform indices in ``[0, max(size, 1))`` *with* replacement,
as the reference does (its docstring gives the reason).

``pos`` and ``size`` are Python ints: both are fixed by the number of
pushes, so a trainer's ``size >= batch_size`` test needs no device sync.
Pushes write the storage in place; the returned state shares it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class ReplayState(NamedTuple):
    data: Any  # NamedTuple of [capacity, ...] tensors
    pos: int  # next write slot
    size: int  # current fill level


def _capacity(state: ReplayState) -> int:
    return state.data[0].shape[0]


def replay_init(example: Any, capacity: int,
                device: str | torch.device = "cpu") -> ReplayState:
    """Zeroed storage shaped after one unbatched example transition."""
    data = type(example)(*(
        torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype, device=device)
        for x in example
    ))
    return ReplayState(data=data, pos=0, size=0)


def replay_push_batch(state: ReplayState, batch: Any) -> ReplayState:
    """Insert a batch (leading dim B) of transitions at the ring position."""
    capacity = _capacity(state)
    b = batch[0].shape[0]
    if state.pos + b <= capacity:  # one contiguous slice: no index tensor
        for store, xs in zip(state.data, batch):
            store[state.pos:state.pos + b] = xs
    else:
        idx = (state.pos + torch.arange(b, device=batch[0].device)) % capacity
        for store, xs in zip(state.data, batch):
            store[idx] = xs.to(store.dtype)
    return ReplayState(
        data=state.data,
        pos=(state.pos + b) % capacity,
        size=min(state.size + b, capacity),
    )


def _gather(state: ReplayState, idx: torch.Tensor) -> Any:
    return type(state.data)(*(store[idx] for store in state.data))


def replay_sample(state: ReplayState, noise, batch_size: int) -> Any:
    """Uniform sample of ``batch_size`` transitions (with replacement)."""
    return _gather(state, noise.replay_indices(batch_size, max(state.size, 1)))


def replay_sample_no_replacement(state: ReplayState, noise, batch_size: int) -> Any:
    """Without-replacement sample: Gumbel top-k over the fill region, O(capacity)."""
    capacity = _capacity(state)
    g = noise.gumbel((capacity,))
    g = torch.where(torch.arange(capacity, device=g.device) < state.size, g, -torch.inf)
    _, idx = torch.topk(g, batch_size)
    return _gather(state, idx)
