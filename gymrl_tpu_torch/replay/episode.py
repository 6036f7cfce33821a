"""Padded episode-major rollout storage, FIFO queue and state ring
(counterpart of ``gymrl_tpu/replay/episode.py``).

  * ``EpisodeBufferState`` — the reference's on-policy layout
    (utils/buffer.py:53-102): preallocated ``[n_episodes, max_steps]``
    storage with an ``active`` mask; episodes of different lengths pad to
    ``max_steps``. ``episode_buffer_store`` appends one transition at a
    time; ``episode_buffer_pack`` lays out a whole ``[T, B]`` rollout at
    once, which is what the recurrent trainers' whole-episode BPTT uses.
  * ``Queue`` — a fixed-size FIFO ring with uniform sampling
    (utils/buffer.py:139-169), ``StateRing`` the same under the reference's
    name for a ring of env states (utils/model.py:378-386).

Data is a tensor, a dict or a NamedTuple of tensors. The store and push
write the storage in place and return the state that shares it; the queue's
``pos``/``size`` are Python ints, as the uniform replay's are.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of ``tree`` (a tensor, dict or NamedTuple),
    with the matching leaves of ``rest``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, *xs) for xs in zip(tree, *rest)))
    raise TypeError(f"cannot map over a {type(tree).__name__}")


def _leaves(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map(out.append, tree)
    return out


class EpisodeBufferState(NamedTuple):
    data: Any  # [n_episodes, max_steps, ...] per leaf
    active: torch.Tensor  # bool[n_episodes, max_steps] — valid-step mask
    lengths: torch.Tensor  # i32[n_episodes]
    ep_index: torch.Tensor  # i32[] — episode row being written
    full: torch.Tensor  # bool[] — every episode row filled once
    # episode_buffer_pack's overflow, counted: steps and episode segments
    # beyond rows_per_env that it discarded. Always 0 for the store path,
    # which wraps to row 0 instead of dropping.
    dropped_steps: torch.Tensor  # i32[]
    dropped_episodes: torch.Tensor  # i32[]


def _zero(device, dtype=torch.int32) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


def episode_buffer_init(example: Any, n_episodes: int, max_steps: int,
                        device: str | torch.device = "cpu") -> EpisodeBufferState:
    """Zeroed storage shaped after one unbatched example transition."""
    data = _map(lambda x: torch.zeros((n_episodes, max_steps) + tuple(x.shape), dtype=x.dtype,
                                      device=device), example)
    return EpisodeBufferState(
        data=data,
        active=torch.zeros((n_episodes, max_steps), dtype=torch.bool, device=device),
        lengths=torch.zeros(n_episodes, dtype=torch.int32, device=device),
        ep_index=_zero(device), full=_zero(device, torch.bool),
        dropped_steps=_zero(device), dropped_episodes=_zero(device),
    )


def episode_buffer_store(state: EpisodeBufferState, transition: Any, done) -> EpisodeBufferState:
    """Append one (unbatched) transition to the current episode row; on
    ``done`` move to the next row, which starts empty (the reference's v2
    ``store_transition``). No host sync: the row choice is a tensor op."""
    active = state.active.clone()
    n_episodes = active.shape[0]
    dev = active.device
    ep = state.ep_index.long()
    step = state.lengths[ep].long()

    def write(store, x):
        store[ep, step] = torch.as_tensor(x, device=dev).to(store.dtype)

    _map(write, state.data, transition)
    active[ep, step] = True
    lengths = state.lengths.clone()
    lengths[ep] += 1
    done = torch.as_tensor(done, device=dev).bool()
    next_ep = torch.where(done, (ep + 1) % n_episodes, ep)
    full = state.full | (done & (ep + 1 >= n_episodes))
    fresh = done & (next_ep != ep)  # the row being entered starts empty
    lengths[next_ep] = torch.where(fresh, 0, lengths[next_ep])
    active[next_ep] = active[next_ep] & ~fresh
    return state._replace(active=active, lengths=lengths,
                          ep_index=next_ep.to(torch.int32), full=full)


def episode_buffer_pack(data: Any, done: torch.Tensor, rows_per_env: int) -> EpisodeBufferState:
    """Episode-major layout of a ``[T, B]`` rollout in one scatter.

    The same result as ``T·B`` calls of ``episode_buffer_store``: every
    episode segment of every env column lands left-aligned in its own
    ``[max_steps=T]`` row, with ``active`` over its valid steps. Column b
    owns rows ``b·R .. b·R+R-1`` in episode order, so row ``b·R`` is its
    first (possibly mid-episode continuation) segment. Segments beyond R
    are written to a garbage row ``B·R`` that is then cut off (where several
    land on one slot of it the winner is arbitrary, and discarded), and
    counted in ``dropped_steps`` / ``dropped_episodes``.

    done: ``[T, B]``, the episode boundary AFTER step t. Returns
    ``B·rows_per_env`` rows.
    """
    T, B = done.shape
    R = rows_per_env
    dev = done.device
    t_range = torch.arange(T, device=dev)[:, None]
    done_prev = torch.cat([torch.zeros((1, B), dtype=torch.bool, device=dev),
                           done[:-1].bool()])
    ep_id = torch.cumsum(done_prev.long(), dim=0)  # [T, B]
    starts = done_prev.clone()
    starts[0] = True
    start_t = torch.cummax(torch.where(starts, t_range, -1), dim=0).values
    step_in_ep = t_range - start_t

    valid = ep_id < R
    n_rows = B * R
    row = torch.where(valid, torch.arange(B, device=dev)[None, :] * R + ep_id, n_rows)

    def scatter(x):
        out = torch.zeros((n_rows + 1, T) + tuple(x.shape[2:]), dtype=x.dtype, device=dev)
        out[row, step_in_ep] = x
        return out[:n_rows]

    active = scatter(valid)
    n_segments = ep_id[-1] + 1  # [B] — segments started in each column
    return EpisodeBufferState(
        data=_map(scatter, data),
        active=active,
        lengths=active.sum(dim=1, dtype=torch.int32),
        ep_index=_zero(dev),
        full=torch.ones((), dtype=torch.bool, device=dev),
        dropped_steps=(~valid).sum(dtype=torch.int32),
        dropped_episodes=torch.clamp(n_segments - R, min=0).sum(dtype=torch.int32),
    )


def episode_buffer_clear(state: EpisodeBufferState) -> EpisodeBufferState:
    """Every row empty again; the storage is kept."""
    dev = state.active.device
    return state._replace(active=torch.zeros_like(state.active),
                          lengths=torch.zeros_like(state.lengths),
                          ep_index=_zero(dev), full=_zero(dev, torch.bool))


class QueueState(NamedTuple):
    data: Any  # [capacity, ...] per leaf
    pos: int  # next write slot
    size: int  # fill level


def queue_init(example: Any, capacity: int, device: str | torch.device = "cpu") -> QueueState:
    data = _map(lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                      device=device), example)
    return QueueState(data=data, pos=0, size=0)


def queue_push(state: QueueState, item: Any) -> QueueState:
    """Write one item at ``pos``; the oldest is overwritten once full."""
    capacity = _leaves(state.data)[0].shape[0]

    def write(store, x):
        store[state.pos] = torch.as_tensor(x, device=store.device).to(store.dtype)

    _map(write, state.data, item)
    return QueueState(data=state.data, pos=(state.pos + 1) % capacity,
                      size=min(state.size + 1, capacity))


def queue_sample(state: QueueState, noise, batch_size: int) -> Any:
    """``batch_size`` items drawn uniformly, with replacement, from the
    filled slots."""
    idx = noise.replay_indices(batch_size, max(state.size, 1))
    return _map(lambda s: s[idx.to(s.device)], state.data)


# A ring of env states is a Queue under the reference's name (utils/model.py:378-386).
StateRing = QueueState
state_ring_init = queue_init
state_ring_push = queue_push
state_ring_sample = queue_sample
