"""The PPO family's loops, written once in ``algos.base``: ``rollout_scan``
(the T-step rollout of a per-step body), ``sweep`` (epochs × minibatches of
packed rows) and ``to_chunks`` (a rollout cut into sequences), each held on
the CPU against the hand-written loop it replaces, to the bit."""

from typing import NamedTuple

import pytest
import torch

from gymrl_tpu_torch.algos.base import rollout_scan, sweep, to_chunks
from gymrl_tpu_torch.utils import profiling
from gymrl_tpu_torch.utils.profiling import span


class Step(NamedTuple):
    obs: torch.Tensor  # f32[B, 3]
    action: torch.Tensor  # i32[B]
    done: torch.Tensor  # bool[B]


def _body(gen):
    """A rollout step: the carry is an env batch's ``[B, 3]`` state."""

    def step(state):
        with span("policy"):
            action = torch.randint(0, 4, state.shape[:1], generator=gen, dtype=torch.int32)
        nxt = state * 0.5 + action[:, None].float()
        done = nxt[:, 0] > 2.0
        return nxt, (Step(state, action, done), (nxt.sum(-1), done))

    return step


@pytest.fixture
def tracing():
    profiling.clear()
    profiling.enable()
    yield
    profiling.disable()
    profiling.clear()


@pytest.mark.parametrize("steps", [1, 7])
def test_rollout_scan_stacks_what_a_hand_written_loop_stacks(tracing, steps):
    init = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    step = _body(torch.Generator().manual_seed(1))
    with span("rollout"):
        carry, (roll, stats) = rollout_scan(step, init, steps)
    got = profiling.spans()

    step = _body(torch.Generator().manual_seed(1))
    state, outs = init, []
    for _ in range(steps):
        state, out = step(state)
        outs.append(out)
    want = Step(*(torch.stack(f) for f in zip(*(r for r, _ in outs))))
    want_stats = tuple(torch.stack(f) for f in zip(*(s for _, s in outs)))

    assert torch.equal(carry, state)
    assert type(roll) is Step and type(stats) is tuple and len(stats) == 2
    for a, b in zip((*roll, *stats), (*want, *want_stats)):
        assert a.dtype == b.dtype and a.shape[0] == steps and torch.equal(a, b)
    names = [s.name for s in got]
    assert names.count("rollout.step") == names.count("policy") == steps
    assert all(got[s.parent].name == "rollout.step" for s in got if s.name == "policy")
    assert all(got[s.parent].name == "rollout" for s in got if s.name == "rollout.step")


def _old_mean_metrics(history):
    """The dict mean the recurrent trainers took before ``sweep``."""
    means = torch.stack([torch.stack(list(m.values())) for m in history]).mean(dim=0)
    return dict(zip(history[0].keys(), means.unbind()))


@pytest.mark.parametrize("as_dict", [False, True])
def test_sweep_visits_each_epochs_minibatches_in_order_and_means_to_the_bit(as_dict):
    gen = torch.Generator().manual_seed(2)
    n, f, n_mb, epochs = 12, 3, 4, 3
    packed = torch.randn(n, f, generator=gen)
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(epochs)])
    seen, history = [], []

    def step(epoch, i, rows):
        seen.append((epoch, i, rows.clone()))
        metrics = {"a": rows.sum() / 7.0, "b": rows.max(), "c": rows[0, 0] * 1e-3}
        history.append(metrics)
        return metrics if as_dict else torch.stack(list(metrics.values()))

    got = sweep(packed, perms, n_mb, step)

    assert [(e, i) for e, i, _ in seen] == [(e, i) for e in range(epochs) for i in range(n_mb)]
    mb = n // n_mb
    for e, i, rows in seen:
        assert torch.equal(rows, packed[perms[e]][i * mb:(i + 1) * mb])
    want = _old_mean_metrics(history)
    if as_dict:
        assert list(got) == ["a", "b", "c"]
        assert all(torch.equal(got[k], want[k]) for k in want)
    else:
        assert torch.equal(got, torch.stack(list(want.values())))


@pytest.mark.parametrize("t,b,seq_len,tail,dtype", [
    (8, 3, 4, (), torch.float32), (6, 2, 2, (5,), torch.int32), (4, 1, 4, (2, 3), torch.bool)])
def test_to_chunks_cuts_each_env_column_into_chunk_major_sequences(t, b, seq_len, tail, dtype):
    x = (torch.arange(t * b * max(1, torch.tensor(tail).prod().item()))
         .reshape((t, b) + tail) % 5).to(dtype)
    got = to_chunks(x, seq_len)
    n_chunks = t // seq_len
    assert got.shape == (n_chunks * b, seq_len) + tail and got.dtype == dtype
    for c in range(n_chunks):
        for col in range(b):
            assert torch.equal(got[c * b + col], x[c * seq_len:(c + 1) * seq_len, col])
