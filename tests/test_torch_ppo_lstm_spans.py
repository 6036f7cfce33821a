"""The program's spans in recurrent full-tricks PPO and the mHC backbone
(``utils.profiling.span``): one small ``train_iter`` on the CPU opens each
span the number of times its loop runs, nested where its caller is; with
tracing off nothing is recorded and the iteration's outputs are the same to
the bit."""

import collections

import pytest
import torch

from gymrl_tpu_torch.algos.ppo_full import PPOFullConfig, PPOFullTrainer
from gymrl_tpu_torch.algos.ppo_lstm import PPOLSTMConfig, PPOLSTMTrainer
from gymrl_tpu_torch.utils import profiling

torch.set_num_threads(2)

SMALL = dict(num_envs=4, rollout_steps=16, seq_len=8, seq_minibatch=4, num_epochs=2,
             mhc_dim=32, rnn_hidden=32, rnd_embed=32, flat_optimizer=True)


@pytest.fixture
def tracing():
    profiling.clear()
    profiling.enable()
    yield
    profiling.disable()
    profiling.clear()


def _lstm(**kw):
    return PPOLSTMTrainer(PPOLSTMConfig(**{**SMALL, **kw}), device="cpu")


def _opened(trainer, seed=0):
    ts = trainer.init(seed)
    profiling.clear()
    trainer.train_iter(ts)
    spans = profiling.spans()
    return spans, collections.Counter(s.name for s in spans)


@pytest.mark.parametrize("layers", [1, 2])
def test_a_recurrent_iteration_opens_each_span_once_per_loop_body(tracing, layers):
    """T rollout steps, one successor forward, G = epochs × minibatches grad
    steps: the backbone runs T + 1 + G times, each time opening two Sinkhorn
    projections a block; RND runs every rollout step and grad step, the
    GRU's unroll every grad step."""
    trainer = _lstm(mhc_layers=layers)
    T, G = trainer.cfg.rollout_steps, trainer.cfg.num_epochs * trainer.cfg.num_minibatches
    spans, n = _opened(trainer)
    assert n == {"train_iter": 1, "rollout": 1, "rollout.step": T, "policy": T, "env.step": T,
                 "gae": 1, "sgd": 1, "rnd": T + G, "mhc": T + 1 + G,
                 "mhc.sinkhorn": 2 * layers * (T + 1 + G), "rnn.unroll": G}
    parent = collections.Counter((s.name, spans[s.parent].name if s.parent >= 0 else None)
                                 for s in spans)
    assert parent == {("train_iter", None): 1, ("rollout", "train_iter"): 1,
                      ("rollout.step", "rollout"): T, ("policy", "rollout.step"): T,
                      ("env.step", "rollout.step"): T, ("rnd", "policy"): T,
                      ("mhc", "policy"): T, ("gae", "train_iter"): 1, ("mhc", "gae"): 1,
                      ("sgd", "train_iter"): 1, ("rnd", "sgd"): G, ("mhc", "sgd"): G,
                      ("rnn.unroll", "sgd"): G, ("mhc.sinkhorn", "mhc"): 2 * layers * (T + 1 + G)}
    assert all(s.iteration == 0 and s.end_ns >= s.start_ns for s in spans)


def test_the_lstm_cell_opens_its_unroll_span(tracing):
    trainer = _lstm(rnn_cell="lstm")
    _, n = _opened(trainer)
    assert n["rnn.unroll"] == trainer.cfg.num_epochs * trainer.cfg.num_minibatches


def test_full_tricks_ppo_opens_the_mhc_spans(tracing):
    """ppo_full shares the backbone: its spans open there too."""
    cfg = PPOFullConfig(num_envs=4, rollout_steps=8, num_epochs=2, minibatch_size=16, mhc_dim=32)
    trainer = PPOFullTrainer(cfg, device="cpu")
    _, n = _opened(trainer)
    G = cfg.num_epochs * cfg.num_minibatches
    assert n["mhc"] == cfg.rollout_steps + 1 + G
    assert n["mhc.sinkhorn"] == 2 * cfg.mhc_layers * n["mhc"]


def test_tracing_off_records_nothing_and_changes_no_bit():
    """The same seed's iteration with tracing on and off: equal params, Adam
    state, metrics and episode statistics; off, no span is kept."""
    outs = []
    for on in (True, False):
        profiling.clear()
        if on:
            profiling.enable()
        try:
            trainer = _lstm()
            ts = trainer.init(5)
            for _ in range(2):
                ts, out = trainer.train_iter(ts)
        finally:
            profiling.disable()
        outs.append((ts, out, len(profiling.spans())))
    (ts_on, out_on, n_on), (ts_off, out_off, n_off) = outs
    profiling.clear()
    assert n_on > 0 and n_off == 0
    for (name, a), b in zip(ts_on.params.named_parameters(), ts_off.params.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(ts_on.opt_state.state[a]["exp_avg_sq"],
                           ts_off.opt_state.state[b]["exp_avg_sq"]), name
    assert torch.equal(ts_on.hidden, ts_off.hidden)
    assert out_on.metrics.keys() == out_off.metrics.keys()
    for k in out_on.metrics:
        assert torch.equal(out_on.metrics[k], out_off.metrics[k]), k
    for a, b in zip(out_on[:3], out_off[:3]):
        assert torch.equal(a, b)
