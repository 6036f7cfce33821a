"""Recurrent full-tricks PPO's T-step rollout as one replay of a captured
CUDA graph (``algos.base.RolloutGraph`` through ``PPOLSTMTrainer._collect``),
held on the CPU against the eager rollout, which the lockstep tests hold to
the JAX package.

``torch.cuda.CUDAGraph`` and the lander kernels' library are stood in for by
``test_torch_rollout_graph.py``'s ``TapeGraph`` and ``Lib`` (its ``lib``
fixture installs both); ``chip_smoke.py`` phase 20 holds the captured
rollout against the eager one on the card, to the bit. The tests:
  * (a) the route: only a CUDA trainer without a mesh, with ``graphs`` on
    and a plain ``Noise``, takes the graph;
  * (b) warm-up, capture and replays leave, to the bit, the
    ``LSTMRollout``, episode statistics, carry (env batch and hidden),
    generator state and ``kernels.LAUNCHES`` of as many eager rollouts, the
    capture running none of the library, for GRU + mHC and LSTM + PSCN;
    whole ``train_iter``s equal the eager ones, rows handed to ``_epochs``
    included;
  * (c) a restored state is copied in and replays; new params capture again;
  * (d) a net whose ``forward`` is replaced at construction (the benchmark's
    ``no_rnd_reward`` fault) is captured with the replacement;
  * (e) ``IterOut``'s statistics survive the next iteration.
"""

import pytest
import torch
from torch.utils._pytree import tree_flatten

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos import ppo_lstm as lstm_mod
from gymrl_tpu_torch.algos.ppo_lstm import LSTMRollout, PPOLSTMConfig, PPOLSTMTrainer
from gymrl_tpu_torch.core.noise import ShardedNoise
from gymrl_tpu_torch.utils.checkpoint import (
    flat_state, restore_checkpoint, save_checkpoint, state_tree,
)
from test_torch_rollout_graph import (  # noqa: F401 — ``lib`` is a fixture
    OneRankMesh, ReplayedNoise, TapeGraph, lib,
)

torch.set_num_threads(1)

SMALL = dict(num_envs=4, rollout_steps=8, seq_len=4, seq_minibatch=4, num_epochs=1,
             mhc_dim=16, rnn_hidden=16, rnd_embed=32, flat_optimizer=True)
# GRU on the mHC backbone on the lander; LSTM on the PSCN fallback on CartPole,
# whose episodes end within a few rollouts, so the hidden's reset at done runs.
CELLS = {"gru_mhc": dict(rnn_cell="gru", use_mhc=True),
         "lstm_pscn": dict(rnn_cell="lstm", use_mhc=False, env_name="CartPole-v1",
                           rollout_steps=16)}


def _trainer(cell="gru_mhc", graphed=False, **kw):
    trainer = PPOLSTMTrainer(PPOLSTMConfig(**{**SMALL, **CELLS[cell], **kw}), device="cpu")
    if graphed:
        trainer._graphed = lambda: True  # the CUDA route, on the CPU's tensors
    return trainer


def _leaves(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _collects(trainer, ts, n):
    """``n`` rollouts by ``_collect``, the carry threaded: each one's
    outputs (copied), generator state and launches."""
    got = []
    for _ in range(n):
        before = dict(kernels.LAUNCHES)
        (vec_state, hidden), roll, stats = trainer._collect(ts)
        ts = ts._replace(vec_state=vec_state, hidden=hidden)
        got.append({"roll": [x.clone() for x in roll], "stats": [x.clone() for x in stats],
                    "carry": [x.clone() for x in _leaves((vec_state, hidden))],
                    "generator": ts.noise.generator.get_state(),
                    "launches": {k: kernels.LAUNCHES[k] - n for k, n in before.items()}})
    return ts, got


def _assert_same_runs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("roll", "stats", "carry", "generator"):
            assert _same(g[k], w[k]), (i, k)
        assert g["launches"] == w["launches"], i


# -- (a) the route -------------------------------------------------------------------------
@pytest.mark.parametrize("case,graphed", [
    ("cuda", True), ("cpu", False), ("mesh", False), ("graphs_off", False),
    ("replayed_noise", False), ("sharded_noise", False)])
def test_only_a_cuda_trainer_without_a_mesh_with_plain_noise_takes_the_graph(
        monkeypatch, case, graphed):
    trainer = _trainer()
    ts = trainer.init(0)
    made, eager = [], []

    class Holder:
        def __init__(self, device):
            made.append(device)

        def run(self, net, noise, carry, body):
            assert net is ts.params and noise is ts.noise
            assert carry[0] is ts.vec_state and carry[1] is ts.hidden
            return body(carry)

    monkeypatch.setattr(lstm_mod, "RolloutGraph", Holder)
    rollout = trainer._rollout
    monkeypatch.setattr(trainer, "_rollout", lambda *a: eager.append(a) or rollout(*a))
    if case != "cpu":
        trainer.device = torch.device("cuda")  # only the route reads it here
    trainer.graphs = case != "graphs_off"
    trainer.mesh = OneRankMesh() if case == "mesh" else None
    if case == "replayed_noise":
        ts = ts._replace(noise=ReplayedNoise("cpu", 0))
    if case == "sharded_noise":
        ts = ts._replace(noise=ShardedNoise(ts.noise, 0, 1))
    trainer._collect(ts)
    assert len(made) == int(graphed) and len(eager) == 1
    assert (trainer.rollout_graph is not None) is graphed


# -- (b) the holder against the eager rollout ----------------------------------------------
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_warm_up_capture_and_replays_leave_what_eager_rollouts_leave(lib, cell):
    iters = 4  # the warm-up, the capture with its replay, two more replays
    eager = _trainer(cell)
    _, want = _collects(eager, eager.init(7), iters)
    ran_eager = list(lib.ran)
    lib.ran.clear()

    trainer = _trainer(cell, graphed=True)
    ts = trainer.init(7)
    ts, got = _collects(trainer, ts, 1)  # the warm-up: eager
    holder = trainer.rollout_graph
    assert (holder.captures, holder.replays, TapeGraph.made_graphs) == (0, 0, [])
    ran_before_capture = len(lib.ran)
    rest = []
    for _ in range(iters - 1):
        ts, g = _collects(trainer, ts, 1)
        rest += g
        if holder.captures == 1 and holder.replays == 1:
            graph = TapeGraph.made_graphs[0]
            # the capture ran none of the library: the one replay ran its T steps
            steps = trainer.cfg.rollout_steps * trainer.cfg.env_name.startswith("LunarLander")
            assert len(lib.ran) - ran_before_capture == 2 * steps
            assert sum(callable(e) for e in graph.tape) == 2 * steps
    _assert_same_runs(got + rest, want)
    assert lib.ran == ran_eager
    assert (holder.captures, holder.replays, len(TapeGraph.made_graphs)) == (1, iters - 1, 1)
    assert TapeGraph.made_graphs[0].generators == [ts.noise.generator]
    # the carry handed out is the graph's static carry, so nothing is copied in next time
    assert all(a is b for a, b in zip(_leaves((ts.vec_state, ts.hidden)), holder.static))
    if cell == "lstm_pscn":  # episodes ended, so the graph reset hiddens at done
        assert any(bool(r["stats"][2].any()) for r in rest)


def _tap_epochs(monkeypatch, trainer, seen):
    epochs = trainer._epochs
    monkeypatch.setattr(trainer, "_epochs", lambda t, packed, spec, perms, loss_fn: seen.append(
        (packed.clone(), perms.clone())) or epochs(t, packed, spec, perms, loss_fn))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_graphed_train_iters_equal_the_eager_ones(lib, monkeypatch, cell):
    states, rows, outs = [], [], []
    for graphed in (False, True):
        trainer = _trainer(cell, graphed)
        seen = []
        _tap_epochs(monkeypatch, trainer, seen)
        ts = trainer.init(3)
        got = []
        for _ in range(3):
            ts, out = trainer.train_iter(ts)
            got.append((out.ep_return, out.ep_length, out.ep_done, out.metrics))
        if graphed:
            assert (trainer.rollout_graph.captures, trainer.rollout_graph.replays) == (1, 2)
        states.append(flat_state(state_tree(ts)))
        rows.append(seen)
        outs.append(got)
    (a, b), (ra, rb) = states, rows
    assert a.keys() == b.keys()
    for k in a:
        assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]), k
    assert len(ra) == len(rb) == 3
    assert all(torch.equal(x, y) for (pa, qa), (pb, qb) in zip(ra, rb) for x, y in
               ((pa, pb), (qa, qb)))
    assert _same(*outs)


# -- (c) restores --------------------------------------------------------------------------
def test_a_restored_state_is_copied_in_and_new_params_capture_again(lib, tmp_path):
    path = str(tmp_path / "ckpt.pt")
    runs = {}
    for graphed in (False, True):
        trainer = _trainer(graphed=graphed)
        ts = trainer.init(0)
        ts, _ = _collects(trainer, ts, 2)
        save_checkpoint(path, ts)
        ts, _ = _collects(trainer, ts, 1)
        # into the same state: params and the generator loaded in place, the carry new
        ts, into_same = _collects(trainer, restore_checkpoint(path, ts), 2)
        holder = trainer.rollout_graph
        counts = [(holder.captures, holder.replays)] if graphed else []
        # other params alone
        fresh = trainer.init(1)
        ts, new_params = _collects(trainer, ts._replace(params=fresh.params,
                                                        opt_state=fresh.opt_state), 1)
        # into a fresh state: new params and a new generator
        ts, into_fresh = _collects(trainer, restore_checkpoint(path, trainer.init(2)), 2)
        if graphed:
            counts.append((holder.captures, holder.replays))
        runs[graphed] = (into_same + new_params + into_fresh, counts)
    _assert_same_runs(runs[True][0], runs[False][0])
    assert runs[True][1] == [(1, 4), (3, 7)]


# -- (d) a forward replaced at construction ------------------------------------------------
def _no_rnd_reward(trainer):
    """The benchmark's ``no_rnd_reward`` fault: each net the trainer makes
    gets its own ``forward``, which pairs the RND predictor with itself."""
    make_net = trainer.make_net

    def made(*args, **kw):
        net = make_net(*args, **kw)

        def forward(h, obs):
            predict, _ = net.rnd(obs)
            return (*net.step(h, obs), predict, predict)

        net.forward = forward
        return net

    trainer.make_net = made
    return trainer


def test_a_forward_replaced_at_construction_is_what_the_graph_captures(lib):
    iters = 3
    runs = {}
    for name, graphed, plant in (("sound", False, False), ("eager", False, True),
                                 ("graph", True, True)):
        trainer = _trainer(graphed=graphed)
        if plant:
            _no_rnd_reward(trainer)
        _, runs[name] = _collects(trainer, trainer.init(5), iters)
    _assert_same_runs(runs["graph"], runs["eager"])
    # the replays' rewards are the replacement's: without the RND bonus
    reward = LSTMRollout._fields.index("reward")
    for graph, sound in zip(runs["graph"][1:], runs["sound"][1:]):
        assert not torch.equal(graph["roll"][reward], sound["roll"][reward])


# -- (e) the statistics handed out ---------------------------------------------------------
def test_iter_out_statistics_survive_the_next_iteration(lib):
    trainer = _trainer("lstm_pscn", graphed=True)
    ts = trainer.init(1)
    outs = []
    for _ in range(4):
        ts, out = trainer.train_iter(ts)
        outs.append((out, [x.clone() for x in (out.ep_return, out.ep_length, out.ep_done)]))
    assert trainer.rollout_graph.replays == 3
    assert any(bool(out.ep_done.any()) for out, _ in outs)  # episodes ended
    for out, kept in outs:
        assert _same([out.ep_return, out.ep_length, out.ep_done], kept)
    graph_out = _leaves(trainer.rollout_graph.out)
    for out, _ in outs:
        for x in (out.ep_return, out.ep_length, out.ep_done):
            assert all(x.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
                       for y in graph_out)
