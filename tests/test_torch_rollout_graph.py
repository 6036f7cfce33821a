"""The T-step rollouts of PPO and of the recurrent full-tricks PPO as one
replay of a captured CUDA graph (``Trainer._rollout_route``,
``algos.base.RolloutGraph``), held on the CPU against the eager rollout,
which the lockstep tests hold to the JAX package.

A CUDA graph runs only on the card; ``chip_smoke.py`` phase 20 holds the
captured rollout there against the eager one, to the bit. Here (no card, no
nvcc) ``torch.cuda.CUDAGraph`` and the lander kernels' library are stood in
for, as ``test_torch_sgd_graph.py`` stands in for them:
  * ``TapeGraph``'s capture records every aten op and every launch of the
    stand-in library, in order, and leaves nothing it wrote outside its own
    tensors (the static carry, the registered generators) changed; it
    refuses a host sync and an unregistered generator, as a capture does.
    A replay runs the recording again on the same tensors: each random op
    draws from its generator's state at the time and advances it;
  * ``Lib``'s launches compute the plain lander step and reset into the
    wrapper's outputs, so both routes go through ``kernels.lunarlander``
    and count ``kernels.LAUNCHES``.
Each test runs for both trainers that take the route, ``PPOTrainer`` (on the
lander and CartPole) and ``PPOLSTMTrainer`` (GRU + mHC on the lander, LSTM +
PSCN on CartPole, whose episodes end within a few rollouts, so the hidden's
reset at done runs):
  * (a) the route: only a CUDA trainer without a mesh, with ``graphs`` on
    and a plain ``Noise``, takes the graph; ppo_full, recurrent PPO and PPG
    never do;
  * (b) warm-up, capture and replays leave, to the bit, the rollout, episode
    statistics, carry, generator state and ``kernels.LAUNCHES`` of as many
    eager rollouts, the capture running none of the library; whole
    ``train_iter``s equal the eager ones, rows handed to the update included;
  * (c) a restored state, or an external reset, is copied in and replays;
    replaced params or another generator (a restore into a fresh state)
    capture again; a failed capture raises and keeps no graph;
  * (d) a net whose ``forward`` is replaced at construction (the benchmark's
    ``no_rnd_reward`` fault) is captured with the replacement;
  * (e) ``IterOut``'s statistics survive the next iteration.
"""

import sys

import pytest
import torch
from torch.utils._pytree import tree_flatten

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos import base
from gymrl_tpu_torch.algos.ppg import PPGConfig, PPGTrainer
from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
from gymrl_tpu_torch.algos.ppo_full import PPOFullConfig, PPOFullTrainer
from gymrl_tpu_torch.algos.ppo_lstm import LSTMRollout, PPOLSTMConfig, PPOLSTMTrainer
from gymrl_tpu_torch.algos.ppo_rnn import PPORNNConfig, PPORNNTrainer
from gymrl_tpu_torch.core.noise import Noise, ShardedNoise
from gymrl_tpu_torch.envs import lunarlander as ll
from gymrl_tpu_torch.kernels import lunarlander as kl
from gymrl_tpu_torch.utils.checkpoint import (
    flat_state, restore_checkpoint, save_checkpoint, state_tree,
)

torch.set_num_threads(1)

HOST_SYNC = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default}


class Lib:
    """Stands in for the lander library: a launch computes the plain step
    or reset into the wrapper's outputs; while a ``TapeGraph`` captures, it
    is recorded into that graph instead, and runs on replay."""

    def __init__(self):
        self.env, self.params = ll.LunarLander(), ll.LunarLander().default_params()
        self.ran: list[str] = []

    def lander_step_launch(self, tensors, scalars):
        (pos, vel, angle, omega, shaping, sleep_time, terrain, wind_idx, torque_idx, t,
         leg_contact, action, disp) = tensors[:13]
        state = ll.LunarLanderState(pos, vel, angle, omega, terrain, shaping, sleep_time,
                                    wind_idx, torque_idx, leg_contact, t)
        r = self.env.step_from_plain(self.params, state, action, disp)
        s = r.state
        for out, x in zip(tensors[13:], (s.pos, s.vel, s.angle, s.omega, s.prev_shaping,
                                         s.sleep_time, s.wind_idx, s.torque_idx, s.t,
                                         s.leg_contact, r.obs, r.reward, r.terminated,
                                         r.truncated)):
            if out is not x:
                out.copy_(x)

    def lander_reset_launch(self, tensors, scalars):
        draws = ll.ResetDraws(*tensors[:4])
        s, obs = self.env.reset_from_plain(self.params, draws)
        for out, x in zip(tensors[4:], (s.pos, s.vel, s.angle, s.omega, s.terrain,
                                        s.prev_shaping, s.sleep_time, s.wind_idx,
                                        s.torque_idx, s.leg_contact, s.t, obs)):
            out.copy_(x)

    def launch(self, fn, tensors, scalars, device, what):
        def run():
            self.ran.append(what)
            fn(tensors, scalars)

        if TapeGraph.capturing is None:
            run()
        else:
            TapeGraph.capturing.tape.append(run)


def _writes(func, args, kwargs) -> list[torch.Tensor]:
    """The tensors an aten op writes in place."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            x = args[i] if i < len(args) else kwargs.get(a.name)
            out.extend(x if isinstance(x, (list, tuple)) else [x])
    return [x for x in out if isinstance(x, torch.Tensor)]


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        g = self.graph
        if func in HOST_SYNC:
            raise RuntimeError("operation not permitted when stream is capturing")
        gen = kwargs.get("generator")  # rewrapped by the dispatcher: known by its state
        if gen is not None and not any(torch.equal(gen.get_state(), r.get_state())
                                       for r in g.generators):
            raise RuntimeError("a generator not registered with the graph draws in a capture")
        for x in _writes(func, args, kwargs):
            if x.untyped_storage().data_ptr() not in g.made:
                g.undo.append((x, x.clone()))
        out = func(*args, **kwargs)
        fresh = [x for x, r in zip(tree_flatten(out)[0], func._schema.returns)
                 if isinstance(x, torch.Tensor) and r.alias_info is None]
        g.made.update(x.untyped_storage().data_ptr() for x in fresh)
        g.tape.append((func, args, kwargs, out))
        return out


class TapeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU (module docstring)."""

    capturing: "TapeGraph | None" = None
    made_graphs: list = []

    def __init__(self):
        self.tape, self.generators, self.undo, self.made = [], [], [], set()
        self.replays = 0
        TapeGraph.made_graphs.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def capture_begin(self):
        self.states = [g.get_state() for g in self.generators]
        self.mode = _Recorder(self)
        self.mode.__enter__()
        TapeGraph.capturing = self

    def capture_end(self):
        TapeGraph.capturing = None
        self.mode.__exit__(None, None, None)
        for x, was in reversed(self.undo):
            x.copy_(was)
        for g, state in zip(self.generators, self.states):
            g.set_state(state)

    def replay(self):
        for entry in self.tape:
            if callable(entry):
                entry()
                continue
            func, args, kwargs, out = entry
            got = func(*args, **kwargs)
            if _writes(func, args, kwargs) or any(r.alias_info for r in func._schema.returns):
                continue  # in place, or a view of a tensor the tape keeps
            for o, x in zip(tree_flatten(out)[0], tree_flatten(got)[0]):
                o.copy_(x)
        self.replays += 1


class EagerSweep:
    """Stands in for ``SweepGraph`` where the trainer's route is forced on
    the CPU: the eager sweep (the CPU's clip + Adam steps no step terms)."""

    def __init__(self, device, steps):
        pass

    def run(self, net, opt, body, inputs):
        return body(inputs)


@pytest.fixture
def lib(monkeypatch):
    fake = Lib()
    monkeypatch.setattr(ll, "_on_card", lambda x: True)
    monkeypatch.setattr(kl, "_check_device", lambda x, what: None)
    monkeypatch.setattr(kl, "_library", lambda: fake)
    monkeypatch.setattr(kl, "_launch", fake.launch)
    monkeypatch.setattr(TapeGraph, "capturing", None)
    monkeypatch.setattr(TapeGraph, "made_graphs", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", TapeGraph)
    monkeypatch.setattr(base, "SweepGraph", EagerSweep)
    return fake


# The two trainers that take the route: each one's config, its carry's fields
# in the train state, its update (the method handed the packed rows, and where
# the permutations sit among its other arguments) and its cases, the first the
# default.
KINDS = {
    "ppo": (PPOTrainer, PPOConfig, dict(minibatch_size=32, num_epochs=1, hidden_dim=16),
            ("vec_state", "obs_rms"), ("_sgd", 0)),
    "lstm": (PPOLSTMTrainer, PPOLSTMConfig,
             dict(num_envs=4, rollout_steps=8, seq_len=4, seq_minibatch=4, num_epochs=1,
                  mhc_dim=16, rnn_hidden=16, rnd_embed=32, flat_optimizer=True),
             ("vec_state", "hidden"), ("_epochs", 1)),
}
CASES = {
    "ppo": {"lander": dict(num_envs=8, rollout_steps=24),
            "cartpole": dict(env_name="CartPole-v1", num_envs=8, rollout_steps=16)},
    "lstm": {"gru_mhc": dict(rnn_cell="gru", use_mhc=True),
             "lstm_pscn": dict(rnn_cell="lstm", use_mhc=False, env_name="CartPole-v1",
                               rollout_steps=16)},
}
PAIRS = [(kind, case) for kind in KINDS for case in CASES[kind]]


def _trainer(kind, case=None, graphed=False, **kw):
    cls, cfg_cls, small, _, _ = KINDS[kind]
    case = case or next(iter(CASES[kind]))
    trainer = cls(cfg_cls(**{**small, **CASES[kind][case], **kw}), device="cpu")
    trainer.kind = kind
    if graphed:
        trainer._graphed = lambda: True  # the CUDA route, on the CPU's tensors
    return trainer


def _carry_of(trainer, ts) -> tuple:
    return tuple(getattr(ts, f) for f in KINDS[trainer.kind][3])


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
        carry, roll, stats = trainer._collect(ts)
        ts = ts._replace(**dict(zip(KINDS[trainer.kind][3], carry)))
        got.append({"roll": [x.clone() for x in roll], "stats": [x.clone() for x in stats],
                    "carry": [x.clone() for x in _leaves(carry)],
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
class OneRankMesh:
    data_size = model_size = 1
    data_rank = model_rank = 0


class ReplayedNoise(Noise):
    """A noise source that is not a plain ``Noise`` (a test's replay of the
    JAX keys is another class)."""


class Holder:
    """Stands in for ``RolloutGraph``: records what it is made and run with,
    and runs the body eagerly."""

    made: list = []
    runs: list = []

    def __init__(self, device):
        Holder.made.append(device)

    def run(self, net, noise, carry, body):
        Holder.runs.append((net, noise, carry))
        return body(carry)


@pytest.fixture
def holder(monkeypatch):
    monkeypatch.setattr(Holder, "made", [])
    monkeypatch.setattr(Holder, "runs", [])
    monkeypatch.setattr(base, "RolloutGraph", Holder)
    scans = []
    scan = base.rollout_scan
    monkeypatch.setattr(base, "rollout_scan", lambda *a, **k: scans.append(a) or scan(*a, **k))
    return scans


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case,graphed", [
    ("cuda", True), ("cpu", False), ("mesh", False), ("graphs_off", False),
    ("replayed_noise", False), ("sharded_noise", False)])
def test_only_a_cuda_trainer_without_a_mesh_with_plain_noise_takes_the_graph(
        holder, kind, case, graphed):
    trainer = _trainer(kind)
    ts = trainer.init(0)
    if case != "cpu":
        trainer.device = torch.device("cuda")  # only the route reads it here
    trainer.graphs = case != "graphs_off"
    trainer.mesh = OneRankMesh() if case == "mesh" else None
    if case == "replayed_noise":
        ts = ts._replace(noise=ReplayedNoise("cpu", 0))
    if case == "sharded_noise":
        ts = ts._replace(noise=ShardedNoise(ts.noise, 0, 1))
    trainer._collect(ts)
    assert len(Holder.made) == int(graphed) and len(holder) == 1
    assert (trainer.rollout_graph is not None) is graphed
    for net, noise, carry in Holder.runs:
        assert net is ts.params and noise is ts.noise
        assert all(a is b for a, b in zip(carry, _carry_of(trainer, ts)))


@pytest.mark.parametrize("cls,cfg", [
    (PPOFullTrainer, PPOFullConfig(num_envs=4, rollout_steps=8, minibatch_size=16, mhc_dim=16)),
    (PPORNNTrainer, PPORNNConfig(num_envs=4, rollout_steps=8, seq_len=4, feature_dim=16)),
    (PPGTrainer, PPGConfig(num_envs=4, rollout_steps=8, seq_len=4, feature_dim=16))],
    ids=["ppo_full", "ppo_rnn", "ppg"])
def test_the_other_ppo_trainers_scan_eagerly_on_the_card_too(holder, monkeypatch, cls, cfg):
    trainer = cls(cfg, device="cpu")
    ts = trainer.init(0)
    trainer.device = torch.device("cuda")  # what the graph route would read
    assert trainer._graphed()
    module = sys.modules[cls._collect.__module__]
    monkeypatch.setattr(module, "rollout_scan", base.rollout_scan)  # the counting one
    trainer._collect(ts)
    assert Holder.made == [] and len(holder) == 1
    assert not hasattr(trainer, "rollout_graph")


# -- (b) the holder against the eager rollout ----------------------------------------------
@pytest.mark.parametrize("kind,case", PAIRS)
def test_warm_up_capture_and_replays_leave_what_eager_rollouts_leave(lib, kind, case):
    iters = 4  # the warm-up, the capture with its replay, two more replays
    eager = _trainer(kind, case)
    _, want = _collects(eager, eager.init(7), iters)
    ran_eager = list(lib.ran)
    lib.ran.clear()

    trainer = _trainer(kind, case, graphed=True)
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
    assert all(a is b for a, b in zip(_leaves(_carry_of(trainer, ts)), holder.static))
    if case == "lstm_pscn":  # episodes ended, so the graph reset hiddens at done
        assert any(bool(r["stats"][2].any()) for r in rest)


@pytest.mark.parametrize("kind,case", PAIRS)
def test_graphed_train_iters_equal_the_eager_ones(lib, monkeypatch, kind, case):
    states, rows, outs = [], [], []
    for graphed in (False, True):
        trainer = _trainer(kind, case, graphed)
        name, perms_at = KINDS[kind][4]
        update, seen = getattr(trainer, name), []
        monkeypatch.setattr(trainer, name, lambda t, packed, *rest: seen.append(
            (packed.clone(), rest[perms_at].clone())) or update(t, packed, *rest))
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
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_restored_state_is_copied_in_and_new_params_or_noise_capture_again(
        lib, tmp_path, kind):
    path = str(tmp_path / "ckpt.pt")
    runs = {}
    for graphed in (False, True):
        trainer = _trainer(kind, graphed=graphed)
        ts = trainer.init(0)
        ts, _ = _collects(trainer, ts, 2)
        save_checkpoint(path, ts)
        ts, _ = _collects(trainer, ts, 1)
        # into the same state: params and the generator loaded in place, the carry new
        ts, into_same = _collects(trainer, restore_checkpoint(path, ts), 2)
        holder = trainer.rollout_graph
        counts = [(holder.captures, holder.replays)] if graphed else []
        # an external reset of the env batch
        ts = ts._replace(vec_state=trainer.venv.reset(ts.noise))
        ts, reset = _collects(trainer, ts, 1)
        # other params alone, then another generator alone
        fresh = trainer.init(1)
        ts, new_params = _collects(trainer, ts._replace(params=fresh.params,
                                                        opt_state=fresh.opt_state), 1)
        ts, new_noise = _collects(trainer, ts._replace(noise=Noise("cpu", 5)), 1)
        # into a fresh state: new params and a new generator
        ts, into_fresh = _collects(trainer, restore_checkpoint(path, trainer.init(2)), 2)
        if graphed:
            counts.append((holder.captures, holder.replays))
        runs[graphed] = (into_same + reset + new_params + new_noise + into_fresh, counts)
    _assert_same_runs(runs[True][0], runs[False][0])
    assert runs[True][1] == [(1, 4), (4, 9)]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_capture_that_fails_raises_and_keeps_no_graph(lib, monkeypatch, kind):
    trainer = _trainer(kind, graphed=True)
    ts = trainer.init(0)
    ts, _ = _collects(trainer, ts, 1)
    before = dict(kernels.LAUNCHES)
    generator = ts.noise.generator.get_state()
    step = trainer.venv.step
    monkeypatch.setattr(trainer.venv, "step", lambda state, action, noise: step(
        state, action + int(action.sum()) * 0, noise))  # a host sync
    with pytest.raises(RuntimeError, match="capturing"):
        trainer._collect(ts)
    holder = trainer.rollout_graph
    assert holder.graph is None and (holder.captures, holder.replays) == (0, 0)
    assert dict(kernels.LAUNCHES) == before
    assert torch.equal(ts.noise.generator.get_state(), generator)


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
        trainer = _trainer("lstm", graphed=graphed)
        if plant:
            _no_rnd_reward(trainer)
        _, runs[name] = _collects(trainer, trainer.init(5), iters)
    _assert_same_runs(runs["graph"], runs["eager"])
    # the replays' rewards are the replacement's: without the RND bonus
    reward = LSTMRollout._fields.index("reward")
    for graph, sound in zip(runs["graph"][1:], runs["sound"][1:]):
        assert not torch.equal(graph["roll"][reward], sound["roll"][reward])


# -- (e) the statistics handed out ---------------------------------------------------------
@pytest.mark.parametrize("kind,case", [("ppo", "cartpole"), ("lstm", "lstm_pscn")])
def test_iter_out_statistics_survive_the_next_iteration(lib, kind, case):
    trainer = _trainer(kind, case, graphed=True)
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
