"""PPO's SGD sweep as one replay of a captured CUDA graph
(``algos.base.SweepGraph``), held on the CPU against the eager sweep, which
the lockstep tests hold to the JAX package.

A CUDA graph runs only on the card; ``chip_smoke.py`` phase 20 holds the
captured sweep there against the eager one, to the bit. Here (no card, no
nvcc) the kernels' library and ``torch.cuda.CUDAGraph`` are stood in for,
as ``test_torch_kernels_adam_lander_hopper.py`` stands in for the library:
  * (a) ``kernels.ppo.adam_run_terms`` gives, float for float, the step
    terms that K successive ``_AdamTable.count_step``s leave, with and
    without foreach, at the CLI's lr and an annealed one, from step 0 and
    from a restored 137;
  * (b) ``graph_key`` holds across a CPU trainer's iterations and changes
    after ``load_state_dict`` and ``restore_checkpoint``;
  * (c) warm-up, capture and one replay leave Adam's step counts and
    ``kernels.LAUNCHES`` where two eager sweeps leave them, the capture
    running nothing; a changed key captures again; a capture that fails, or
    steps Adam another number of times, raises;
  * (d) the library gets a null terms pointer on the eager route and the
    terms buffer's address plus 8 bytes per grad step on the graph's;
  * (e) a CPU ``train_iter`` never makes a ``CUDAGraph`` and gives the same
    bits with ``graphs`` on and off;
  * (f) the route: only a CUDA trainer without a mesh, with ``graphs`` on,
    takes the graph.
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos import base
from gymrl_tpu_torch.algos.base import SweepGraph, adam, graph_key
from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
from gymrl_tpu_torch.kernels import ppo as kp
from gymrl_tpu_torch.utils.checkpoint import (
    flat_state, restore_checkpoint, save_checkpoint, state_tree,
)

torch.set_num_threads(1)

F32 = np.float32


class Lib:
    """Stands in for the built library: each launch of ``grad_sq_norms`` and
    ``clip_adam`` is recorded as run, or, while a stand-in graph captures,
    into that graph, which runs it on replay. A ``clip_adam`` record keeps
    its step terms and device terms pointer."""

    def __init__(self):
        self.ran, self.capturing = [], None

    def _record(self, call):
        (self.ran if self.capturing is None else self.capturing).append(call)
        return 0

    def grad_sq_norms_launch(self, grads, numels, aligned, k, sq, partials, ticket, device,
                             stream):
        return self._record(("grad_sq_norms", None))

    def clip_adam_launch(self, params, grads, m, v, numels, step_sizes, bc2, device_terms,
                         aligned, k, sq, n_sq, max_norm, w, beta2, c2, eps, divide, device,
                         stream):
        pair = (list((ctypes.c_float * k).from_address(step_sizes))[0],
                list((ctypes.c_float * k).from_address(bc2))[0])
        return self._record(("clip_adam", device_terms, pair))


@pytest.fixture
def lib(monkeypatch):
    fake = Lib()
    monkeypatch.setattr(kp, "_library", lambda: fake)
    monkeypatch.setattr(kp, "_check_device", lambda x, what, plain: None)
    monkeypatch.setattr(kp, "_ADAM_TABLE", None)
    monkeypatch.setattr(kp, "_SQ_TABLE", None)
    monkeypatch.setattr(kp, "_TICKETS", {})
    monkeypatch.setattr(kp, "_launch", lambda fn, args, device, what: fn(*(
        a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), 0, 0))
    return fake


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: the capture records the
    stand-in library's launches and runs none; a replay runs them."""

    lib: Lib = None
    made: list = []
    fail_on_end = False

    def __init__(self):
        self.recorded = None
        FakeGraph.made.append(self)

    def capture_begin(self):
        self.lib.capturing = []

    def capture_end(self):
        self.recorded, self.lib.capturing = self.lib.capturing, None
        if FakeGraph.fail_on_end:
            raise RuntimeError("operation not permitted when stream is capturing")

    def replay(self):
        self.lib.ran.extend(self.recorded)


@pytest.fixture
def graphs(monkeypatch, lib):
    monkeypatch.setattr(FakeGraph, "lib", lib)
    monkeypatch.setattr(FakeGraph, "made", [])
    monkeypatch.setattr(FakeGraph, "fail_on_end", False)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    return FakeGraph


def _net_adam(foreach=True, seed=0):
    gen = torch.Generator().manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return net, adam(list(net.parameters()), 3e-4, 1e-5, foreach=foreach)


def _grads(net, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen) for p in net.parameters()]


def _steps(opt) -> set[float]:
    return {float(s["step"]) for s in opt.state.values()}


def _restored_at(opt, step: float):
    sd = copy.deepcopy(opt.state_dict())
    for s in sd["state"].values():
        s["step"] = torch.tensor(step)
    opt.load_state_dict(sd)


# -- (a) the step terms of a run ------------------------------------------------------------
ANNEALED_LR = float(F32(3e-4) * max(F32(1.0) - F32(413_696) / F32(1_000_000), F32(0.0)))


@pytest.mark.parametrize("foreach", [True, False], ids=["foreach", "per_tensor"])
@pytest.mark.parametrize("start", [0.0, 137.0], ids=["fresh", "restored"])
@pytest.mark.parametrize("lr", [3e-4, ANNEALED_LR], ids=["cli_lr", "annealed"])
def test_run_terms_are_what_successive_count_steps_leave(lib, foreach, start, lr):
    net, opt = _net_adam(foreach)
    if start:
        _restored_at(opt, start)
    opt.param_groups[0]["lr"] = lr
    k = 40
    terms, count = kp.adam_run_terms(opt, k)
    assert terms.dtype == np.float32 and terms.shape == (k, 2)
    grads = _grads(net)
    for _ in range(k):
        kp.clip_adam(opt, grads, torch.ones(len(grads)), 0.5)
    left = np.array([pair for name, _, pair in lib.ran if name == "clip_adam"], dtype=np.float32)
    np.testing.assert_array_equal(terms.view(np.uint32), left.view(np.uint32))
    assert _steps(opt) == {count} == {start + k}


def test_run_terms_refuse_step_counts_that_differ(lib):
    net, opt = _net_adam()
    next(iter(opt.state.values()))["step"].fill_(3.0)
    with pytest.raises(ValueError, match="same step count"):
        kp.adam_run_terms(opt, 4)


# -- (b) the key ---------------------------------------------------------------------------
def _trainer(**kw):
    cfg = dict(num_envs=4, rollout_steps=8, minibatch_size=16, num_epochs=2, hidden_dim=16)
    return PPOTrainer(PPOConfig(**{**cfg, **kw}), device="cpu")


def test_graph_key_holds_across_iterations_and_changes_on_a_restore(tmp_path):
    trainer = _trainer()
    ts = trainer.init(0)
    key, held = graph_key(ts.params, ts.opt_state)  # held: no identity in a key is reused
    for _ in range(2):
        ts, _ = trainer.train_iter(ts)
        assert graph_key(ts.params, ts.opt_state)[0] == key
    ts.opt_state.load_state_dict(copy.deepcopy(ts.opt_state.state_dict()))
    loaded, held_too = graph_key(ts.params, ts.opt_state)
    assert loaded != key
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, ts)
    restored = restore_checkpoint(path, ts)  # into the same state: Adam's is replaced
    assert graph_key(restored.params, restored.opt_state)[0] not in (key, loaded)
    fresh = restore_checkpoint(path, trainer.init(1))
    assert graph_key(fresh.params, fresh.opt_state)[0] not in (key, loaded)


# -- (c), (d) the holder -------------------------------------------------------------------
K = 6  # grad steps of the stand-in sweep


def _body(net, opt, grads, steps=K):
    """A sweep of ``steps`` grad steps on the stand-in library: the squares,
    then clip + Adam; the "metrics" the static rows' sum."""

    def body(static):
        for _ in range(steps):
            sq = kp.grad_sq_norms(grads)
            kp.clip_adam(opt, grads, sq, 0.5)
        return static["rows"].sum(dim=0)

    return body


def _eager_sweeps(lib, n):
    net, opt = _net_adam()
    grads = _grads(net)
    before = dict(kernels.LAUNCHES)
    rows = torch.arange(12.0).reshape(4, 3)
    for _ in range(n):
        out = _body(net, opt, grads)({"rows": rows})
    return opt, {k: kernels.LAUNCHES[k] - before[k] for k in before}, list(lib.ran), out


def test_warm_up_capture_and_replay_leave_what_two_eager_sweeps_leave(lib, graphs):
    want_opt, want_launches, want_ran, want_out = _eager_sweeps(lib, 2)
    lib.ran.clear()
    net, opt = _net_adam()
    grads = _grads(net)
    body = _body(net, opt, grads)
    holder = SweepGraph(torch.device("cpu"), K)
    rows = torch.arange(12.0).reshape(4, 3)
    before = dict(kernels.LAUNCHES)

    holder.run(net, opt, body, {"rows": rows})  # the warm-up: eager
    assert (holder.captures, holder.replays, graphs.made) == (0, 0, [])
    assert _steps(opt) == {float(K)} and len(lib.ran) == 2 * K
    out = holder.run(net, opt, body, {"rows": rows})  # capture, then one replay
    assert (holder.captures, holder.replays, len(graphs.made)) == (1, 1, 1)
    assert len(graphs.made[0].recorded) == 2 * K  # captured, and run once, by the replay
    assert _steps(opt) == _steps(want_opt) == {2.0 * K}
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == want_launches
    assert want_launches["clip_adam"] == want_launches["grad_sq_norms"] == 2 * K
    assert [c[0] for c in lib.ran] == [c[0] for c in want_ran]
    assert torch.equal(out, want_out) and out is not holder.out  # a copy of the graph's
    # the grads the capture left (the last step's, as after the eager sweep)
    assert all(p.grad is g for p, g in zip(net.parameters(), holder.grads))


def test_eager_route_passes_null_terms_and_the_graph_each_steps_pair(lib, graphs):
    net, opt = _net_adam()
    holder = SweepGraph(torch.device("cpu"), K)
    body = _body(net, opt, _grads(net))
    rows = {"rows": torch.zeros(2, 3)}
    holder.run(net, opt, body, rows)
    eager = [c for c in lib.ran if c[0] == "clip_adam"]
    assert [c[1] for c in eager] == [None] * K
    holder.run(net, opt, body, rows)
    base_ptr = holder.terms.data_ptr()
    captured = [c for c in graphs.made[0].recorded if c[0] == "clip_adam"]
    assert [c[1] for c in captured] == [base_ptr + 8 * i for i in range(K)]
    # the rows the replay's launches read: steps K+1 .. 2K at the group's lr
    want, _ = kp.adam_run_terms(_restored(opt, float(K)), K)
    np.testing.assert_array_equal(holder.terms.numpy(), want)


def _restored(opt, step):
    twin = adam([torch.nn.Parameter(p.detach().clone()) for p in opt.param_groups[0]["params"]],
                opt.param_groups[0]["lr"], opt.param_groups[0]["eps"],
                foreach=opt.param_groups[0]["foreach"])
    for s in twin.state.values():
        s["step"].fill_(step)
    return twin


def test_a_changed_key_captures_again_and_keeps_counting(lib, graphs):
    net, opt = _net_adam()
    holder = SweepGraph(torch.device("cpu"), K)
    rows = {"rows": torch.zeros(2, 3)}
    grads = _grads(net)
    for _ in range(3):
        holder.run(net, opt, _body(net, opt, grads), rows)
    assert (holder.captures, holder.replays) == (1, 2)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # as restore_checkpoint does
    holder.run(net, opt, _body(net, opt, grads), rows)
    assert (holder.captures, holder.replays, len(graphs.made)) == (2, 3, 2)
    assert _steps(opt) == {4.0 * K}
    holder.run(net, opt, _body(net, opt, grads), {"rows": torch.zeros(3, 3)})  # a new buffer
    assert (holder.captures, holder.replays) == (3, 4)


def test_a_failed_capture_raises_and_takes_its_launches_back(lib, graphs):
    net, opt = _net_adam()
    holder = SweepGraph(torch.device("cpu"), K)
    rows = {"rows": torch.zeros(2, 3)}
    holder.run(net, opt, _body(net, opt, _grads(net)), rows)
    before = dict(kernels.LAUNCHES)
    graphs.fail_on_end = True
    with pytest.raises(RuntimeError, match="capturing"):
        holder.run(net, opt, _body(net, opt, _grads(net)), rows)
    assert dict(kernels.LAUNCHES) == before and holder.graph is None
    assert _steps(opt) == {float(K)}
    graphs.fail_on_end = False
    with pytest.raises(RuntimeError, match="stepped Adam 5 times"):
        holder.run(net, opt, _body(net, opt, _grads(net), steps=K - 1), rows)
    assert holder.graph is None and kp._RUN_TERMS is None
    with pytest.raises(ValueError, match="more than the 6 times"):
        holder.run(net, opt, _body(net, opt, _grads(net), steps=K + 1), rows)


def test_a_capture_collects_garbage_before_it_begins(monkeypatch, graphs):
    """On the card a graph that the collector frees during a capture ends
    it, so the holder collects first, as ``torch.cuda.graph`` does."""
    order = []
    monkeypatch.setattr(base.gc, "collect", lambda: order.append("collect"))
    begin = FakeGraph.capture_begin
    monkeypatch.setattr(FakeGraph, "capture_begin",
                        lambda self: order.append("begin") or begin(self))
    base.CapturedGraph(torch.device("cpu"))._record(lambda: order.append("body"))
    assert order == ["collect", "begin", "body"]


# -- (e) the CPU trainer -------------------------------------------------------------------
class NoGraph:
    def __init__(self, *args, **kw):
        raise AssertionError("a CUDA graph on the CPU")


def test_cpu_train_iter_never_makes_a_graph_and_gives_the_same_bits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    monkeypatch.setattr(torch.cuda, "Stream", NoGraph)
    monkeypatch.setattr(base, "SweepGraph", NoGraph)
    runs = []
    for on in (True, False):
        trainer = _trainer()
        trainer.graphs = on
        ts = trainer.init(3)
        metrics = []
        for _ in range(2):
            ts, out = trainer.train_iter(ts)
            metrics.append({k: v.clone() for k, v in out.metrics.items()})
        assert trainer.sweep_graph is None
        runs.append((flat_state(state_tree(ts)), metrics))
    (a, ma), (b, mb) = runs
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x)


# -- (f) the route -------------------------------------------------------------------------
class OneRankMesh:
    """Stands in for a ``Mesh`` of one data rank: every collective an identity."""

    data_size = model_size = 1
    data_rank = model_rank = 0

    def shard(self, x, axis=0, group="data"):
        return x

    def mean_(self, tensors):
        pass


@pytest.mark.parametrize("case,graphed", [("cuda", True), ("graphs_off", False),
                                          ("mesh", False), ("cpu", False)])
def test_only_a_cuda_trainer_without_a_mesh_takes_the_graph(monkeypatch, case, graphed):
    trainer = _trainer()
    ts = trainer.init(0)
    made, swept = [], []

    class Holder:
        def __init__(self, device, steps):
            made.append((device, steps))

        def run(self, net, opt, body, inputs):
            return torch.zeros(5)

    monkeypatch.setattr(base, "SweepGraph", Holder)
    monkeypatch.setattr(trainer, "_sweep", lambda *a: swept.append(a) or torch.zeros(5))
    if case != "cpu":
        trainer.device = torch.device("cuda")  # only the route reads it here
    trainer.graphs = case != "graphs_off"
    trainer.mesh = OneRankMesh() if case == "mesh" else None
    packed = torch.zeros(trainer.cfg.batch_total, trainer.obs_dim + 4)
    perms = torch.zeros(trainer.cfg.num_epochs, trainer.cfg.batch_total, dtype=torch.int64)
    metrics = trainer._sgd(ts, packed, perms)
    assert list(metrics) == list(kp.METRICS)
    assert trainer._graphed() is graphed
    assert (len(made), len(swept)) == ((1, 0) if graphed else (0, 1))
    if graphed:
        assert made[0][1] == trainer.cfg.num_epochs * trainer.cfg.num_minibatches


def test_the_mesh_route_trains_eagerly_on_a_world_of_one():
    """A trainer under a one-rank mesh runs the eager sweep, equal to the
    bit to the unsharded trainer's (``_graphed`` is False for it)."""
    states = []
    for mesh in (None, OneRankMesh()):
        trainer = _trainer()
        ts = trainer.init(5)
        trainer.mesh = mesh
        ts, _ = trainer.train_iter(ts)
        assert not trainer._graphed() and trainer.sweep_graph is None
        states.append([p.detach().clone() for p in ts.params.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*states))


def test_base_trainer_defaults_to_graphs_on():
    assert _trainer().graphs is True
    assert base.Trainer(PPOConfig(), device="cpu").graphs is True
