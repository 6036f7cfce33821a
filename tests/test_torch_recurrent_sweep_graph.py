"""The recurrent full-tricks PPO's epoch × minibatch sweep as one replay of a
captured CUDA graph (``PPOLSTMTrainer._sgd``, ``algos.base.SweepGraph``),
its Adam on ``clip_adam`` after the plain clip
(``base.clip_adam_plain_norm_``), held on the CPU against the eager sweep,
which the lockstep tests hold to the JAX package.

A CUDA graph runs only on the card; ``chip_smoke.py`` phase 20 holds the
captured sweep there against the eager one, to the bit. Here (no card, no
nvcc) the kernels' library and ``torch.cuda.CUDAGraph`` are stood in for:
``Lib`` and ``FakeGraph`` of ``test_torch_sgd_graph.py`` (a capture records
the stand-in library's launches and runs none), and ``TapeGraph`` of
``test_torch_rollout_graph.py`` (a capture records every aten op and a
replay runs them again on the same tensors, so a value captured as a
Python scalar stays the capture's, as on the card):
  * (a) the route: only ``PPOLSTMTrainer`` on a CUDA device without a mesh,
    with ``graphs`` on, makes a ``SweepGraph``, of the CLI's 16 steps;
    ``graphs`` off, a one-rank mesh, the CPU, and recurrent PPO, PPG and
    ppo_full sweep eagerly; ``grad_step`` steps Adam through
    ``clip_adam_plain_norm_``;
  * (b) warm-up, capture and replays leave Adam's step counts and
    ``kernels.LAUNCHES`` where eager sweeps leave them; the capture takes
    exactly 16 step-term pairs, one a grad step;
  * (c) a replay reads the current iteration's entropy coefficient and lr:
    the graph's inputs and step terms hold them, and replayed ``train_iter``s
    equal the eager ones to the bit while both anneal; the metrics come back
    under the names the loss gives them;
  * (d) a CPU ``train_iter`` never makes a graph and gives the same bits
    with ``graphs`` on and off;
  * (e) a restore captures anew and keeps counting.
"""

import copy

import numpy as np
import pytest
import torch
from test_torch_rollout_graph import TapeGraph
from test_torch_sgd_graph import FakeGraph, OneRankMesh, graphs, lib  # noqa: F401 (fixtures)

from gymrl_tpu_torch import kernels
from gymrl_tpu_torch.algos import base
from gymrl_tpu_torch.algos.ppg import PPGConfig, PPGTrainer
from gymrl_tpu_torch.algos.ppo_full import PPOFullConfig, PPOFullTrainer, annealed
from gymrl_tpu_torch.algos.ppo_lstm import PPOLSTMConfig, PPOLSTMTrainer
from gymrl_tpu_torch.algos.ppo_rnn import PPORNNConfig, PPORNNTrainer
from gymrl_tpu_torch.kernels import ppo as kp
from gymrl_tpu_torch.utils.checkpoint import (
    flat_state, restore_checkpoint, save_checkpoint, state_tree,
)

torch.set_num_threads(1)

# 16 chunks of 4 steps, 4 minibatches of 4 chunks, 4 epochs: the CLI's 16 grad steps
SMALL = dict(num_envs=4, rollout_steps=16, seq_len=4, seq_minibatch=4, num_epochs=4,
             mhc_dim=16, rnn_hidden=16, rnd_embed=32, flat_optimizer=True)
STEPS = 16


class EagerRollout:
    """Stands in for ``RolloutGraph``: the rollout runs eagerly, so only the
    sweep takes a graph."""

    def __init__(self, device):
        pass

    def run(self, net, noise, carry, body):
        return body(carry)


def _trainer(graphed: bool, **kw) -> PPOLSTMTrainer:
    trainer = PPOLSTMTrainer(PPOLSTMConfig(**{**SMALL, **kw}), device="cpu")
    if graphed:
        trainer._graphed = lambda: True  # the CUDA route, on the CPU's tensors
    return trainer


def _steps(opt) -> set[float]:
    return {float(s["step"]) for s in opt.state.values()}


def _equal_states(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]), k


def card_clip_adam_plain_norm_(opt, grads, max_norm):
    """``clip_adam_plain_norm_``'s branch for the card, on the CPU's
    tensors: the plain clip, then the stand-in library's ``clip_adam`` with
    zero squares."""
    base.clip_grads_by_global_norm_(grads, max_norm)
    kp.clip_adam(opt, grads, grads[0].new_zeros(len(grads)), max_norm)


@pytest.fixture
def card(monkeypatch, lib, graphs):
    monkeypatch.setattr(base, "clip_adam_plain_norm_", card_clip_adam_plain_norm_)
    monkeypatch.setattr(base, "RolloutGraph", EagerRollout)
    return lib


# -- (a) the route -------------------------------------------------------------------------
@pytest.mark.parametrize("case,graphed", [("cuda", True), ("graphs_off", False),
                                          ("mesh", False), ("cpu", False)])
def test_only_ppo_lstm_on_a_cuda_device_without_a_mesh_takes_the_graph(
        monkeypatch, case, graphed):
    trainer = PPOLSTMTrainer(PPOLSTMConfig(), device="cpu")  # the CLI's schedule
    ts = trainer.init(0)
    made, runs, swept = [], [], []
    means = {"policy_loss": torch.zeros(())}  # what the sweep or its replay hands back

    class Holder:
        def __init__(self, device, steps):
            made.append((device, steps))

        def run(self, net, opt, body, inputs):
            runs.append((net, opt, inputs))
            return means

    monkeypatch.setattr(base, "SweepGraph", Holder)
    monkeypatch.setattr(trainer, "_epochs", lambda *a: swept.append(a) or means)
    full, placed = torch.full, []  # the buffer is made on the CPU, where it was asked for
    monkeypatch.setattr(torch, "full", lambda *a, device=None, **kw: placed.append(device)
                        or full(*a, **kw))
    if case != "cpu":
        trainer.device = torch.device("cuda")  # only the route reads it here
    trainer.graphs = case != "graphs_off"
    trainer.mesh = OneRankMesh() if case == "mesh" else None
    cfg = trainer.cfg
    packed = torch.zeros(cfg.seqs_per_rollout, 3)
    perms = torch.zeros(cfg.num_epochs, cfg.seqs_per_rollout, dtype=torch.int64)
    coef = float(np.float32(0.0125))  # as ``annealed`` rounds it
    metrics = trainer._sgd(ts, packed, {}, perms, coef)
    assert trainer._graphed() is graphed
    assert (len(made), len(swept)) == ((1, 0) if graphed else (0, 1))
    assert metrics is means and placed == [trainer.device]
    if graphed:
        assert made == [(torch.device("cuda"), STEPS)] == [(trainer.device, 4 * 4)]
        (net, opt, inputs), = runs
        assert net is ts.params and opt is ts.opt_state
        assert inputs["packed"] is packed and inputs["perms"] is perms
        held = inputs["ent_coef"]
        assert held.dtype == torch.float32 and held.shape == () and float(held) == coef
    else:
        assert trainer.sweep_graph is None


@pytest.mark.parametrize("cls,cfg", [
    (PPOFullTrainer, PPOFullConfig(num_envs=4, rollout_steps=8, minibatch_size=16, mhc_dim=16)),
    (PPORNNTrainer, PPORNNConfig(num_envs=4, rollout_steps=8, seq_len=4, feature_dim=16)),
    (PPGTrainer, PPGConfig(num_envs=4, rollout_steps=8, seq_len=4, feature_dim=16,
                           aux_every=1))],
    ids=["ppo_full", "ppo_rnn", "ppg"])
def test_the_other_ppo_trainers_sweep_eagerly_on_the_card_too(monkeypatch, cls, cfg):
    made = []
    monkeypatch.setattr(base, "SweepGraph", lambda *a: made.append(a))
    trainer = cls(cfg, device="cpu")
    trainer._graphed = lambda: True  # what the card's route would read
    ts = trainer.init(0)
    before = _steps(ts.opt_state)
    trainer.train_iter(ts)
    assert made == [] and _steps(ts.opt_state) != before
    assert getattr(trainer, "sweep_graph", None) is None


def test_grad_step_steps_adam_through_clip_adam_(monkeypatch):
    calls = []
    step = base.clip_adam_plain_norm_
    monkeypatch.setattr(base, "clip_adam_plain_norm_", lambda opt, grads, max_norm, *rest:
                        calls.append((opt, len(grads), max_norm, rest))
                        or step(opt, grads, max_norm, *rest))
    trainer = _trainer(False)
    ts = trainer.init(0)
    trainer.train_iter(ts)
    n = len(list(ts.params.parameters()))
    assert calls == [(ts.opt_state, n, trainer.cfg.max_grad_norm, ())] * STEPS
    assert _steps(ts.opt_state) == {float(STEPS)}


def test_the_card_clips_as_the_plain_path_then_steps_adam_in_the_kernel_unclipped(monkeypatch):
    calls = []
    monkeypatch.setattr(base, "clip_grads_by_global_norm_",
                        lambda grads, max_norm: calls.append(("clip", grads, max_norm)))
    monkeypatch.setattr(base, "clip_adam_plain_", lambda *a: calls.append(("plain",)))
    monkeypatch.setattr(kp, "grad_sq_norms", lambda grads: calls.append(("sq",)))
    monkeypatch.setattr(kp, "clip_adam", lambda opt, grads, sq, max_norm: calls.append(
        ("adam", opt, grads, sq, max_norm)))
    meta = torch.device("meta")  # not the CPU: the dispatch takes the kernel
    grads, opt = [torch.zeros(3, device=meta), torch.zeros(2, device=meta)], object()
    base.clip_adam_plain_norm_(opt, grads, 0.5)
    (clip, clipped, bound), (adam, stepped, read, sq, max_norm) = calls
    assert (clip, adam) == ("clip", "adam") and clipped is read is grads
    assert stepped is opt and bound == max_norm == 0.5
    assert sq.shape == (2,) and sq.device == meta and sq.dtype == torch.float32


@pytest.mark.parametrize("foreach", [True, False])
def test_on_the_cpu_it_is_the_plain_update_to_the_bit(foreach):
    runs, net0 = [], torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3))
    for step in (base.clip_adam_plain_norm_, base.clip_adam_plain_):
        net = copy.deepcopy(net0)
        opt = base.adam(list(net.parameters()), 3e-4, 1e-5, foreach=foreach)
        gen = torch.Generator().manual_seed(3)
        for scale in (10.0, 0.01, 10.0):  # the clip on, off, on
            grads = [scale * torch.randn(p.shape, generator=gen) for p in net.parameters()]
            for p, g in zip(net.parameters(), grads):
                p.grad = g
            step(opt, grads, 0.5)
        runs.append([x.detach().clone() for p in net.parameters()
                     for x in (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# -- (b) the holder's bookkeeping on the stand-in library ----------------------------------
def _launches_of(trainer, iters: int, seed: int = 0):
    ts = trainer.init(seed)
    before = dict(kernels.LAUNCHES)
    for _ in range(iters):
        ts, _ = trainer.train_iter(ts)
    return ts, {k: kernels.LAUNCHES[k] - n for k, n in before.items()}


def test_warm_up_capture_and_replays_leave_what_eager_sweeps_leave(card):
    iters = 4  # the warm-up, the capture with its replay, two more replays
    eager_ts, eager_launches = _launches_of(_trainer(False), iters)
    eager_ran = list(card.ran)
    card.ran.clear()
    trainer = _trainer(True)
    ts, launches = _launches_of(trainer, iters)
    holder = trainer.sweep_graph
    assert (holder.captures, holder.replays, len(FakeGraph.made)) == (1, iters - 1, 1)
    assert holder.steps == STEPS
    assert _steps(ts.opt_state) == _steps(eager_ts.opt_state) == {float(iters * STEPS)}
    assert launches == eager_launches
    pieces = -(-len(list(ts.params.parameters())) // kp.MAX_TENSORS)
    assert launches["clip_adam"] == iters * STEPS * pieces
    assert launches["grad_sq_norms"] == 0  # the clip's norm is the plain path's
    assert launches["ppo_loss_fwd"] == launches["ppo_loss_bwd"] == 0
    assert [c[0] for c in card.ran] == [c[0] for c in eager_ran]
    # the capture: each grad step's launches take the next of 16 pairs on the card
    recorded = [c for c in FakeGraph.made[0].recorded if c[0] == "clip_adam"]
    ptr = holder.terms.data_ptr()
    assert [c[1] for c in recorded] == [ptr + 8 * (i // pieces) for i in range(STEPS * pieces)]
    assert [c[1] for c in eager_ran if c[0] == "clip_adam"] == [None] * (iters * STEPS * pieces)
    assert kp._RUN_TERMS is None


# -- (c) the coefficient and the lr a replay reads -----------------------------------------
def test_each_replay_reads_this_iterations_coefficient_and_lr(card):
    trainer = _trainer(True, max_train_steps=400)  # both anneal by a sixth an iteration
    ts = trainer.init(1)
    seen = []
    for _ in range(4):
        lr, ent_coef = annealed(trainer.cfg, ts.env_steps)
        start = _steps(ts.opt_state).pop()
        ts, out = trainer.train_iter(ts)
        holder = trainer.sweep_graph
        seen.append((float(holder.static["ent_coef"]), ent_coef, float(out.metrics["ent_coef"])))
        if not holder.replays:
            continue  # the warm-up: eager, its terms the host's
        # the rows the replay's launches read: steps start+1 .. start+16 at this lr
        opt = base.adam([torch.nn.Parameter(torch.zeros(1))], lr, trainer.cfg.adam_eps,
                        foreach=True)
        next(iter(opt.state.values()))["step"].fill_(start)
        want, _ = kp.adam_run_terms(opt, STEPS)
        np.testing.assert_array_equal(holder.terms.numpy(), want)
    assert all(a == b == c for a, b, c in seen)
    assert len({b for _, b, _ in seen}) == 4


def graph_safe_clip_adam_(opt, grads, max_norm):
    """Stands in for the card's clip and Adam in ops a ``TapeGraph`` records:
    the pair of step terms is the host's on the eager route (the step
    counted there, as ``_AdamTable.count_step``) and, under
    ``kernels.ppo.device_terms``, the run's next row on the device."""
    run = kp._RUN_TERMS
    if run is None:
        pairs, count = kp.adam_run_terms(opt, 1)
        for state in opt.state.values():
            state["step"].fill_(count)
        pair = torch.from_numpy(pairs[0])
    else:
        run.next_pair(grads[0].device)
        pair = run.terms[run.taken - 1]
    group = opt.param_groups[0]
    beta1, beta2 = group["betas"]
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for p, g in zip(group["params"], grads):
        state = opt.state[p]
        g = g * scale
        state["exp_avg"].lerp_(g, 1 - beta1)
        state["exp_avg_sq"].mul_(beta2).addcmul_(g, g, value=1 - beta2)
        denom = state["exp_avg_sq"].sqrt() / pair[1] + group["eps"]
        p.detach().add_(pair[0] * state["exp_avg"] / denom)


class SweepTape(TapeGraph):
    """``TapeGraph`` whose replay runs its recording below autograd, as a
    CUDA graph's kernels run: the sweep's forward and backward ops, recorded
    with autograd on, are run again as plain ops on the same tensors. The
    profiler's range ops the recording holds launch nothing and are left out."""

    def capture_end(self):
        super().capture_end()
        self.tape = [e for e in self.tape if callable(e) or e[0].namespace != "profiler"]

    def replay(self):
        with torch._C._AutoDispatchBelowAutograd():
            super().replay()


@pytest.fixture
def tape(monkeypatch):
    monkeypatch.setattr(TapeGraph, "capturing", None)
    monkeypatch.setattr(TapeGraph, "made_graphs", [])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", SweepTape)
    monkeypatch.setattr(base, "RolloutGraph", EagerRollout)
    monkeypatch.setattr(base, "clip_adam_plain_norm_", graph_safe_clip_adam_)
    return TapeGraph


def test_replayed_train_iters_equal_the_eager_ones_while_both_anneal(tape):
    runs = {}
    for graphed in (False, True):
        trainer = _trainer(graphed, num_epochs=1, max_train_steps=400)
        ts = trainer.init(2)
        metrics = []
        for _ in range(4):
            ts, out = trainer.train_iter(ts)
            metrics.append({k: v.clone() for k, v in out.metrics.items()})
        if graphed:
            holder = trainer.sweep_graph
            assert (holder.captures, holder.replays, len(tape.made_graphs)) == (1, 3, 1)
        runs[graphed] = (flat_state(state_tree(ts)), metrics)
    _equal_states(runs[True][0], runs[False][0])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(runs[True][1], runs[False][1]) for k in a)
    assert len({float(m["ent_coef"]) for m in runs[True][1]}) == 4


def test_a_metric_the_loss_gains_comes_back_from_every_replay(tape):
    """The replay hands back the metrics under the names the captured sweep
    gave them: a metric added to ``_loss`` is in every iteration's metrics,
    equal to the eager route's."""
    runs = {}
    for graphed in (False, True):
        trainer = _trainer(graphed, num_epochs=1)
        loss = trainer._loss

        def with_total(net, mb, ent_coef, loss=loss):
            total, metrics = loss(net, mb, ent_coef)
            return total, {**metrics, "total_loss": total.detach()}

        trainer._loss = with_total
        ts = trainer.init(4)
        metrics = []
        for _ in range(3):
            ts, out = trainer.train_iter(ts)
            metrics.append({k: v.clone() for k, v in out.metrics.items()})
        runs[graphed] = metrics
    assert trainer.sweep_graph.replays == 2
    for a, b in zip(runs[True], runs[False]):
        assert "total_loss" in a and a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_coefficient_baked_into_the_capture_would_show(tape, monkeypatch):
    """The tape replays a Python scalar as it was captured, as a CUDA graph
    does: a loss handed the iteration's float in place of the buffer parts
    from the eager run once the coefficient moves."""
    runs = {}
    for graphed in (False, True):
        trainer = _trainer(graphed, num_epochs=1, max_train_steps=400)
        if graphed:
            loss, sgd = trainer._loss, trainer._sgd

            def baked(ts, packed, spec, perms, ent_coef, loss=loss, sgd=sgd, trainer=trainer):
                # the loss reads the iteration's float, not the buffer
                trainer._loss = lambda net, mb, _: loss(net, mb, ent_coef)
                return sgd(ts, packed, spec, perms, ent_coef)

            monkeypatch.setattr(trainer, "_sgd", baked)
        ts = trainer.init(2)
        for _ in range(3):
            ts, _ = trainer.train_iter(ts)
        runs[graphed] = [p.detach().clone() for p in ts.params.parameters()]
    assert not all(torch.equal(a, b) for a, b in zip(runs[True], runs[False]))


# -- (d) the CPU trainer -------------------------------------------------------------------
class NoGraph:
    def __init__(self, *args, **kw):
        raise AssertionError("a CUDA graph on the CPU")


def test_cpu_train_iter_never_makes_a_graph_and_gives_the_same_bits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    monkeypatch.setattr(torch.cuda, "Stream", NoGraph)
    monkeypatch.setattr(base, "SweepGraph", NoGraph)
    runs = []
    for on in (True, False):
        trainer = _trainer(False, num_epochs=1)
        trainer.graphs = on
        ts = trainer.init(3)
        metrics = []
        for _ in range(2):
            ts, out = trainer.train_iter(ts)
            metrics.append({k: v.clone() for k, v in out.metrics.items()})
        assert trainer.sweep_graph is None
        runs.append((flat_state(state_tree(ts)), metrics))
    (a, ma), (b, mb) = runs
    _equal_states(a, b)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x)


# -- (e) a restore ---------------------------------------------------------------------------
@pytest.mark.parametrize("into", ["same", "fresh"])
def test_a_restore_captures_anew_and_keeps_counting(card, tmp_path, into):
    path = str(tmp_path / "ckpt.pt")
    trainer = _trainer(True, num_epochs=1)
    steps = trainer.cfg.num_minibatches
    ts = trainer.init(0)
    for _ in range(3):
        ts, _ = trainer.train_iter(ts)
    holder = trainer.sweep_graph
    assert (holder.captures, holder.replays) == (1, 2)
    save_checkpoint(path, ts)
    ts = restore_checkpoint(path, ts if into == "same" else trainer.init(1))
    for _ in range(2):
        ts, _ = trainer.train_iter(ts)
    assert trainer.sweep_graph is holder
    assert (holder.captures, holder.replays, len(FakeGraph.made)) == (2, 4, 2)
    assert _steps(ts.opt_state) == {5.0 * steps}
    assert holder.key == base.graph_key(ts.params, ts.opt_state)[0]
