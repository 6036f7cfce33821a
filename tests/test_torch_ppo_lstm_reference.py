"""The benchmark's plain reference of gymRL's recurrent full-tricks PPO
(``portbench/reference/ppo_lstm.py``) against the port's CPU path at a small
size (mHC dim, GRU hidden and RND width 32; 4 envs × T 16 in 8-step chunks,
2 epochs), the reference's pieces against the port's modules, its imports,
and the files of its benchmark cell (``mhc_gru_lander64_t64_l8_e4``).

Tolerance: none. The reference computes each sum in the program's grouping
(the GRU's stacked maps, the branch pooling as a batched product, the clip's
norm over the same list of tensors), so on one device and thread count the
two agree to the bit; a gap of any size is a departure. Random weights: the
mHC fuses' ``w`` start at zero, which makes every sample's mixing map the
same symmetric matrix, which one Sinkhorn round already projects; the tests
draw ``w`` (and set ``alpha`` to one) from a seed on both sides, so the maps
differ per sample and the projection's rounds matter.
"""

import ast
import json
import os
import shutil
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
for _path in (ROOT, BENCH_DIR):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from benchlib import compare, files, harness, program  # noqa: E402

from gymrl_tpu_torch.algos.ppo_lstm import LSTMActorCritic  # noqa: E402
from gymrl_tpu_torch.nn import mhc as port_mhc  # noqa: E402

torch.set_num_threads(2)

CELL = "mhc_gru_lander64_t64_l8_e4"
CONF = files.config("ppo_lstm_lander_cli")
REF = files.module("reference", "ppo_lstm")
ENV = files.obj(CONF["reference_env"])
SETTINGS = program.trainer_class(CONF["config_class"])
SMALL = {"mhc_dim": 32, "rnn_hidden": 32, "rnd_embed": 32, "num_envs": 4, "rollout_steps": 16,
         "minibatch_size": 32, "num_epochs": 2}
CFG = {**files.run_config(files.cell(files.benchmark(), CELL)), **SMALL}
CPU = torch.device("cpu")
FORBIDDEN = {"jax", "jaxlib", "flax", "gymrl_tpu", "gymrl_tpu_torch"}
SEEDS = [3, 2**31 + 11]


def _random_weights(named: dict, seed: int) -> None:
    """Every mHC fuse's ``w`` drawn N(0, 0.1²) and its ``alpha`` set to one,
    in place, in name order from ``seed``: the same on both sides."""
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, v in named.items():
            if name.endswith(".w"):
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
            elif name.endswith(".alpha"):
                v.fill_(1.0)


@pytest.fixture
def random_weights(monkeypatch):
    """Random fuse weights on the reference (every one the comparison makes)
    and a plant that gives the program's net the same; returns the plant."""
    init_params = REF.init_params

    def drawn(cfg, obs_dim, n_actions, seed):
        p = init_params(cfg, obs_dim, n_actions, seed)
        _random_weights(p, seed)
        return p

    monkeypatch.setattr(REF, "init_params", drawn)

    def plant(trainer, seed):
        make_net = trainer.make_net

        def made(generator=None):
            net = make_net(generator)
            _random_weights(dict(net.named_parameters()), seed)
            return net

        trainer.make_net = made

    return plant


def _port_net(seed: int, cfg=CFG) -> LSTMActorCritic:
    return LSTMActorCritic(ENV.obs_dim, ENV.n_actions, SETTINGS(**cfg),
                           torch.Generator().manual_seed(seed))


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", ["reference/ppo_lstm.py", "work/mhc_gru_actor_critic.py",
                                 "faults/ppo_lstm_lander.py"])
def test_the_yardstick_imports_neither_jax_nor_either_package(rel):
    """The reference, the work count and the faults import none of JAX, the
    JAX package and the port, by whole top-level name."""
    assert not _imports(os.path.join(BENCH_DIR, rel)) & FORBIDDEN


@pytest.mark.parametrize("seed", SEEDS)
def test_the_initial_weights_equal_the_ports_by_name(seed):
    """Drawn from the seed in the program's module order: the same names, in
    the same order (Adam's and the clip's), the same bits."""
    port = dict(_port_net(seed).named_parameters())
    ref = REF.init_params(CFG, ENV.obs_dim, ENV.n_actions, seed)
    assert list(ref) == list(port)
    for name, v in ref.items():
        assert torch.equal(v, port[name].detach()), name


def _pieces(seed: int):
    net = _port_net(seed)
    params = dict(net.named_parameters())
    _random_weights(params, seed)
    ref = {k: v.detach().clone() for k, v in params.items()}
    gen = torch.Generator().manual_seed(seed + 2)
    return net, ref, gen


@pytest.mark.parametrize("piece", ["sinkhorn", "backbone", "gru_step", "gru_unroll", "rnd",
                                   "heads"])
def test_each_piece_equals_the_ports(piece):
    """On the port's weights (fuses drawn at random) and random inputs, each
    piece of the reference gives the port's module's bits."""
    seed = 7
    net, p, gen = _pieces(seed)
    b, L, obs = 6, 8, ENV.obs_dim
    x = torch.randn(b, obs, generator=gen)
    h = torch.randn(b, CFG["rnn_hidden"], generator=gen)
    with torch.no_grad():
        if piece == "sinkhorn":
            A = torch.exp(torch.randn(b, 2, 2, generator=gen))
            _, u, v = port_mhc.sinkhorn_knopp(A, CFG["mhc_sk_it"])
            got, want = REF.sinkhorn_knopp(A, CFG["mhc_sk_it"]), (u, v)
        elif piece == "backbone":
            got, want = REF.backbone(p, CFG, x), net.encode(x)
        elif piece == "gru_step":
            got, want = REF.gru_step(p, h, net.encode(x)), net.cell(h, net.encode(x))[0]
        elif piece == "gru_unroll":
            xs = torch.randn(b, L, CFG["mhc_dim"], generator=gen)
            got, want = REF.gru_unroll(p, h, xs), net.rnn.unroll(h, xs)[0]
        elif piece == "rnd":
            got, want = REF.rnd(p, CFG, x), net.rnd(x)
        else:
            got = (REF.head(p, "actor", h), REF.head(p, "critic", h).squeeze(-1))
            want = net.heads(h)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_two_lockstep_iterations_equal_the_ports(random_weights, seed):
    """Two ``train_iter``s of the port's timed path (``programs/ppo_lstm.py``)
    and two of the reference from the same seed: the first iteration's chunks
    field by field, every loss metric, Adam's first moments and the params,
    each to the bit (module docstring)."""
    trainer = program.build(CONF, CFG, CPU)
    random_weights(trainer, seed)
    prog = files.obj(CONF["program"])(trainer, trainer.init(seed))
    ref = REF.Reference(CFG, seed, CPU, "ieee", ENV)
    for k in range(2):
        p, r = prog.iterate(), ref.iterate()
        assert p["metrics"] == r["metrics"], k
        assert p["episodes"] == r["episodes"], k
        if k == 0:
            assert set(p["rows"]) == set(r["rows"])
            for name, v in r["rows"].items():
                assert torch.equal(p["rows"][name], v), name
        for name, v in ref.moments().items():
            assert torch.equal(prog.moments()[name], v), (k, name)
        for name, v in ref.leaves().items():
            assert torch.equal(prog.leaves()[name].detach(), v.detach()), (k, name)
    assert p["metrics"][REF.METRICS.index("rnd_loss")] > 0
    target = [v for name, v in ref.leaves().items() if name.startswith("rnd.target")]
    assert target and all(v.grad is not None and not v.grad.any() for v in target)


@pytest.mark.parametrize("fault", ["sinkhorn_once", "detached_mix", "fresh_h0", "no_rnd_reward"])
def test_each_fault_is_caught_by_the_comparison(random_weights, fault):
    """The program with each planted fault, against the reference from the
    same seed: some number at or past the cell's limit. Unplanted, every
    number reads 0."""
    seed = 2**31 + 11
    plants = files.obj(CONF["faults"])

    def plant(trainer, fault=fault):
        random_weights(trainer, seed)
        if fault:
            plants[fault](trainer)

    ref = compare.reference_summary(CONF, CFG, seed, CPU)
    limits = files.limits(CELL)
    _, _, sound = program.run_setup(CONF, CFG, seed, CPU, lambda t: plant(t, None))
    assert compare.numbers(sound, ref, CONF, CFG, seed, CPU) == dict.fromkeys(compare.NUMBERS,
                                                                             0.0)
    _, _, broken = program.run_setup(CONF, CFG, seed, CPU, plant)
    nums = compare.numbers(broken, ref, CONF, CFG, seed, CPU)
    assert not compare.judge(nums, limits)[0], nums


@pytest.mark.parametrize("witness", ["mhc_regrouped", "gru_regrouped", "per_tensor_adam"])
def test_each_regrouping_is_correct(random_weights, witness):
    """The program with its float32 sums grouped otherwise (the faults'
    ``WITNESSES``), against the reference from the same seed: under every
    limit of the cell."""
    seed = 2**31 + 11
    regroup = files.obj("faults.ppo_lstm_lander:WITNESSES")[witness]

    def plant(trainer):
        random_weights(trainer, seed)
        regroup(trainer)

    ref = compare.reference_summary(CONF, CFG, seed, CPU)
    _, _, prog = program.run_setup(CONF, CFG, seed, CPU, plant)
    nums = compare.numbers(prog, ref, CONF, CFG, seed, CPU)
    assert compare.judge(nums, files.limits(CELL))[0], nums


def test_the_judge_resets_the_hidden_where_an_episode_ended():
    """Rows of an iteration in which episodes end (16 envs × T 32, the third
    iteration): a reference holding the params that collected them reads 0;
    with the rows' ``done`` cleared it carries the hidden over the episode's
    end and reads a gap."""
    seed, cfg = 2**31 + 11, {**CFG, "num_envs": 16, "rollout_steps": 32, "minibatch_size": 64}
    ref = REF.Reference(cfg, seed, CPU, "ieee", ENV)
    ref.iterate()
    ref.iterate()
    collected = {k: v.detach().clone() for k, v in ref.leaves().items()}
    rows = ref.iterate()["rows"]
    assert rows["done"].any()
    judge = REF.Reference(cfg, seed, CPU, "ieee", ENV)
    with torch.no_grad():
        for k, v in judge.leaves().items():
            v.copy_(collected[k])
    assert judge.judge_rows(rows) == 0.0
    assert judge.judge_rows({**rows, "done": torch.zeros_like(rows["done"])}) > 1e-3


@pytest.fixture
def small_bench(tmp_path):
    """A copy of the benchmark's folder with the cell's configuration at the
    small widths and a small traffic mix."""
    dst = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = {**CONF, **{k: SMALL[k] for k in ("mhc_dim", "rnn_hidden", "rnd_embed")}}
    (dst / "configs" / "ppo_lstm_lander_cli.json").write_text(json.dumps(conf))
    schedule = {k: SMALL[k] for k in ("num_envs", "rollout_steps", "minibatch_size", "num_epochs")}
    (dst / "traffic" / "small.json").write_text(json.dumps({"schedule": schedule}))
    return str(dst)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_through_the_harness(small_bench, trace):
    """``harness.run`` on the new cell from its files alone, at the small
    size on the CPU: correct, every number 0, the end-to-end metrics read
    untraced; traced, no device metric without a card."""
    the_cell = dict(files.cell(files.benchmark(), CELL), traffic="small")
    r = harness.run(the_cell, 20261018, 0.3, trace, CPU, time.perf_counter(),
                    bench_dir=small_bench)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {k: c["value"] for k, c in r["compared"].items()} == dict.fromkeys(
        files.limits(CELL), 0.0)
    if trace:
        assert r["metrics"] == {} and r["device"]["busy_s"] == 0.0
    else:
        assert set(r["metrics"]) == {"setup_s", "env_steps_per_s", "iter_ms_p90"}


def test_the_cell_resolves_to_its_files():
    bench = files.benchmark()
    c = files.cell(bench, CELL)
    entry = next(x for x in bench["configs"] if x["name"] == c["config"])
    assert (c["chips"], entry["file"]) == (1, f"portbench/configs/{c['config']}.json")
    assert entry["source"] == CONF["source"] and entry["reduced"] == CONF["reduced"] == []
    assert len(entry["source"]) <= 200 and len(c["why"]) <= 200
    cfg = files.run_config(c)
    assert set(cfg) <= set(SETTINGS.__dataclass_fields__)
    full = SETTINGS(**cfg)
    assert (full.batch_total, full.seqs_per_rollout, full.num_minibatches) == (4096, 512, 4)
    assert full.seq_minibatch == 128
    assert set(files.limits(CELL)) == set(compare.NUMBERS)
    assert (ENV.obs_dim, ENV.n_actions) == (CONF["env_sizes"]["obs"],
                                            CONF["env_sizes"]["actions"])
    assert files.obj(CONF["program"]).METRICS == REF.Reference.METRICS
    assert {m["name"] for m in c["per_layer"]} == {
        "rollout_ms", "gae_ms", "sgd_ms", "lander_step_roofline", "step_mfu"}
    assert all(m["workloads"][-1] == CELL for m in c["per_layer"])


@pytest.mark.parametrize("rows,chunks", [(1024, 128), (32, 4), (12, None)])
def test_the_settings_take_the_minibatch_in_rows(rows, chunks):
    """``Settings`` turns the mix's minibatch in rows into whole chunks of
    ``seq_len`` steps, and refuses rows that are no whole number of them."""
    if chunks is None:
        with pytest.raises(ValueError):
            SETTINGS(seq_len=8, minibatch_size=rows)
    else:
        assert SETTINGS(seq_len=8, minibatch_size=rows).seq_minibatch == chunks


def _view():
    """A run of the cell as its readers see it: two iterations' phases, one
    traced ``lander_step`` launch of 10 µs among others."""
    cfg = files.run_config(files.cell(files.benchmark(), CELL))
    return harness.RunView(CONF, cfg, 20.0, [1.5, 2.5], 4.0,
                           [{"rollout": 900.0, "gae": 40.0, "sgd": 600.0},
                            {"rollout": 1100.0, "gae": 60.0, "sgd": 400.0}],
                           [("k", 0, 5_000), ("lander_step", 5_000, 15_000)], 4.0)


@pytest.mark.parametrize("metric", [m["name"] for m in files.cell(files.benchmark(),
                                                                  CELL)["per_layer"]])
def test_each_metric_of_the_cell_reads_a_run_of_it(metric):
    """Each per-layer metric that lists the cell reads the cell's run with
    the reader it has for every cell: the phases' means, the lander step's
    least time over its launch's, the work count's products at the float32
    peak over the 2 s mean iteration."""
    view = _view()
    got = files.module("metrics", metric).read(view)
    if metric == "step_mfu":
        ideal = files.module("work", CONF["model_work"]).ideal_iteration_s(
            view.cfg, CONF["env_sizes"], view.peaks, view.tf32)
        want = 100.0 * ideal / 2.0
    elif metric == "lander_step_roofline":
        want = 100.0 * files.module("work", "lander_step").least_s(view.cfg, view.peaks) / 1e-5
    else:
        want = {"rollout_ms": 1000.0, "gae_ms": 50.0, "sgd_ms": 500.0}[metric]
    assert got == pytest.approx(want, rel=1e-12)


def test_the_work_count_at_the_published_widths():
    """The parameter count equals the port's net's at the cell's widths; the
    products per row, counted by hand (module docstring of the work count)."""
    work = files.module("work", CONF["model_work"])
    cfg, sizes = files.run_config(files.cell(files.benchmark(), CELL)), CONF["env_sizes"]
    assert work.params(cfg, sizes) == sum(p.numel() for p in _port_net(0, cfg).parameters())
    assert work.params(cfg, sizes) == 2_179_067
    # backbone 8·256 + 4·(512·8 + 512 + 1,024 + 65,536); GRU 3·256·512 + 3·512·512;
    # heads 512·512 + 512·4 + 512·512 + 512; a PSCN 8·512 + 256² + 128² + 64² + 32²
    assert work.macs_successor(cfg, sizes) == 286_720 + 1_179_648 + 526_848
    assert work.macs_step(cfg, sizes) == 1_993_216 + 2 * 91_136
    backward = (2 * 91_136 - 8 * 512) + (2 * 286_720 - 8 * 256) + 2 * 393_216 \
        + 786_432 * 15 // 8 + 2 * 526_848
    assert work.macs_sgd_row(cfg, sizes) == 2_175_488 + backward == 6_239_744
    n = 64 * 64
    flops = 2 * n * (2_175_488 + 1_993_216) + 2 * 4 * n * 6_239_744
    assert work.ideal_iteration_s(cfg, sizes, harness.PEAKS, False) == pytest.approx(
        flops / 67e12, rel=1e-12)
