"""The plain reference against the port's CPU path at a tiny size, and the
reference's own imports."""

import ast
import os

import pytest
import torch

from benchlib import compare, files, program

from conftest import BENCH_DIR, tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "gymrl_tpu", "gymrl_tpu_torch"}


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("sub", ["reference", "work", "metrics"])
def test_the_yardstick_imports_neither_jax_nor_either_package(sub):
    """The reference, the work counts and the readers import none of JAX,
    the JAX package and the port, by whole top-level name."""
    folder = os.path.join(BENCH_DIR, sub)
    for name in sorted(os.listdir(folder)):
        if name.endswith(".py"):
            assert not _imports(os.path.join(folder, name)) & FORBIDDEN, name


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    import sys

    from benchlib import harness

    monkeypatch.setitem(sys.modules, "gymrl_tpu_torch_lookalike", sys)
    assert "gymrl_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gymrl_tpu.envs", sys)
    assert harness.forbidden_modules() == ["gymrl_tpu"]


@pytest.mark.parametrize("precision", [{}, {"rollout_bf16": True}, {"sgd_bf16": True},
                                       {"flat_optimizer": True}])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_the_reference_equals_the_ports_cpu_path(tiny_bench, seed, precision):
    """On the CPU the port runs its plain paths; the reference, a frozen copy
    of them with the draws in the program's order, reads every number 0, in
    the configuration's precision and in the port's other options."""
    the_cell = tiny("lander32_e10_mb64")
    conf = files.config(the_cell["config"])
    cfg = {**files.run_config(the_cell, tiny_bench), **precision}
    cpu = torch.device("cpu")
    _, _, prog = program.run_setup(conf, cfg, seed, cpu)
    ref = compare.reference_summary(conf, cfg, seed, cpu)
    assert compare.numbers(prog, ref, conf, cfg, seed, cpu) == dict.fromkeys(compare.NUMBERS, 0.0)
    assert torch.equal(prog["rows"], ref["rows"])
    assert all(v > 0 for v in ref["change"].values())


def test_the_sides_name_the_same_metrics():
    conf = files.config("ppo_lander_cli")
    assert files.obj(conf["program"]).METRICS == files.obj(conf["reference"]).METRICS
    env = files.obj(conf["reference_env"])
    assert (env.obs_dim, env.n_actions) == (conf["env_sizes"]["obs"], conf["env_sizes"]["actions"])
