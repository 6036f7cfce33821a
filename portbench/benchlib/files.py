"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, and under ``portbench/`` one file per configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``), cell's
limits of agreement (``limits/<cell>.json``), metric's reader
(``metrics/<metric>.py``, end-to-end or per-layer) and work count
(``work/<name>.py``). A configuration's file names, as ``folder.module:Name``
under ``portbench/``, the two sides of its comparison (``program``, the
reader of the port's train state; ``reference`` with its ``reference_env``)
and its planted ``faults``, and gives its env's sizes (``env_sizes``) and the
work count of its model (``model_work``). No table in code lists any of
them: a cell, a mix, a metric or a trainer's reference is added as files
alone.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    """The cell ``name`` of ``bench``'s ``workloads``, with its metrics:
    ``end_to_end`` and ``per_layer``, each the entries that name it (an
    entry without a ``workloads`` key names every cell)."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {**w, "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def limits(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "limits", f"{name}.json"))


# Keys of a configuration's file that describe it; every other key is a setting
# of the trainer's config, under the trainer's own name for it.
ABOUT = ("trainer", "config_class", "source", "published", "reduced", "assumed", "program",
         "reference", "reference_env", "faults", "env_sizes", "model_work")


def run_config(the_cell: dict, bench_dir: str = BENCH_DIR) -> dict:
    """The trainer's settings as the cell runs them: the configuration's,
    with the traffic mix's ``schedule`` over them, each under the trainer
    config's own name for it (PPO: ``num_envs``, ``rollout_steps``,
    ``num_epochs``, ``minibatch_size``; off-policy: ``num_envs``,
    ``steps_per_iter``, ``batch_size``)."""
    conf = config(the_cell["config"], bench_dir)
    mix = traffic(the_cell["traffic"], bench_dir)
    return {**{k: v for k, v in conf.items() if k not in ABOUT}, **mix["schedule"]}


_LOADED: dict[str, ModuleType] = {}


def module(kind: str, name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path once."""
    path = os.path.abspath(os.path.join(bench_dir, kind, f"{name}.py"))
    if path not in _LOADED:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def obj(spec: str, bench_dir: str = BENCH_DIR):
    """``"<kind>.<name>:<attr>"`` → ``attr`` of ``<kind>/<name>.py`` under the
    benchmark's folder."""
    where, _, attr = spec.partition(":")
    kind, _, name = where.partition(".")
    if not (kind and name and attr):
        raise ValueError(f"{spec!r}: expected '<folder>.<module>:<name>'")
    return getattr(module(kind, name, bench_dir), attr)
