"""Every cell and metric of BENCHMARK.json resolves to its files by name, and
a cell added as files alone is found."""

import json
import os
import re

import pytest

from benchlib import compare, files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = files.benchmark()


def test_benchmark_json_keeps_to_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert os.path.getsize(os.path.join(files.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_to_its_files(cell):
    c = files.cell(BENCH, cell)
    conf = files.config(c["config"])
    entry = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert entry["file"] == f"portbench/configs/{c['config']}.json"
    assert entry["source"] == conf["source"] and entry["reduced"] == conf["reduced"]
    assert set(conf["reduced"]) <= set(conf.get("published", {}))
    files.obj(conf["program"]).check(files.run_config(c))
    assert set(files.limits(cell)) <= set(compare.NUMBERS)
    for key in ("program", "reference", "reference_env", "faults"):
        assert files.obj(conf[key]) is not None, key
    assert callable(files.module("work", conf["model_work"]).ideal_iteration_s)
    assert set(conf["env_sizes"]) == {"obs", "actions"}
    assert {m["name"] for m in c["end_to_end"]} == {m["name"] for m in BENCH["end_to_end"]}
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(files.module("metrics", m["name"]).read)


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "lander64_e2_mb512", "config": "ppo_lander_cli",
                               "traffic": "b64_t16_e2_mb512", "chips": 1, "why": "a new mix"})
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (bench_dir / sub).mkdir(parents=True)
    conf = files.config("ppo_lander_cli")
    (bench_dir / "configs" / "ppo_lander_cli.json").write_text(json.dumps(conf))
    (bench_dir / "traffic" / "b64_t16_e2_mb512.json").write_text(json.dumps(
        {"schedule": {"num_envs": 64, "rollout_steps": 16, "num_epochs": 2,
                      "minibatch_size": 512}}))
    (bench_dir / "limits" / "lander64_e2_mb512.json").write_text('{"loss": 1e-3}')
    c = files.cell(bench, "lander64_e2_mb512")
    cfg = files.run_config(c, str(bench_dir))
    assert (cfg["num_envs"], cfg["minibatch_size"], cfg["hidden_dim"]) == (64, 512, 256)
    assert files.limits("lander64_e2_mb512", str(bench_dir)) == {"loss": 1e-3}
    assert {m["name"] for m in c["end_to_end"]} == {"setup_s", "env_steps_per_s", "iter_ms_p90"}
    assert c["per_layer"] == []  # each per-layer metric lists its cells


def test_an_unknown_cell_or_file_is_refused():
    with pytest.raises(KeyError):
        files.cell(BENCH, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        files.module("metrics", "no_such_metric")
