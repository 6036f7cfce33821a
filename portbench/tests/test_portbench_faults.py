"""A whole run with the card's look skipped, at a tiny size on the CPU: sound,
it comes out correct; with the timed path broken underneath, not correct,
once for each fault a one-chip training cell can have (one chip: there is no
exchange between chips to leave out)."""

import time

import pytest
import torch

from benchlib import files, harness

from conftest import tiny

CELL = "lander32_e10_mb64"
PLANTS = files.obj(files.config(files.cell(files.benchmark(), CELL)["config"])["faults"])


def _run(tiny_bench, cell, plant=None, trace=False):
    return harness.run(tiny(cell), 20261017, 0.3, trace, torch.device("cpu"),
                       time.perf_counter(), bench_dir=tiny_bench, plant=plant)


@pytest.mark.parametrize("cell", [w["name"] for w in files.benchmark()["workloads"]])
def test_a_sound_run_is_correct_and_prints_the_contract_keys(tiny_bench, cell):
    r = _run(tiny_bench, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "compared" and set(r["compared"]) == set(files.limits(cell))
    assert set(r["metrics"]) == {"setup_s", "env_steps_per_s", "iter_ms_p90"}
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_a_traced_run_reads_no_device_metric_without_a_card(tiny_bench):
    r = _run(tiny_bench, CELL, trace=True)
    assert r["correct"] is True and r["metrics"] == {}
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", sorted(PLANTS))
def test_a_broken_timed_path_is_not_correct(tiny_bench, fault):
    r = _run(tiny_bench, CELL, plant=PLANTS[fault])
    assert r["correct"] is False
    assert any(c["value"] >= c["limit"] for c in r["compared"].values())
