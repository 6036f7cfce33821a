"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
checkout's root. They run on the CPU; a test marked ``card`` needs a CUDA
device and is skipped here by its fixture (decided when it runs, never when
a module is imported), and runs on the card as
``python -m pytest portbench/tests -q -m card``."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's folder with a tiny traffic mix for each
    configuration, ``tiny.<config>``: its program side's ``TINY`` schedule
    (the PPO family's: 8 envs × 8 steps, 2 epochs × minibatch 16), which the
    CPU runs in seconds."""
    import json
    import shutil

    from benchlib import files

    dst = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for entry in files.benchmark()["configs"]:
        side = files.obj(files.config(entry["name"])["program"])
        (dst / "traffic" / f"tiny.{entry['name']}.json").write_text(
            json.dumps({"schedule": side.TINY}))
    return str(dst)


def tiny(cell: str) -> dict:
    """The cell ``cell`` of BENCHMARK.json on its configuration's tiny mix
    (``tiny_bench``)."""
    from benchlib import files

    c = files.cell(files.benchmark(), cell)
    return dict(c, traffic=f"tiny.{c['config']}")
