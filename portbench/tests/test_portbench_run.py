"""The command itself: no card, no result; and the control and the faults on
the card at a cell's own size (marked ``card``)."""

import subprocess
import sys

import pytest

from benchlib import compare, files, program

from conftest import ROOT


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "lander32_e10_mb64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 2 and done.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in files.benchmark()["workloads"]])
def test_the_control_and_each_fault_fail_a_number_on_the_card(card, cell):
    """The reference in TF32 in the program's place, and the program with
    each fault planted, at the cell's own size: each reads one number or more
    at or past its limit."""
    the_cell = files.cell(files.benchmark(), cell)
    conf, cfg = files.config(the_cell["config"]), files.run_config(the_cell)
    limits = files.limits(cell)
    ref = compare.reference_summary(conf, cfg, 77, card)
    ctl = compare.reference_summary(conf, cfg, 77, card, "tf32")
    assert not compare.judge(compare.numbers(ctl, ref, conf, cfg, 77, card), limits)[0]
    for name, plant in files.obj(conf["faults"]).items():
        if name == "unchanged":  # the captured sweep refuses a sweep that steps nothing
            continue
        _, _, prog = program.run_setup(conf, cfg, 77, card, plant)
        assert not compare.judge(compare.numbers(prog, ref, conf, cfg, 77, card), limits)[0], name
    _, _, prog = program.run_setup(conf, cfg, 77, card)
    assert compare.judge(compare.numbers(prog, ref, conf, cfg, 77, card), limits)[0]
