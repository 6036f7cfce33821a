"""The work counts behind step_mfu and the rooflines, at the cells' shapes,
against numbers computed by hand."""

import pytest

from benchlib import files
from benchlib.stats import PEAKS, busy_ns, merged, percentile

CONF = files.config("ppo_lander_cli")
SIZES = CONF["env_sizes"]
CFG = files.run_config(files.cell(files.benchmark(), "lander32_e10_mb64"))


def test_actor_critic_counts():
    net = files.module("work", CONF["model_work"])
    # 8·256 + 3·256·256 + 256·4 + 256·1
    assert net.macs_forward(CFG, SIZES) == 199_936
    assert net.macs_sgd_row(CFG, SIZES) == 3 * 199_936 - 8 * 256
    assert net.params(CFG, SIZES) == 200_965 and net.tensors(CFG, SIZES) == 12
    # rollout + next values and 10 epochs of forward + backward, all float32
    n = 32 * 64
    ideal = 4 * n * 199_936 / 67e12 + 2 * 10 * n * 597_760 / 67e12
    assert net.ideal_iteration_s(CFG, SIZES, PEAKS, tf32=False) == pytest.approx(ideal, rel=1e-12)
    assert ideal == pytest.approx(0.3899e-3, rel=1e-3)
    bf16 = {**CFG, "num_envs": 8192, "num_epochs": 4, "minibatch_size": 16384, "sgd_bf16": True}
    n = 8192 * 64
    ideal = 4 * n * 199_936 / 67e12 + 2 * 4 * n * 597_760 / 989e12
    assert net.ideal_iteration_s(bf16, SIZES, PEAKS, tf32=False) == pytest.approx(ideal, rel=1e-12)


@pytest.mark.parametrize("envs,nbytes", [(32, 5_376), (8192, 1_376_256)])
def test_lander_step_counts(envs, nbytes):
    work = files.module("work", "lander_step")
    cfg = {**CFG, "num_envs": envs}
    assert work.launch_bytes(cfg) == nbytes
    assert work.launch_ops(cfg) == 2580 * envs
    assert work.least_s(cfg, PEAKS) == pytest.approx(nbytes / 3.35e12)  # bytes bound


@pytest.mark.parametrize("kernel,shape,nbytes", [
    ("ppo_loss_fwd", {"rows": 16384, "actions": 4}, 589_848),
    ("ppo_loss_bwd", {"rows": 16384, "actions": 4}, 917_508),
    ("grad_sq_norms", {"params": 200_965, "tensors": 12}, 803_908),
    ("clip_adam", {"params": 200_965, "tensors": 12}, 5_627_068),
])
def test_update_kernel_bytes_match_phase_19(kernel, shape, nbytes):
    work = files.module("work", kernel)
    assert work.launch_bytes(**shape) == nbytes
    assert work.least_s(PEAKS, **shape) == pytest.approx(nbytes / 3.35e12)


def test_percentile_and_busy_union():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 50) == 3.0 and percentile(xs, 90) == pytest.approx(4.6)
    assert percentile(list(range(101)), 90) == 90
    spans = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert busy_ns(spans) == 25 and merged(spans) == [(0, 15), (20, 30)]
