"""The port's PPO trainer, loop, CLI and checkpoints against the JAX reference.

Both packages run on the CPU. Weights start from the reference's own init,
converted with ``interop.params_from_flax``; the port's noise source replays
the reference's ``jax.random`` key splits (``JaxReplayNoise``), so both
trainers draw the same Gumbels, env noise and epoch permutations.

Tolerances, each with its reason:
  * forward outputs, advantages, values, params: atol 1e-5. They are O(1)
    float32; the frameworks sum matmuls in different orders and XLA on the
    CPU fuses ``a*b + c`` where PyTorch rounds twice.
  * loss, metrics and grads of one minibatch: rtol 1e-5, plus an atol of
    1e-5 of each tensor's largest entry for grads (an entry summed from
    terms that cancel keeps the rounding of the terms, not its own size).
  * iteration metrics: atol 1e-5 + rtol 1e-5. ``value_loss`` is a mean of
    squared returns of O(25); the returns carry the rewards' rounding.
  * rewards and value targets: atol 1e-5 + 1e-6·|shaping|, as in
    ``test_torch_lunarlander.py``: a reward is the difference of two
    shaping values of up to ~300, whose float32 spacing is 3e-5.
  * standardized advantages: atol 1e-5 plus that reward tolerance divided
    by the std of the raw advantages, which is what standardizing does to it.
  * episode returns: the reward tolerance times the episode's length.
  * bf16 loss: atol 2e-2. bf16 keeps 8 bits of mantissa, and the two
    frameworks round at different places inside the forward.
  * actions: identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.algos.ppo import MinibatchData
from gymrl_tpu.algos.ppo import PPOConfig as RefConfig
from gymrl_tpu.algos.ppo import PPOTrainer as RefTrainer
from gymrl_tpu.algos.ppo import PPOTrainState as RefTrainState
from gymrl_tpu.core.gae import compute_gae as ref_compute_gae
from gymrl_tpu.core.gae import standardize as ref_standardize
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos.base import adam, clip_grads_by_global_norm_
from gymrl_tpu_torch.algos.ppo import PPOConfig, PPOTrainer
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_lunarlander import (
    SHAPING_RTOL, STATE_ATOL, JaxReplayNoise, jax_reset_draws, jax_step_draws,
)

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
SLICE = dict(env_name="LunarLander-v3", num_envs=8, rollout_steps=16,
             minibatch_size=32, num_epochs=2)


# One reference trainer per optimizer form, shared by the whole file: each
# jitted train_iter compiles once.
@pytest.fixture(scope="module")
def ref():
    return {flat: RefTrainer(RefConfig(**SLICE, flat_optimizer=flat)) for flat in (False, True)}


@pytest.fixture(scope="module")
def ref_ts0(ref):
    return ref[False].init(jax.random.PRNGKey(0))


def _port_from_ref(jts, flat=False, **overrides):
    """A CPU port trainer whose state is the reference state ``jts``:
    converted params, env batch and counters, fresh Adam moments, and a
    noise source replaying ``jts.key``."""
    trainer = PPOTrainer(PPOConfig(**{**SLICE, "flat_optimizer": flat, **overrides}), device="cpu")
    ts = trainer.init(0)
    ts.params.load_state_dict(interop.params_from_flax(jax.device_get(jts.params)))
    ts = ts._replace(
        vec_state=interop.vec_state_from_numpy(jax.device_get(jts.vec_state)),
        noise=JaxReplayNoise(jts.key),
        env_steps=int(jts.env_steps),
    )
    return trainer, ts


def _assert_params_close(net, ref_params, atol=ATOL, where=""):
    want = interop.params_from_flax(jax.device_get(ref_params))
    got = net.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol,
                                   err_msg=f"{k} {where}")


def _assert_within(got, want, atol, what):
    """|got - want| <= atol elementwise, for an ``atol`` array."""
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= atol).all(), f"{what}: errors {err} exceed {atol}"


def _loss_inputs(ref_trainer, params, rng, n=64):
    """A minibatch whose ratios straddle the clip band and whose advantages
    take both signs, so the clip and the dual clip both act."""
    obs = rng.normal(size=(n, 8)).astype(np.float32)
    action = rng.integers(0, 4, n).astype(np.int32)
    logits, _ = ref_trainer.net.apply(params, jnp.asarray(obs))
    logp_all = np.asarray(jax.nn.log_softmax(logits))
    logp_old = (logp_all[np.arange(n), action] + rng.normal(scale=0.4, size=n)).astype(np.float32)
    adv = (rng.normal(size=n) * 2).astype(np.float32)
    ret = (rng.normal(size=n) * 5).astype(np.float32)
    return obs, action, logp_old, adv, ret


# -- network, loss, one optimizer step -----------------------------------------
def test_actor_critic_matches_flax(ref, ref_ts0, rng):
    trainer, ts = _port_from_ref(ref_ts0)
    obs = (rng.normal(size=(64, 8)) * 2).astype(np.float32)
    want_logits, want_values = ref[False].net.apply(ref_ts0.params, jnp.asarray(obs))
    with torch.no_grad():
        logits, values = ts.params(torch.from_numpy(obs))
    assert logits.shape == (64, 4) and values.shape == (64,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(want_values), rtol=0, atol=ATOL)
    assert [n for n, _ in ts.params.named_children()] == [
        "shared_0", "shared_1", "actor_0", "actor_head", "critic_0", "critic_head"]


def _ref_loss_and_grads(rt, params, inputs):
    obs, action, logp_old, adv, ret = map(jnp.asarray, inputs)
    fn = jax.jit(jax.value_and_grad(rt._loss, has_aux=True))
    (loss, metrics), grads = fn(params, MinibatchData(obs=obs, action=action, logp=logp_old), adv, ret)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_loss_and_grads(trainer, net, inputs):
    net.zero_grad(set_to_none=True)
    loss, metrics = trainer._loss(net, *map(torch.from_numpy, inputs))
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def test_loss_metrics_and_grads_match_reference(ref, ref_ts0, rng):
    trainer, ts = _port_from_ref(ref_ts0)
    inputs = _loss_inputs(ref[False], ref_ts0.params, rng)
    want_loss, want_metrics, want_grads = _ref_loss_and_grads(ref[False], ref_ts0.params, inputs)
    loss, metrics, grads = _port_loss_and_grads(trainer, ts.params, inputs)

    assert 0.0 < want_metrics["clip_frac"] < 1.0, "want both clipped and unclipped ratios"
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=0)
    assert set(metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=RTOL, atol=1e-7, err_msg=k)
    want = interop.params_from_flax(jax.device_get(want_grads))
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_sgd_bf16_loss_matches_reference(ref_ts0, rng):
    rt16 = RefTrainer(RefConfig(**SLICE, sgd_bf16=True))
    trainer, ts = _port_from_ref(ref_ts0, sgd_bf16=True)
    inputs = _loss_inputs(rt16, ref_ts0.params, rng)
    want_loss, want_metrics, want_grads = _ref_loss_and_grads(rt16, ref_ts0.params, inputs)
    loss, metrics, grads = _port_loss_and_grads(trainer, ts.params, inputs)
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=2e-2)
    for k in want_metrics:
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=0, atol=2e-2, err_msg=k)
    # the gradients land on the f32 master weights
    assert all(g.dtype == torch.float32 for g in grads.values())
    f32_loss, _, _ = _port_loss_and_grads(_port_from_ref(ref_ts0)[0], ts.params, inputs)
    assert loss != f32_loss, "the bf16 path must really compute in bf16"


@pytest.mark.parametrize("grad_norm", [5.0, 0.05], ids=["above_clip", "below_clip"])
def test_clipped_adam_steps_match_optax(ref, ref_ts0, rng, grad_norm):
    """Three steps of clip_by_global_norm(0.5) + Adam(eps=1e-5) through the
    reference trainer's own optax chain, with its injected lr."""
    rt = ref[False]
    trainer, ts = _port_from_ref(ref_ts0)
    params = jax.device_get(ref_ts0.params)
    opt_state = rt.tx.init(params)
    lr = 2.5e-4
    opt_state[1].hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    net = ts.params
    opt = adam(list(net.parameters()), lr, 1e-5, foreach=False)
    by_name = dict(net.named_parameters())
    for step in range(3):
        raw = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                           for g in jax.tree_util.tree_leaves(raw)))
        grads = jax.tree_util.tree_map(lambda g: (g * (grad_norm / norm)).astype(np.float32), raw)
        updates, opt_state = rt.tx.update(grads, opt_state, params)
        params = jax.device_get(jax.tree_util.tree_map(lambda p, u: p + u, params, updates))

        for k, g in interop.params_from_flax(grads).items():
            by_name[k].grad = g
        got_norm = clip_grads_by_global_norm_([p.grad for p in net.parameters()], 0.5)
        np.testing.assert_allclose(float(got_norm), grad_norm, rtol=1e-5)
        opt.step()
        _assert_params_close(net, params, atol=1e-7, where=f"after step {step}")


# -- the slice as a whole --------------------------------------------------------
@pytest.fixture(scope="module")
def ref_rollout_and_gae(ref):
    """The reference's rollout and its standardized GAE for one iteration,
    from the same pieces its ``_train_iter`` uses."""
    rt = ref[False]
    cfg = rt.cfg

    @jax.jit
    def run(params, vec_state, obs_rms, key):
        _, _, _, roll, _ = rt._collect(RefTrainState(params, None, vec_state, obs_rms, key, None))
        _, next_values = rt._rollout_forward(params, roll.next_obs.reshape(-1, 8))
        adv, v_target = ref_compute_gae(
            roll.reward, roll.value, next_values.reshape(roll.value.shape),
            roll.terminated, roll.done, cfg.gamma, cfg.gae_lambda)
        return roll, ref_standardize(adv), v_target, jnp.std(adv)

    return lambda jts: run(jts.params, jts.vec_state, jts.obs_rms, jts.key)


def _record(obj, name, calls):
    """Wrap method ``name`` of ``obj`` to append (args, result) to ``calls``."""
    method = getattr(obj, name)

    def wrapped(*args):
        out = method(*args)
        calls.append((args, out))
        return out

    setattr(obj, name, wrapped)


@pytest.mark.parametrize("flat,start", [(False, "reset"), (True, "reset"), (False, "late")],
                         ids=["pytree", "flat", "pytree_late_start"])
def test_two_train_iters_match_reference(ref, ref_ts0, ref_rollout_and_gae, flat, start):
    """Two iterations on LunarLander at full width 256 with the reference's
    noise replayed: the same actions, rollouts, advantages, metrics and
    params. ``late`` starts from the env batch the reference reaches after
    four iterations, so episodes crash, land and autoreset inside the test."""
    rt = ref[flat]
    jts = rt.init(jax.random.PRNGKey(0))
    if start == "late":
        warm = jts
        for _ in range(4):
            warm, _ = rt.train_iter(warm)
        jts = jts._replace(vec_state=warm.vec_state, key=warm.key)
    trainer, ts = _port_from_ref(jts, flat=flat)
    collected, sgd_calls = [], []
    _record(trainer, "_collect", collected)
    _record(trainer, "_sgd", sgd_calls)

    episodes_done = 0
    for it in range(2):
        roll_ref, adv_ref, vt_ref, adv_std = jax.device_get(ref_rollout_and_gae(jts))
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"iteration {it}"

        _, roll, _ = collected[-1][1]
        np.testing.assert_array_equal(roll.action.numpy(), roll_ref.action, err_msg=where)
        shaping = np.abs(jax.device_get(jts.vec_state.env_state.prev_shaping)).max() + 100.0
        reward_atol = STATE_ATOL + SHAPING_RTOL * shaping
        for f, atol in (("obs", ATOL), ("next_obs", ATOL), ("value", ATOL), ("logp", ATOL),
                        ("reward", reward_atol), ("terminated", 0), ("done", 0)):
            np.testing.assert_allclose(getattr(roll, f).numpy(), getattr(roll_ref, f),
                                       rtol=0, atol=atol, err_msg=f"{f} {where}")
        packed = sgd_calls[-1][0][1]
        np.testing.assert_allclose(packed[:, 10].numpy(), adv_ref.reshape(-1), rtol=0,
                                   atol=ATOL + reward_atol / adv_std,
                                   err_msg=f"advantages {where}")
        np.testing.assert_allclose(packed[:, 11].numpy(), vt_ref.reshape(-1),
                                   rtol=0, atol=reward_atol, err_msg=f"value targets {where}")

        np.testing.assert_array_equal(out.ep_done.numpy(), np.asarray(jout.ep_done), err_msg=where)
        np.testing.assert_array_equal(out.ep_length.numpy(), np.asarray(jout.ep_length))
        _assert_within(out.ep_return.numpy(), np.asarray(jout.ep_return),
                       reward_atol * np.asarray(jout.ep_length), f"episode returns {where}")
        episodes_done += int(np.asarray(jout.ep_done).sum())
        assert set(out.metrics) == set(jout.metrics)
        for k, v in jout.metrics.items():
            np.testing.assert_allclose(float(out.metrics[k]), float(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} {where}")
        assert ts.env_steps == int(jts.env_steps) == (it + 1) * 128
        _assert_params_close(ts.params, jts.params, where=where)
    if start == "late":
        assert episodes_done > 0, "the late start should finish some episodes"
    np.testing.assert_allclose(ts.vec_state.obs.numpy(), np.asarray(jts.vec_state.obs),
                               rtol=0, atol=ATOL)


# -- mirrors of tests/test_ppo.py ------------------------------------------------
def _small_trainer(**kw):
    cfg = dict(SLICE, num_envs=4, rollout_steps=8, minibatch_size=8, num_epochs=3)
    cfg.update(kw)
    return PPOTrainer(PPOConfig(**cfg), device="cpu")


def test_update_count_matches_reference_cadence():
    """T·B/minibatch × epochs gradient steps per iteration, counted from the
    Adam step counters the run itself advanced."""

    def grad_steps(opt):
        counts = {int(s["step"]) for s in opt.state.values()}
        assert len(counts) == 1  # every parameter's counter agrees
        return counts.pop()

    trainer = _small_trainer()
    ts = trainer.init(0)
    assert grad_steps(ts.opt_state) == 0
    ts, _ = trainer.train_iter(ts)
    applied = grad_steps(ts.opt_state)
    assert applied == trainer.cfg.num_epochs * trainer.cfg.num_minibatches == 3 * (32 // 8)
    ts, _ = trainer.train_iter(ts)
    assert grad_steps(ts.opt_state) == 2 * applied


def test_lr_anneal_progresses_and_matches_reference_formula():
    trainer = _small_trainer(max_train_steps=96)
    ts = trainer.init(0)
    lrs = []
    for _ in range(4):
        ts, out = trainer.train_iter(ts)
        lrs.append(float(out.metrics["lr"]))
        assert ts.opt_state.param_groups[0]["lr"] == lrs[-1]
    assert lrs[0] > lrs[1] > lrs[2] > 0.0 and lrs[3] == 0.0  # clamped at max_train_steps
    want = [float(np.float32(3e-4) * max(np.float32(1) - np.float32(s) / np.float32(96), 0))
            for s in (0, 32, 64, 96)]
    assert lrs == want
    assert float(_small_trainer(anneal_lr=False).train_iter(
        _small_trainer(anneal_lr=False).init(0))[1].metrics["lr"]) == float(np.float32(3e-4))


def test_rollout_bf16_stays_close_to_f32():
    """Same params and noise: the bf16 acting path's behaviour logp differs
    from the f32 one by bf16 rounding only, where the sampled actions agree."""
    rolls = {}
    for bf16 in (False, True):
        trainer = _small_trainer(rollout_bf16=bf16)
        rolls[bf16] = trainer._collect(trainer.init(0))[1]
    same = rolls[False].action[0] == rolls[True].action[0]
    assert same.any()
    torch.testing.assert_close(rolls[True].logp[0][same], rolls[False].logp[0][same],
                               rtol=0, atol=5e-2)
    assert rolls[True].value.dtype == torch.float32


def test_obs_normalization_updates_in_rollout_and_freezes_in_eval():
    trainer = _small_trainer(normalize_obs=True)
    ts = trainer.init(0)
    ts, _ = trainer.train_iter(ts)
    assert float(ts.obs_rms.count) == trainer.cfg.batch_total
    before = float(ts.obs_rms.count)
    trainer.eval_episodes(ts, Noise("cpu", 1), 2)
    assert float(ts.obs_rms.count) == before


class _EvalReplay:
    """Replays the reference ``eval_episodes`` key splits: ``split(key)``
    into reset and roll keys, one roll key per step, each split into
    (action, env step)."""

    def __init__(self, key, max_steps):
        self.k_reset, k_roll = jax.random.split(key)
        self.step_keys = iter(jax.random.split(k_roll, max_steps))

    def env_reset(self, env, num):
        return jax_reset_draws(self.k_reset, num)

    def env_step(self, env, num):
        return jax_step_draws(jax.random.split(next(self.step_keys))[1], num)


def test_eval_episodes_matches_reference(ref, ref_ts0):
    """The port stops once every episode is done; the reference scans to
    max_steps with rewards masked after done. Same returns and lengths."""
    trainer, ts = _port_from_ref(ref_ts0)
    key = jax.random.PRNGKey(4)
    want_ret, want_len = ref[False].eval_episodes(ref_ts0, key, 3)
    ret, length = trainer.eval_episodes(ts, _EvalReplay(key, 1000), 3)
    np.testing.assert_array_equal(length.numpy(), np.asarray(want_len))
    reward_atol = STATE_ATOL + SHAPING_RTOL * 300.0
    _assert_within(ret.numpy(), np.asarray(want_ret), reward_atol * np.asarray(want_len), "returns")


# -- plumbing ----------------------------------------------------------------------
def test_cli_workload_trains_in_train_loop_on_cpu(tmp_path, monkeypatch, capsys):
    """The CLI's ppo_lunarlander workload (the default config) through
    TrainLoop for a two-iteration budget: console lines, eval, final save."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([]) == 1
    usage = capsys.readouterr().out
    assert all(name in usage for name in ref_cli.WORKLOADS) and len(ref_cli.WORKLOADS) == 21

    trainer, algo, solve = cli.WORKLOADS["ppo_lunarlander"]("cpu")
    assert (algo, solve, trainer.device) == ("PPO", 200.0, torch.device("cpu"))
    assert trainer.cfg == PPOConfig()
    loop = TrainLoop(trainer, algo, log_metrics=False, log_every=1,
                     eval_every=2 * trainer.cfg.batch_total, save_every=10 ** 9, eval_episodes=1)
    ts, stats = loop.train(2 * trainer.cfg.batch_total, solve_threshold=solve)
    assert stats["env_steps"] == ts.env_steps == 2 * 2048
    assert len(stats["curve"]) == 2 and not stats["solved"]
    assert (tmp_path / "checkpoints" / "PPO_LunarLander-v3.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


def test_checkpoint_round_trip_and_mismatch_raises(tmp_path):
    trainer = _small_trainer()
    ts = trainer.init(0)
    ts, _ = trainer.train_iter(ts)
    path = save_checkpoint(str(tmp_path / "ckpt.pt"), ts)

    restored = restore_checkpoint(path, trainer.init(1))
    assert restored.env_steps == ts.env_steps
    for k, v in ts.params.state_dict().items():
        torch.testing.assert_close(restored.params.state_dict()[k], v, rtol=0, atol=0)
    # the whole state came back: the next iteration is the same on both
    ts, out = trainer.train_iter(ts)
    restored, out_r = trainer.train_iter(restored)
    for k, v in ts.params.state_dict().items():
        torch.testing.assert_close(restored.params.state_dict()[k], v, rtol=0, atol=0)
    for k in out.metrics:
        torch.testing.assert_close(out_r.metrics[k], out.metrics[k], rtol=0, atol=0)

    with pytest.raises(ValueError, match="shared_0.weight"):
        restore_checkpoint(path, _small_trainer(hidden_dim=32).init(0))
    with pytest.raises(ValueError, match="env_state"):
        restore_checkpoint(path, _small_trainer(num_envs=8).init(0))
