"""Checkpoints leave the replay out, as the JAX package's do.

``gymrl_tpu.utils.checkpoint`` saves a train state with its ``replay``
field set to None (``_strip_replay``, after gymRL's ``ModelLoader``, which
never saves a buffer) and restores into a fresh init whose replay it keeps,
so an off-policy trainer resumes on an empty buffer. The port's
``save_checkpoint`` / ``restore_checkpoint`` do the same. For
``dqn_cartpole``, ``sac_pendulum``, ``ddqn_per_cartpole`` (the PER sum-tree
and max priority live in the replay; β and the counters do not) and
``dqn_cartpole_pixels`` (the uint8 ring), at the small configs of their
lockstep tests:

  * both packages train two iterations from the reference's init, the port
    from the reference's state at each, with its draws replayed (as the
    lockstep tests do);
  * each package saves its state with its own checkpoint code and restores
    it into a fresh init of its own: the restored replay equals a fresh
    init's, every other field equals the saved one (the port: each tensor
    and scalar to the bit), and both leave out the same fields;
  * from the restored states, one more iteration of each package: the port
    asks for the reference's draws in the reference's order (updates wait
    for ``batch_size`` rows of the empty buffer again), and its outputs and
    state match the reference's within the tolerances of the lockstep tests
    (``test_torch_dqn``, ``test_torch_continuous``, ``test_torch_dqn_variants``,
    ``test_torch_pixels_render``).

A mismatch in any other field still raises ``ValueError``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gymrl_tpu.algos import continuous as RC
from gymrl_tpu.algos import dqn_variants as RV
from gymrl_tpu.algos.dqn import DQNConfig as RefDQNConfig
from gymrl_tpu.algos.dqn import DQNTrainer as RefDQNTrainer
from gymrl_tpu.utils import checkpoint as ref_ckpt
from gymrl_tpu_torch.algos import dqn_variants as V
from gymrl_tpu_torch.algos.dqn import DQNConfig, DQNTrainer
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.utils import checkpoint as ckpt

import test_torch_continuous as tc
import test_torch_dqn as td
import test_torch_dqn_variants as tv
import test_torch_pixels_render as tp

torch.set_num_threads(2)


def _merged(*logs) -> dict:
    """The per-entry counts of several grad logs, summed."""
    out: dict = {}
    for log in logs:
        for k, v in log.counts.items():
            out[k] = out.get(k, 0) + v
    return out


class _Counts:
    """A grad log's ``counts`` alone, as the lockstep checks read them."""

    def __init__(self, counts):
        self.counts = counts


# -- the four workloads, each with its lockstep test's config, port and checks -------------
class DQNCase:
    """``dqn_cartpole`` at ``test_torch_dqn.SLICE``."""

    name = "dqn_cartpole"

    def reference(self):
        return RefDQNTrainer(RefDQNConfig(**td.SLICE))

    def port(self, rt, jts):
        trainer, ts = td._port(jts)
        return trainer, ts

    def noise(self, trainer, rt, jts):
        return td.DQNReplayNoise(jts.key, trainer.cfg.n_updates)

    def grad_log(self, ts):
        return td.GradLog({"": ts.params}, {"": ts.opt_state})

    def lockstep(self, rt, trainer, log):
        return None

    def check(self, trainer, ts, jts, out, jout, counts, where):
        td._assert_iter_out_equal(out, jout, where)
        td._assert_dqn_state_close(ts, jts, trainer.cfg.lr, _Counts(counts), where)


class SACCase:
    """``sac_pendulum`` at ``test_torch_continuous.PENDULUM``; every act and
    update held by its ``Lockstep``."""

    name = "sac_pendulum"

    def reference(self):
        return RC.SACTrainer(RC.sac_config(**tc.PENDULUM))

    def port(self, rt, jts):
        return tc._port("sac", jts)

    def noise(self, trainer, rt, jts):
        return tc.OffPolicyReplayNoise(jts.key, trainer.cfg.n_updates)

    def grad_log(self, ts):
        return tc._grad_log(ts)

    def lockstep(self, rt, trainer, log):
        lock = tc.Lockstep(rt, trainer)
        lock.log = log
        return lock

    def check(self, trainer, ts, jts, out, jout, counts, where):
        tc._assert_iter_out_close(out, jout, where)
        tc._assert_state_close(trainer, ts, jts, _Counts(counts), where)


class PERCase:
    """``ddqn_per_cartpole`` at ``test_torch_dqn_variants``' narrow config;
    every act and update held by its ``FamilyLockstep``."""

    name = "ddqn_per_cartpole"
    preset = "ddqn_per"

    def reference(self):
        return RV.DQNFamilyTrainer(tv.PRESETS[self.preset][0](**tv._kw(self.preset)))

    def port(self, rt, jts):
        trainer, ts, _ = tv._port(self.preset, rt, jts)
        return trainer, ts

    def noise(self, trainer, rt, jts):
        return tv.FamilyReplayNoise(rt, jts)

    def grad_log(self, ts):
        return tv.FamilyGradLog(ts.params, ts.opt_state)

    def lockstep(self, rt, trainer, log):
        return tv.FamilyLockstep(rt, trainer, log)

    def check(self, trainer, ts, jts, out, jout, counts, where):
        tv._assert_free_run_close(trainer, ts, jts, out, jout, _Counts(counts), where)


class PixelCase(PERCase):
    """``dqn_cartpole_pixels`` at ``test_torch_pixels_render.SMALL``: the
    uint8 ring under that test's quantization rule."""

    name = "dqn_cartpole_pixels"

    def reference(self):
        return RV.DQNFamilyTrainer(RV.dqn_pixels_config(**tp.SMALL))

    def port(self, rt, jts):
        trainer, ts, _ = tp._port(rt, jts)
        return trainer, ts

    def noise(self, trainer, rt, jts):
        return tp.PixelReplayNoise(rt, jts)

    def check(self, trainer, ts, jts, out, jout, counts, where):
        ref = jax.device_get(jts)
        cfg = trainer.cfg
        assert (ts.env_steps, ts.learn_steps) == (int(ref.env_steps), int(ref.learn_steps))
        assert int(ts.episodes) == int(ref.episodes), where
        assert int(ts.target_syncs) == int(ref.target_syncs), where
        for net, want in (("params", ref.params), ("target_params", ref.target_params)):
            td.assert_params_close(getattr(ts, net).state_dict(), tv._flax(want), cfg.lr,
                                   counts, f"{net} {where}")
        tp._assert_nested_close(ts.vec_state, ref.vec_state, where)
        for f in ("ep_done", "ep_length", "ep_return"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                          err_msg=f"{f} {where}")
        np.testing.assert_allclose(float(out.metrics["loss"]), float(jout.metrics["loss"]),
                                   rtol=td.RTOL, atol=td.ATOL)
        obs_f, next_f = self.quant.shadow(0, cfg.memory_capacity, cfg.num_envs)
        for f, floats in (("obs", obs_f), ("next_obs", next_f)):
            got = getattr(ts.replay.data, f).numpy()
            want = np.asarray(getattr(ref.replay.data, f))
            assert got.dtype == want.dtype == np.uint8
            tp.assert_uint8_close(got, want, floats, f"replay {f} {where}")
        stripped = lambda r: r._replace(data=r.data._replace(obs=r.data.obs[:0],  # noqa: E731
                                                             next_obs=r.data.next_obs[:0]))
        tv._assert_replay_close(stripped(ts.replay), stripped(ref.replay), where)


CASES = {c.name: c for c in (DQNCase(), SACCase(), PERCase(), PixelCase())}
TRAIN_ITERS = 2


# -- what each package's restore keeps -------------------------------------------------------
def _assert_tree_equal(got, want, where):
    """Two JAX pytrees, leaf for leaf."""
    got_leaves, got_def = jax.tree_util.tree_flatten(jax.device_get(got))
    want_leaves, want_def = jax.tree_util.tree_flatten(jax.device_get(want))
    assert got_def == want_def, where
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def _assert_port_equal(got: dict, want: dict, where):
    """Two ``flat_state`` dicts, every tensor and scalar to the bit."""
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, f"{k} {where}"
            assert torch.equal(g.cpu(), w.cpu()), f"{k} {where}"
        else:
            assert g == w, f"{k} {where}"


def _without_replay(ts) -> dict:
    flat = ckpt.flat_state(ckpt.state_tree(ts))
    return {k: v for k, v in flat.items() if not k.startswith("ts.replay")}


def _replay_flat(ts) -> dict:
    flat = ckpt.flat_state(ckpt.state_tree(ts))
    return {k: v for k, v in flat.items() if k.startswith("ts.replay")}


@pytest.fixture(scope="module")
def refs():
    """One reference trainer per workload for the file, made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = CASES[name].reference()
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_restore_resumes_on_a_fresh_replay_as_the_reference_does(refs, name, tmp_path,
                                                                 monkeypatch):
    case, rt = CASES[name], refs(name)
    if isinstance(case, PixelCase):
        case.quant = tp.QuantLog(monkeypatch)

    # two iterations in both packages, the port from the reference's state at each
    jts = rt.init(jax.random.PRNGKey(0))
    trained_logs = []
    for it in range(TRAIN_ITERS):
        trainer, ts = case.port(rt, jts)
        log = case.grad_log(ts)
        case.lockstep(rt, trainer, log)
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        trained_logs.append(log)
    where = f"{name} before the save"
    case.check(trainer, ts, jts, out, jout, _merged(trained_logs[-1]), where)
    assert ts.replay.size > 0 and int(jts.replay.size) == ts.replay.size

    # each package saves and restores with its own checkpoint code
    jax_path = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), jts)
    ref_fresh = rt.init(jax.random.PRNGKey(1))
    jr = ref_ckpt.restore_checkpoint(jax_path, ref_fresh)
    ts = ts._replace(noise=Noise("cpu", 5))  # the replaying noise is no generator to save
    port_path = ckpt.save_checkpoint(str(tmp_path / "port.pt"), ts)
    trainer, _ = case.port(rt, jts)  # a fresh trainer of the same config
    restored = ckpt.restore_checkpoint(port_path, trainer.init(1))

    # the same fields left out: the whole replay, and nothing else
    ref_dropped = {f for f in jts._fields if getattr(ref_ckpt._strip_replay(jts), f) is None
                   and getattr(jts, f) is not None}
    port_dropped = {k for k, v in torch.load(port_path, weights_only=True).items()
                    if v is None and getattr(ts, k) is not None}
    assert ref_dropped == port_dropped == {"replay"}
    # the reference's restore: its fresh replay, every other field as saved
    _assert_tree_equal(jr.replay, ref_fresh.replay, f"{name} reference replay")
    _assert_tree_equal(jr._replace(replay=None), jts._replace(replay=None),
                       f"{name} reference restore")
    # the port's: the same, every tensor and scalar to the bit
    _assert_port_equal(_replay_flat(restored), _replay_flat(trainer.init(1)),
                       f"{name} port replay")
    assert (restored.replay.pos, restored.replay.size) == (0, 0)
    _assert_port_equal(_without_replay(restored), _without_replay(ts), f"{name} port restore")

    # one more iteration of each from its restored state, the reference's draws replayed
    noise = case.noise(trainer, rt, jr)
    restored = restored._replace(noise=noise)
    log = case.grad_log(restored)
    lock = case.lockstep(rt, trainer, log)
    if isinstance(case, PixelCase):
        case.quant.frames.clear()
    jr, jout = rt.train_iter(jr)
    restored, out = trainer.train_iter(restored)
    where = f"{name} after the restore"
    cfg = trainer.cfg
    warm = getattr(cfg, "n_steps", 1) - 1  # env steps before the n-step window pushes
    sizes = [min(cfg.num_envs * max(t + 1 - warm, 0), cfg.memory_capacity)
             for t in range(cfg.steps_per_iter)]
    assert restored.replay.size == int(jr.replay.size) == sizes[-1]
    if name == "sac_pendulum":
        assert noise.calls == tc._expected_calls("sac", sizes, cfg), where
    elif name != "dqn_cartpole":
        assert noise.calls == tv._expected_calls(cfg, sizes), where
    if lock is not None:  # every act and update of the port held to the reference's
        assert lock.acts == cfg.steps_per_iter and lock.updates > 0
    case.check(trainer, restored, jr, out, jout, _merged(trained_logs[-1], log), where)


@pytest.mark.parametrize("field", ["params", "vec_state", "window"])
def test_a_mismatch_outside_the_replay_still_raises(tmp_path, field):
    """Strict for every field but the replay: a net of another width, an env
    batch of another size, an n-step window where the file has none."""
    cfg = V.ddqn_per_config(**tv._kw("ddqn_per"))
    trainer = V.DQNFamilyTrainer(cfg, device="cpu")
    ts, _ = trainer.train_iter(trainer.init(0))
    path = ckpt.save_checkpoint(str(tmp_path / "per.pt"), ts)
    other = {"params": dict(hidden_dim=cfg.hidden_dim // 2), "vec_state": dict(num_envs=8),
             "window": dict(n_steps=3)}[field]
    with pytest.raises(ValueError, match=field):
        ckpt.restore_checkpoint(path, V.DQNFamilyTrainer(dataclasses.replace(cfg, **other),
                                                         device="cpu").init(0))
    # another replay capacity alone is no mismatch
    smaller = ckpt.restore_checkpoint(path, V.DQNFamilyTrainer(
        dataclasses.replace(cfg, memory_capacity=32), device="cpu").init(0))
    assert smaller.replay.tree.shape == (64,) and smaller.replay.size == 0


def test_a_file_that_holds_a_replay_is_refused(tmp_path):
    """A file written with the replay in it does not fit a state whose
    replay is not saved: the restore names the field."""
    cfg = DQNConfig(num_envs=4, steps_per_iter=8, batch_size=16, updates_per_step=1,
                    memory_capacity=64, hidden_dim=32)
    trainer = DQNTrainer(cfg, device="cpu")
    ts, _ = trainer.train_iter(trainer.init(0))
    path = str(tmp_path / "with_replay.pt")
    torch.save(ckpt.state_tree(ts), path)
    with pytest.raises(ValueError, match="replay"):
        ckpt.restore_checkpoint(path, trainer.init(1))
