"""The port's distributed layer on the CPU: gloo worlds of 2 and 4 processes.

Every scenario runs in child processes (``distributed/launch.py``): one
world of two ranks on a ``(2, 1)`` mesh and one of four on ``(2, 2)``, each
started once for the module (``worlds``) and running every scenario of its
size (``torch_dist_ranks.py``). The JAX package runs on the conftest's 8
virtual devices in this process.

What is held, with each tolerance's reason:
  * the ports of ``tests/test_distributed.py`` (11), of
    ``tests/test_checkpoint.py::test_ppo_roundtrip_under_mesh_restores_shardings``
    and of ``tests/test_ppo.py``'s two mesh tests: the layout (env batch,
    GRU hidden, reward scaler returns and n-step window split on ``data``;
    replay, PER sum-tree, obs statistics and params whole), finite metrics,
    step counts, the flat optimizer refused under a ``model`` axis at
    construction;
  * one sharded ``train_iter`` of each family equals the unsharded port: the
    rollout (env states, episodes, the noise stream, the replay's
    transitions) exactly, because every rank draws the global shape and keeps
    its rows and every per-env step is elementwise; except SAC's env states
    and replay, whose continuous actions come from the actor's rows at B/2,
    which the CPU's matmul rounds differently from the rows at B (1e-5), and
    the PER sum-tree, whose priorities come from the shares' TD errors (rtol
    1e-5 plus 1e-6 of the root, the PER tests' rule).
    Params to ``ATOL`` 1e-5, the port tests' bound for O(1) float32 weights:
    the shares' means and the all-reduce add in another order, a few ulps per
    step (measured ≤ 8.5e-7). No Adam-sign rule is needed at these sizes: no
    gradient entry sat at rounding level (it would show as a 2·lr step);
  * PPO (DP and the 2×2 trunk split) and recurrent PPO sharded against the
    JAX package's mesh run from the same params, env batch and key splits:
    atol 1e-4 / rtol 1e-3, the JAX tests' own bound for its sharded run
    against its unsharded one. Adam's eps is 1e-5 there, so a gradient at
    rounding level moves a weight by ~lr·1e-9/1e-5, not by a sign;
  * a checkpoint saved under the 2×2 mesh restores every rank's rows and
    splits, equal to the bit, and training continues from it to the bit.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gymrl_tpu.algos.ppo import PPOConfig as RefPPOConfig
from gymrl_tpu.algos.ppo import PPOTrainer as RefPPOTrainer
from gymrl_tpu.algos.ppo_rnn import PPORNNConfig as RefRNNConfig
from gymrl_tpu.algos.ppo_rnn import PPORNNTrainer as RefRNNTrainer
from gymrl_tpu.distributed.mesh import make_mesh as jax_make_mesh
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.core.noise import Noise, ShardedNoise
from gymrl_tpu_torch.distributed.launch import start_world
from gymrl_tpu_torch.replay.episode import episode_buffer_pack
from gymrl_tpu_torch.utils.checkpoint import flat_state, save_checkpoint, state_tree

from test_torch_dqn import CartPolePPOReplay
from test_torch_ppo_rnn_ppg import RNNReplayNoise
from torch_dist_ranks import Recorder, build

torch.set_num_threads(1)

ATOL = 1e-5
JAX_ATOL, JAX_RTOL = 1e-4, 1e-3
TESTS_DIR = str(pathlib.Path(__file__).resolve().parent)

M = "gymrl_tpu_torch.algos."
PPO = (M + "ppo", "PPOTrainer", "PPOConfig")
PPO_SLICE = dict(env_name="LunarLander-v3", num_envs=8, rollout_steps=16, minibatch_size=32,
                 num_epochs=2)
PPO_CARTPOLE = dict(env_name="CartPole-v1", num_envs=8, rollout_steps=16, minibatch_size=32,
                    num_epochs=2)
RNN = (M + "ppo_rnn", "PPORNNTrainer", "PPORNNConfig")
RNN_CARTPOLE = dict(env_name="CartPole-v1", num_envs=8, rollout_steps=8, seq_len=8,
                    seq_minibatch=8, num_epochs=2)
# one sharded-equals-unsharded case per family: (trainer, config, iterations)
FAMILIES = {
    "ppo_dp": (PPO, PPO_SLICE, 1),
    "dqn": ((M + "dqn", "DQNTrainer", "DQNConfig"),
            dict(num_envs=8, steps_per_iter=8, updates_per_step=2, batch_size=16,
                 memory_capacity=512), 1),
    "rainbow": ((M + "dqn_variants", "DQNFamilyTrainer", "rainbow_config"),
                dict(num_envs=8, steps_per_iter=8, updates_per_step=2, batch_size=16,
                     memory_capacity=256), 2),
    "sac": ((M + "continuous", "SACTrainer", "sac_config"),
            dict(num_envs=8, steps_per_iter=8, updates_per_step=2, batch_size=16,
                 memory_capacity=256), 1),
    "ppo_rnn": (RNN, RNN_CARTPOLE, 2),
    "ppo_rnn_episodes": ((M + "ppo_rnn", "PPORNNTrainer", "ppo_rnn_lunarlander_config"),
                         dict(num_envs=8, rollout_steps=16, seq_minibatch=16, num_epochs=2,
                              feature_dim=32), 1),
    "ppg": ((M + "ppg", "PPGTrainer", "ppg_rnn_lunarlander_config"),
            dict(num_envs=8, rollout_steps=16, seq_minibatch=16, num_epochs=2, aux_epochs=2,
                 aux_every=1, feature_dim=32), 1),
    "ppo_full": ((M + "ppo_full", "PPOFullTrainer", "PPOFullConfig"),
                 dict(num_envs=8, rollout_steps=16, minibatch_size=32, num_epochs=2, mhc_dim=32,
                      mhc_layers=1, mhc_sk_it=3, clip_cov_ratio=0.2), 1),
    "ppo_lstm": ((M + "ppo_lstm", "PPOLSTMTrainer", "PPOLSTMConfig"),
                 dict(num_envs=8, rollout_steps=16, seq_len=8, seq_minibatch=8, num_epochs=2,
                      mhc_dim=32, mhc_layers=1, mhc_sk_it=3, rnn_hidden=32, rnd_embed=32), 1),
}
TP_FAMILIES = {"ppo_tp": (PPO, PPO_SLICE, 1)}
# parts of a state that hold the env batch and what it produced
EXACT = ("vec_state", "window", "hidden", "obs_rms", "reward_scaler", "noise", "episodes",
         "target_syncs", "env_steps", "learn_steps", "beta")
PARAMS = ("params", "nets", "targets", "target_params")


# -- the reference runs in this process ---------------------------------------------
def _unsharded(kind, cfg, iters, seed=0) -> dict:
    trainer = build(kind, cfg)
    ts = trainer.init(seed)
    outs = []
    for _ in range(iters):
        ts, out = trainer.train_iter(ts)
        outs.append(out)
    return {"state": flat_state(state_tree(ts)),
            "metrics": [{k: float(v) for k, v in o.metrics.items()} for o in outs],
            "ep_return": [o.ep_return for o in outs], "ep_done": [o.ep_done for o in outs]}


def _jax_case(name, tmp):
    """A JAX-vs-port case: the reference's initial state carried into the
    port (saved for the ranks), the port's unsharded run drawing the
    reference's key splits (recorded for the ranks), and the JAX mesh run."""
    if name == "rnn":
        ref_cfg, port_kind, port_cfg, key = RefRNNConfig(**RNN_CARTPOLE), RNN, RNN_CARTPOLE, 3
        ref_cls, replay, shapes = RefRNNTrainer, RNNReplayNoise, ((2, 1),)
    else:
        ref_cfg, port_kind, port_cfg, key = RefPPOConfig(**PPO_CARTPOLE), PPO, PPO_CARTPOLE, 5
        ref_cls, replay, shapes = RefPPOTrainer, CartPolePPOReplay, ((2, 1), (2, 2))
    jts = jax.device_get(jax.jit(ref_cls(ref_cfg).init)(jax.random.PRNGKey(key)))
    trainer = build(port_kind, port_cfg)
    ts = interop.train_state_from_reference(trainer, jts, Noise("cpu", 0))
    path = os.path.join(tmp, f"jax_{name}_init.pt")
    save_checkpoint(path, ts)
    recorder = Recorder(replay(jts.key))
    ts, _ = trainer.train_iter(ts._replace(noise=recorder))
    jax_params = {}
    for shape in shapes:
        rt = ref_cls(ref_cfg, mesh=jax_make_mesh(n_data=shape[0], n_model=shape[1]))
        mts, _ = rt.train_iter(rt.init(jax.random.PRNGKey(key)))
        jax_params[shape] = interop.params_from_flax(jax.device_get(mts.params))
    return {"kind": port_kind, "cfg": port_cfg, "path": path, "draws": recorder.log,
            "port": {k: v.clone() for k, v in ts.params.state_dict().items()},
            "jax": jax_params}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started once: every scenario's result by name, the
    unsharded references and the JAX cases."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    jax_cases = {name: _jax_case(name, tmp) for name in ("ppo", "rnn")}

    two = {"allreduce": dict(fn="allreduce")}
    for name, (kind, cfg, iters) in FAMILIES.items():
        two[name] = _scenario((2, 1), kind, cfg, iters)
    two["ppo_dp_flat"] = _scenario((2, 1), PPO, dict(PPO_CARTPOLE, num_envs=16, rollout_steps=8,
                                                     minibatch_size=16, num_epochs=1,
                                                     flat_optimizer=True), 1)
    two["refuse_split"] = dict(fn="refuse", mesh_shape=(2, 1), kind=PPO,
                               cfg=dict(PPO_CARTPOLE, minibatch_size=33))
    four = {name: _scenario((2, 2), kind, cfg, iters)
            for name, (kind, cfg, iters) in TP_FAMILIES.items()}
    four["refuse_flat_tp"] = dict(fn="refuse", mesh_shape=(2, 2), kind=PPO,
                                  cfg=dict(PPO_CARTPOLE, flat_optimizer=True))
    four["checkpoint"] = dict(fn="checkpoint_roundtrip", mesh_shape=(2, 2), kind=PPO,
                              cfg=PPO_CARTPOLE, path=os.path.join(tmp, "ppo_tp.pt"))
    for name, case in jax_cases.items():
        for shape in case["jax"]:
            world = two if shape == (2, 1) else four
            world[f"jax_{name}_{shape[1]}"] = _scenario(
                shape, case["kind"], case["cfg"], 1, state_path=case["path"], draws=case["draws"])
    started = [start_world("torch_dist_ranks:run", n, {"scenarios": sc},
                           workdir=os.path.join(tmp, f"world{n}"), timeout_s=600.0,
                           extra_path=(TESTS_DIR,))
               for n, sc in ((2, two), (4, four))]
    refs = {name: _unsharded(kind, cfg, iters)
            for name, (kind, cfg, iters) in (FAMILIES | TP_FAMILIES).items()}
    ranks2, ranks4 = (w.wait() for w in started)
    return {"two": ranks2, "four": ranks4, "refs": refs, "jax": jax_cases}


def _scenario(shape, kind, cfg, iters, **kw):
    return dict(fn="train", mesh_shape=shape, kind=kind, cfg=cfg, iters=iters, **kw)


# -- helpers ------------------------------------------------------------------------
def _part(key: str) -> str:
    return key.split(".")[1].split("[")[0]


def _assert_matches_unsharded(got: dict, ref: dict, loose_env: bool = False):
    """The whole sharded state against the unsharded one (module docstring)."""
    want = ref["state"]
    assert set(got["state"]) == set(want)
    for k, w in want.items():
        g = got["state"][k]
        part = _part(k)
        if not isinstance(w, torch.Tensor):
            assert g == w, k
        elif part in PARAMS:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL, err_msg=k)
        elif part in EXACT or part == "replay":
            if loose_env and w.is_floating_point():
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL, err_msg=k)
            elif part == "replay" and k.endswith(("tree", "max_priority")):
                # priorities from the shares' TD errors carry their rounding, and
                # a node is a sum of them: rtol 1e-5 plus 1e-6 of the root, the
                # sum-tree rule of the PER tests and of chip_smoke.py phase 7
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-6 * float(w.abs().max()), err_msg=k)
            elif part == "hidden":
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL, err_msg=k)
            else:
                assert torch.equal(g, w), k
    for gm, wm in zip(got["metrics"], ref["metrics"]):
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=ATOL, err_msg=k)
    for a, b in zip(got["ep_return"] + got["ep_done"], ref["ep_return"] + ref["ep_done"]):
        if loose_env:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0, atol=ATOL)
        else:
            assert torch.equal(a, b)


def _both_ranks_agree(results: list, name: str):
    """Every rank holds the same gathered state and metrics."""
    first = results[0][name]
    for other in results[1:]:
        o = other[name]
        assert o["metrics"] == first["metrics"]
        for k, v in first["state"].items():
            assert (torch.equal(o["state"][k], v) if isinstance(v, torch.Tensor)
                    else o["state"][k] == v), k


def _finite(result):
    for metrics in result["metrics"]:
        for k, v in metrics.items():
            assert np.isfinite(v), k


# -- ports of tests/test_distributed.py ----------------------------------------------
def test_dqn_family_rainbow_sharded_mesh_runs(worlds):
    """Rainbow (PER + n-step + soft target) over a 2-rank data mesh: env
    batch and n-step window split, replay and sum-tree whole, two iterations."""
    r = worlds["two"][0]["rainbow"]
    cfg = FAMILIES["rainbow"][1]
    assert r["local_shapes"]["ts.vec_state.obs"] == (4, 4)
    assert r["local_shapes"]["ts.window.obs"] == (5, 4, 4)  # [n, B/2, obs]: axis 1
    assert r["local_shapes"]["ts.replay.tree"] == (2 * cfg["memory_capacity"],)
    _finite(r)
    assert r["env_steps"] == 2 * 8 * 8
    _both_ranks_agree(worlds["two"], "rainbow")


def test_dqn_vanilla_sharded_matches_semantics(worlds):
    r = worlds["two"][0]["dqn"]
    assert r["local_envs"] == 4 and r["local_shapes"]["ts.vec_state.obs"] == (4, 4)
    assert np.isfinite(r["metrics"][0]["loss"])
    assert r["local_shapes"]["ts.replay.data.obs"] == (512, 4)


def test_sac_sharded_mesh_runs(worlds):
    r = worlds["two"][0]["sac"]
    assert r["local_shapes"]["ts.vec_state.obs"] == (4, 3)
    _finite(r)
    assert r["env_steps"] == 8 * 8


def test_ppo_rnn_sharded_mesh_runs(worlds):
    """Recurrent PPO's DP layout: env batch, GRU hidden and the reward
    scaler's per-env returns split on 'data'; obs statistics whole."""
    r = worlds["two"][0]["ppo_rnn"]
    assert r["local_shapes"]["ts.vec_state.obs"] == (4, 4)
    assert r["local_shapes"]["ts.hidden"][0] == 4
    assert r["local_shapes"]["ts.reward_scaler.ret"] == (4,)
    assert r["local_shapes"]["ts.obs_rms.mean"] == (4,)
    _finite(r)
    assert r["env_steps"] == 2 * 8 * 8


def test_ppo_rnn_sharded_matches_unsharded(worlds):
    _assert_matches_unsharded(worlds["two"][0]["ppo_rnn"], worlds["refs"]["ppo_rnn"])


def test_ppo_tp_sharded_matches_unsharded(worlds):
    """A 2×2 DP×TP iteration reproduces the unsharded port: the Megatron
    split's math (column-split shared_0, row-split shared_1, the sum over
    'model' after it), not only that it runs."""
    r = worlds["four"][0]["ppo_tp"]
    assert r["local_shapes"]["ts.params.shared_0.weight"] == (128, 8)
    assert r["local_shapes"]["ts.params.shared_1.weight"] == (256, 128)
    assert r["local_shapes"]["ts.params.actor_0.weight"] == (256, 256)
    _assert_matches_unsharded(r, worlds["refs"]["ppo_tp"])
    _both_ranks_agree(worlds["four"], "ppo_tp")


def test_ppo_lstm_sharded_mesh_runs(worlds):
    r = worlds["two"][0]["ppo_lstm"]
    assert r["local_shapes"]["ts.vec_state.obs"] == (4, 8)
    assert r["local_shapes"]["ts.hidden"] == (4, 32)
    _finite(r)
    assert r["env_steps"] == 8 * 16


def test_ppo_full_sharded_mesh_runs(worlds):
    r = worlds["two"][0]["ppo_full"]
    assert r["local_shapes"]["ts.vec_state.obs"] == (4, 8)
    _finite(r)
    assert r["env_steps"] == 8 * 16


def test_ppg_sharded_mesh_runs(worlds):
    r = worlds["two"][0]["ppg"]
    assert r["local_shapes"]["ts.hidden"][0] == 4
    _finite(r)
    assert r["metrics"][0]["aux_value_loss"] != 0.0  # the aux phase ran


def test_initialize_multihost_two_process_cpu(worlds):
    """Two processes joined by ``initialize_multihost`` agree on a collective:
    1 + 2 = 3 over a world of 2."""
    got = [r["allreduce"] for r in worlds["two"]]
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["total"] == 3.0 and g["world"] == 2 for g in got)


def test_flat_optimizer_mesh_rules(worlds):
    """The flat optimizer is refused under a model axis (at construction) and
    runs under pure DP."""
    assert "flat_optimizer" in worlds["four"][0]["refuse_flat_tp"]
    r = worlds["two"][0]["ppo_dp_flat"]
    assert r["local_shapes"]["ts.vec_state.obs"] == (8, 4)
    assert np.isfinite(r["metrics"][0]["policy_loss"])


# -- ports of the checkpoint and PPO mesh tests ----------------------------------------
def test_ppo_roundtrip_under_mesh_restores_shardings(worlds):
    """Saved under a 2×2 mesh, restored into a fresh state of the same mesh:
    every rank gets its rows and splits back, equal to the bit, the file
    holds whole tensors, and training continues from it to the bit."""
    for rank in worlds["four"]:
        r = rank["checkpoint"]
        assert r["differ"] == []
        assert r["local_trunk"] == (128, 4) and r["local_obs"] == (4, 4)
        assert r["saved_trunk"] == (256, 4) and r["saved_obs"] == (8, 4)
        assert r["saved_moment"] == (256, 4)  # Adam's moments follow the split
        assert r["continues_equal"]
        assert r["env_steps"] == 2 * 8 * 16


def test_ppo_sharded_mesh_runs(worlds):
    r = worlds["two"][0]["ppo_dp"]
    assert r["local_shapes"]["ts.vec_state.obs"] == (4, 8)
    assert np.isfinite(r["metrics"][0]["policy_loss"])
    assert r["env_steps"] == 8 * 16


def test_flat_optimizer_refuses_tp_mesh_at_construction(worlds):
    msg = worlds["four"][0]["refuse_flat_tp"]
    assert msg is not None and "model" in msg


def test_minibatch_that_data_does_not_divide_is_refused(worlds):
    msg = worlds["two"][0]["refuse_split"]
    assert msg is not None and "33" in msg and "data=2" in msg


# -- sharded equals unsharded, every family ---------------------------------------------
@pytest.mark.parametrize("name", [n for n in FAMILIES if n != "ppo_rnn"])
def test_sharded_iteration_matches_unsharded(worlds, name):
    _assert_matches_unsharded(worlds["two"][0][name], worlds["refs"][name],
                              loose_env=name == "sac")
    _both_ranks_agree(worlds["two"], name)


# -- against the JAX package's mesh runs ----------------------------------------------
@pytest.mark.parametrize("case,model", [("ppo", 1), ("ppo", 2), ("rnn", 1)])
def test_sharded_port_matches_jax_mesh_run(worlds, case, model):
    """The port's sharded iteration (every draw the reference's key splits,
    handed out whole and kept by rows) against the JAX package's own mesh
    run from the same state, at the JAX tests' tolerance."""
    jc = worlds["jax"][case]
    world = worlds["two"] if model == 1 else worlds["four"]
    r = world[0][f"jax_{case}_{model}"]
    assert r["draws_used"] == len(jc["draws"])  # the sharded run drew exactly these
    want = jc["jax"][(2, model)]
    for k, w in want.items():
        np.testing.assert_allclose(r["state"][f"ts.params.{k}"].numpy(), w.numpy(),
                                   rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=k)
        # and the unsharded port from the same draws, tighter
        np.testing.assert_allclose(r["state"][f"ts.params.{k}"].numpy(), jc["port"][k].numpy(),
                                   rtol=0, atol=ATOL, err_msg=k)


# -- pieces that need no process group -------------------------------------------------
def test_episode_pack_concatenates_across_ranks():
    """The recurrent pack is env-major (column b owns rows b·R .. b·R+R−1), so
    the ranks' packs of their env columns, concatenated in rank order, are
    the unsharded pack, exactly."""
    gen = torch.Generator().manual_seed(0)
    T, B, R = 32, 8, 4
    data = {"obs": torch.randn(T, B, 3, generator=gen), "action": torch.randint(0, 4, (T, B),
            generator=gen, dtype=torch.int32)}
    done = torch.rand(T, B, generator=gen) < 0.15
    whole = episode_buffer_pack(data, done, R)
    for d in (2, 4):
        n = B // d
        parts = [episode_buffer_pack({k: v[:, r * n:(r + 1) * n] for k, v in data.items()},
                                     done[:, r * n:(r + 1) * n], R) for r in range(d)]
        for k in data:
            assert torch.equal(torch.cat([p.data[k] for p in parts]), whole.data[k])
        assert torch.equal(torch.cat([p.active for p in parts]), whole.active)
        assert torch.equal(torch.cat([p.lengths for p in parts]), whole.lengths)
        assert sum(int(p.dropped_steps) for p in parts) == int(whole.dropped_steps)


def test_sharded_noise_draws_the_global_rows():
    """Each rank's per-row draws are its rows of the unsharded draw; the
    global draws are the unsharded ones; every rank's stream advances alike."""
    from gymrl_tpu_torch.envs.lunarlander import LunarLander

    env = LunarLander()
    whole = Noise("cpu", 3)
    want = [whole.gumbel((8, 4)), whole.env_step(env, 8), whole.env_reset(env, 8),
            whole.permutations(2, 16), whole.explore(8, 4)]
    for rank in range(2):
        sh = ShardedNoise(Noise("cpu", 3), rank, 2)
        rows = slice(4 * rank, 4 * rank + 4)
        assert torch.equal(sh.gumbel((4, 4)), want[0][rows])
        assert torch.equal(sh.env_step(env, 4), want[1][rows])
        reset = sh.env_reset(env, 4)
        for got, full in zip(reset, want[2]):
            assert torch.equal(got, full[rows])
        assert torch.equal(sh.permutations(2, 16), want[3])
        for got, full in zip(sh.explore(4, 4), want[4]):
            assert torch.equal(got, full[rows])
        assert torch.equal(sh.state_dict()["generator"], whole.state_dict()["generator"])


def test_distributed_and_profiling_import_no_jax():
    """No module of ``gymrl_tpu_torch.distributed`` or ``utils.profiling``
    imports jax or gymrl_tpu, by their source and in a fresh interpreter."""
    root = pathlib.Path(TESTS_DIR).parent / "gymrl_tpu_torch"
    files = sorted((root / "distributed").glob("*.py")) + [root / "utils" / "profiling.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not n.startswith(("jax", "gymrl_tpu.")) and n != "gymrl_tpu", (f, n)
    mods = ["gymrl_tpu_torch.distributed." + f.stem for f in files[:-1]]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "import gymrl_tpu_torch.utils.profiling\n"
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'gymrl_tpu.'))"
            + " or m == 'gymrl_tpu']\nassert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(root.parent), env=env,
                   timeout=120)
