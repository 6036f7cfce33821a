"""The port's DQN family (DDQN+PER, dueling, NoisyDQN, FlappyBird NoisyDQN,
Rainbow), its Q-network, n-step fold, CLI workloads, checkpoints and the
interop of its train state, against the JAX reference.

Both packages run on the CPU. Weights, targets, Adam states, replay and
sum-tree contents, windows, normalization statistics and env batches start
from the reference's own, carried across with
``interop.train_state_from_reference``; the port's noise source replays the
reference's ``jax.random`` key splits (``FamilyReplayNoise``), with the
NoisyNet ε recorded from the flax layers and FlappyBird's per-env keys
tracked beside the keyless port state, so both trainers draw the same
numbers.

Tolerances, each with its reason (the shared rules are those of
``test_torch_dqn.py``):
  * Q-values, losses: atol 1e-5 / rtol 1e-5; β rtol 1e-6.
  * params after Adam (eps 1e-8): atol 1e-5, with the Adam-sign rule and
    the ReLU-tie rule, here for ReLU and PReLU alike (``FamilyGradLog``):
    a pre-activation within 1e-5 of 0 may take either side of the kink,
    which moves its unit's output column and the consumers' input rows
    (``QNet.activation_edges``) by up to 2·lr per such update.
  * the sum-tree after a priority write-back: rtol 1e-5 (priorities come
    from TD errors that agree to float32 rounding); sampled indices exact
    from the same tree.
  * n-step fold: rewards atol 1e-6 (a fused ``a*b + c`` on XLA's side).
  * a free run (``TRAJ_ATOL``): see the comment above it.
  * integer and boolean data (actions, flags, counters, replay pos/size,
    Adam counts, the order of every draw): exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.algos import dqn_variants as R
from gymrl_tpu.core.schedules import exp_epsilon_decay as ref_eps_decay
from gymrl_tpu.replay.per import PERState as RefPERState
from gymrl_tpu.replay.uniform import ReplayState as RefReplayState
from gymrl_tpu.run import cli as ref_cli
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos import dqn_variants as V
from gymrl_tpu_torch.envs.flappybird import FlappyBirdState
from gymrl_tpu_torch.nn.layers import NoisyDense, noisy_layers
from gymrl_tpu_torch.replay.per import PERState
from gymrl_tpu_torch.run import cli
from gymrl_tpu_torch.run.loop import TrainLoop
from gymrl_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

from test_torch_dqn import ATOL, RTOL, assert_params_close, env_reset_draws, tiny_grad
from test_torch_per_flappybird import FlappyKeys, record_noise

torch.set_num_threads(1)

RELU_TIE = 1e-5
TREE_RTOL = 1e-5
BETA_RTOL = 1e-6


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# -- presets at narrow width ------------------------------------------------------------
NARROW = dict(num_envs=4, steps_per_iter=8, batch_size=16, updates_per_step=2)
PRESETS = {
    "ddqn_per": (R.ddqn_per_config, V.ddqn_per_config,
                 dict(hidden_dim=32, memory_capacity=64)),
    "ddqn_per_duel": (R.ddqn_per_duel_config, V.ddqn_per_duel_config,
                      dict(hidden_dim=32, memory_capacity=64)),
    "noisy_dqn": (R.noisy_dqn_config, V.noisy_dqn_config,
                  dict(hidden_dim=16, memory_capacity=64, target_update_freq=8)),
    "rainbow": (R.rainbow_config, V.rainbow_config,
                dict(hidden_dim=32, memory_capacity=64, max_train_steps=2000)),
    "noisy_dqn_flappybird": (R.noisy_dqn_flappybird_config, V.noisy_dqn_flappybird_config,
                             dict(pscn_dim=16, trunk_dims=(16, 8, 8), head_hidden=4,
                                  memory_capacity=64, target_update_freq=8)),
}


def _kw(preset):
    return {**NARROW, **PRESETS[preset][2]}


@pytest.fixture(scope="module")
def refs():
    """One reference trainer per preset for the file (each train_iter
    compiles once), made on first use."""
    cache = {}

    def get(preset):
        if preset not in cache:
            cache[preset] = R.DQNFamilyTrainer(PRESETS[preset][0](**_kw(preset)))
        return cache[preset]

    return get


# -- replaying the reference's draws --------------------------------------------------
class FamilyReplayNoise:
    """Replays ``DQNFamilyTrainer``'s key tree. Per env step ``split(key,
    6)`` into (key, act, ε, random action, env step, updates), asked for by
    the act (``noisy_act`` or ``explore``); ``VecEnv.step`` splits the env
    step key into (step, reset); ``split(k_upd, n_updates)``, and per update
    ``split(k, 4)`` into (sample, online forward, next-obs forward, unused),
    asked for by the sample (``per_uniforms`` / ``replay_indices``) with
    ``noisy_update`` taking the two forward keys. NoisyNet ε are the flax
    net's own draws (``record_noise``; they depend on the key and shapes
    only). A FlappyBird batch's respawn and reset gaps come from its
    per-env keys (``FlappyKeys``), advanced by ``after_step``."""

    def __init__(self, rt, jts):
        self.rt, self.key, self.n_updates = rt, jts.key, rt.cfg.n_updates
        self.params0 = jts.params
        self.obs_dim = rt.venv.env.obs_dim
        self.flappy = (FlappyKeys(jts.vec_state.env_state.key)
                       if rt.cfg.env_name == "FlappyBird-v0" else None)
        self.upd_keys, self.upd_i = [], 0
        self.calls: list[str] = []

    def _env_step_keys(self):
        (self.key, self.k_act, self.k_eps, self.k_rand, self.k_step,
         k_upd) = jax.random.split(self.key, 6)
        self.upd_keys, self.upd_i = list(jax.random.split(k_upd, self.n_updates)), 0

    def _record(self, key, rows, per_sample):
        x = jnp.zeros((rows, self.obs_dim), jnp.float32)
        return record_noise(self.rt.net, self.params0, x, key, per_sample)[1]

    def noisy_act(self, layers, rows):
        self.calls.append("noisy_act")
        self._env_step_keys()
        return self._record(self.k_act, rows, True)

    def explore(self, num, n_actions):
        self.calls.append("explore")
        self._env_step_keys()
        return (_t(jax.random.uniform(self.k_eps, (num,))),
                _t(jax.random.randint(self.k_rand, (num,), 0, n_actions)))

    def env_step(self, env, num):
        self.calls.append("env_step")
        _, self.k_reset = jax.random.split(self.k_step)
        return None if self.flappy is None else self.flappy.step_gaps()

    def env_reset(self, env, num):
        self.calls.append("env_reset")
        if self.flappy is None:
            return env_reset_draws(env, self.k_reset, num)
        return self.flappy.reset_gaps(self.k_reset, num)

    def peek_update_key(self):
        return self.upd_keys[self.upd_i]

    def _update_keys(self):
        k_sample, self.k1, self.k2, _ = jax.random.split(self.upd_keys[self.upd_i], 4)
        self.upd_i += 1
        return k_sample

    def per_uniforms(self, batch_size):
        self.calls.append("per_uniforms")
        return _t(jax.random.uniform(self._update_keys(), (batch_size,), jnp.float32))

    def replay_indices(self, batch_size, high):
        self.calls.append("replay_indices")
        return _t(jax.random.randint(self._update_keys(), (batch_size,), 0, high)).long()

    def noisy_update(self, layers, count):
        self.calls.append("noisy_update")
        rows = self.rt.cfg.batch_size
        return [self._record(k, rows, False) for k in (self.k1, self.k2)[:count]]


def _expected_calls(cfg, sizes) -> list[str]:
    """The reference's order of draws for env steps whose replay holds
    ``sizes[t]`` transitions after its push."""
    act = "noisy_act" if cfg.noisy else "explore"
    upd = ["per_uniforms" if cfg.use_per else "replay_indices"] + (
        ["noisy_update"] if cfg.noisy else [])
    calls = []
    for size in sizes:
        calls += [act, "env_step", "env_reset"]
        if size >= cfg.batch_size:
            calls += upd * cfg.n_updates
    return calls


def _port(preset, rt, jts):
    """The port trainer at the preset's narrow config and the reference
    state carried across, with the replaying noise; a FlappyBird trainer's
    ``venv.step`` advances the replayed per-env keys."""
    trainer = V.DQNFamilyTrainer(PRESETS[preset][1](**_kw(preset)), device="cpu")
    noise = FamilyReplayNoise(rt, jts)
    ts = interop.train_state_from_reference(trainer, jax.device_get(jts), noise)
    if noise.flappy is not None:
        step = trainer.venv.step

        def step_and_advance(vs, a, n):
            vs, tr = step(vs, a, n)
            n.flappy.after_step(tr.done)
            return vs, tr

        trainer.venv.step = step_and_advance
    return trainer, ts, noise


# -- the tie rule -----------------------------------------------------------------------
class FamilyGradLog:
    """Counts, per parameter entry, the optimizer steps whose update float32
    agreement does not fix, for ``assert_params_close``: the Adam-sign rule
    (a gradient below 1e-6 of its tensor's largest, or below 1e-6), and the
    tie rule: in the loss forward of that step a producer's pre-activation
    for some sample lay within RELU_TIE of 0 (ReLU or PReLU), which moves the
    unit's output column and, per ``QNet.activation_edges``, the consumers'
    input rows."""

    def __init__(self, net, opt):
        self.counts: dict[str, np.ndarray] = {}
        self.ties = 0
        self.shapes = {n: p.shape for n, p in net.named_parameters()}
        modules = dict(net.named_modules())
        self.noisy = {n for n, m in modules.items() if isinstance(m, NoisyDense)}
        self.edges = net.activation_edges()
        pending = []
        for name in {e[0] for e in self.edges}:
            def hook(mod, args, out, name=name):
                if torch.is_grad_enabled():
                    pending.append((name, out.detach().reshape(-1, out.shape[-1])))
            modules[name].register_forward_hook(hook)
        named = list(net.named_parameters())
        step = opt.step

        def logged(*args, **kw):
            for n, p in named:
                self._add(n, tiny_grad(p.grad))
            for name, out in pending:
                units = (out.abs() < RELU_TIE).any(dim=0).numpy()
                if units.any():
                    self.ties += 1
                    self._mark_units(name, units)
            pending.clear()
            return step(*args, **kw)

        opt.step = logged

    def _add(self, name, mask):
        self.counts[name] = self.counts.get(name, 0) + mask.astype(np.int64)

    def _mark(self, layer, index, axis_out: bool):
        """Mark output units (``axis_out``) or input rows ``index`` of a layer."""
        if layer in self.noisy:
            for k in ("kernel_mu", "kernel_sigma"):
                m = np.zeros(self.shapes[f"{layer}.{k}"], bool)
                if axis_out:
                    m[:, index] = True
                else:
                    m[index, :] = True
                self._add(f"{layer}.{k}", m)
            if axis_out:
                for k in ("bias_mu", "bias_sigma"):
                    m = np.zeros(self.shapes[f"{layer}.{k}"], bool)
                    m[index] = True
                    self._add(f"{layer}.{k}", m)
            return
        m = np.zeros(self.shapes[f"{layer}.weight"], bool)
        if axis_out:
            m[index, :] = True
            b = np.zeros(self.shapes[f"{layer}.bias"], bool)
            b[index] = True
            self._add(f"{layer}.bias", b)
        else:
            m[:, index] = True
        self._add(f"{layer}.weight", m)

    def _mark_units(self, producer, units):
        self._mark(producer, np.flatnonzero(units), True)
        for p, consumer, lo, hi, offset in self.edges:
            if p == producer:
                u = np.flatnonzero(units[lo:hi]) + lo
                if len(u):
                    self._mark(consumer, u + offset, False)


# -- reference-side state built from the port's --------------------------------------
def _jax_params(net):
    """The reference's params tree of (copied) numpy leaves."""
    return interop.params_to_flax(net.state_dict())


_OPT_TEMPLATES: dict = {}


def _jax_opt(rt, net, opt):
    """The port's Adam as the reference's optax state (numpy leaves), built on
    a template of the reference's structure made once per trainer."""
    if rt not in _OPT_TEMPLATES:
        _OPT_TEMPLATES[rt] = rt.tx.init(_jnp(_jax_params(net)))
    state = _OPT_TEMPLATES[rt]
    named = list(net.named_parameters())
    mu = interop.params_to_flax({n: opt.state[p]["exp_avg"] for n, p in named})
    nu = interop.params_to_flax({n: opt.state[p]["exp_avg_sq"] for n, p in named})
    count = np.int32(int(opt.state[named[0][1]]["step"]))
    inject = state[-1]
    adam_state = inject.inner_state[0]._replace(count=count, mu=mu, nu=nu)
    inject = inject._replace(count=count, inner_state=(adam_state,) + tuple(inject.inner_state[1:]))
    return tuple(state[:-1]) + (inject,)


def _jnp_copy(x: torch.Tensor):
    """A JAX copy: ``jnp.asarray`` of a numpy view may share the buffer the
    port then writes in place."""
    return jnp.asarray(x.detach().numpy().copy())


def _jax_replay(replay):
    data = R.Transition(*map(_jnp_copy, replay.data))
    pos, size = jnp.asarray(replay.pos, jnp.int32), jnp.asarray(replay.size, jnp.int32)
    if isinstance(replay, PERState):
        return RefPERState(data, _jnp_copy(replay.tree), pos, size,
                           _jnp_copy(replay.max_priority))
    return RefReplayState(data, pos, size)


def _assert_replay_close(st, ref_st, where, atol=0.0, rtol=0.0, tree_rtol=0.0):
    ref_st = jax.device_get(ref_st)
    assert (st.pos, st.size) == (int(ref_st.pos), int(ref_st.size)), where
    for f, got, want in zip(st.data._fields, st.data, ref_st.data):
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol,
                                       err_msg=f"replay {f} {where}")
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"replay {f} {where}")
    if isinstance(st, PERState):
        np.testing.assert_allclose(st.tree.numpy(), ref_st.tree, rtol=tree_rtol,
                                   atol=tree_rtol * float(ref_st.tree[1]), err_msg=f"tree {where}")
        np.testing.assert_allclose(float(st.max_priority), float(ref_st.max_priority),
                                   rtol=tree_rtol, err_msg=f"max_priority {where}")


_REF_FNS: dict = {}


def _ref_fns(rt):
    """The reference's act (inline in its ``_train_iter``) and
    ``_update_once``, jitted once per reference trainer."""
    if rt not in _REF_FNS:
        cfg = rt.cfg
        n_act = rt.venv.env.n_actions

        @jax.jit
        def ref_act(params, nobs, k_act, k_eps, k_rand, env_steps):
            q = rt._apply(params, nobs, k_act if cfg.noisy else None, per_sample=True)
            action = jnp.argmax(q, axis=-1).astype(jnp.int32)
            if not cfg.noisy:
                eps = ref_eps_decay(env_steps, cfg.epsilon_start, cfg.epsilon_end,
                                    cfg.epsilon_decay)
                randoms = jax.random.randint(k_rand, (nobs.shape[0],), 0, n_act)
                explore = jax.random.uniform(k_eps, (nobs.shape[0],)) < eps
                action = jnp.where(explore, randoms, action)
            return action

        _REF_FNS[rt] = (ref_act, jax.jit(rt._update_once))
    return _REF_FNS[rt]


class FamilyLockstep:
    """Holds every act and every update of a port ``train_iter`` to the
    reference's same computation from the same state and draws: the action
    (exact), and after each update the loss (rtol 1e-5), the net under the
    Adam-sign and tie rules of that update, β (rtol 1e-6), the sum-tree and
    max priority (rtol 1e-5) and the Adam count."""

    def __init__(self, rt, trainer, log: FamilyGradLog):
        self.acts = self.updates = 0
        self.log = log
        ref_act, update_fn = _ref_fns(rt)
        act, update = trainer._act, trainer._update

        def checked_act(net, nobs, noise, env_steps, layers):
            a = act(net, nobs, noise, env_steps, layers)
            want = ref_act(_jax_params(net), _jnp_copy(nobs), noise.k_act, noise.k_eps,
                           noise.k_rand, jnp.asarray(env_steps, jnp.int32))
            np.testing.assert_array_equal(a.numpy(), np.asarray(want), err_msg=f"act {self.acts}")
            self.acts += 1
            return a

        def checked_update(ts, replay, beta, layers):
            net, opt = ts.params, ts.opt_state
            lr = opt.param_groups[0]["lr"]
            ref_in = (_jax_params(net), _jax_params(ts.target_params), _jax_opt(rt, net, opt),
                      _jax_replay(replay), _jnp_copy(beta),
                      ts.noise.peek_update_key(), jnp.asarray(lr, jnp.float32))
            counts0 = {k: np.array(v, copy=True) for k, v in self.log.counts.items()}
            replay, beta, loss = update(ts, replay, beta, layers)
            params, _, ref_replay, ref_beta, ref_loss = jax.device_get(update_fn(*ref_in))
            where = f"update {self.updates}"
            np.testing.assert_allclose(float(loss), float(ref_loss), rtol=RTOL, atol=ATOL,
                                       err_msg=f"loss {where}")
            this_step = {k: v - counts0.get(k, 0) for k, v in self.log.counts.items()}
            assert_params_close(net.state_dict(), _flax(params), lr, this_step, where)
            np.testing.assert_allclose(float(beta), float(ref_beta), rtol=BETA_RTOL, err_msg=where)
            _assert_replay_close(replay, ref_replay, where, tree_rtol=TREE_RTOL)
            self.updates += 1
            return replay, beta, loss

        trainer._act, trainer._update = checked_act, checked_update


# -- Q-network ------------------------------------------------------------------------------
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_qnet_matches_flax(refs, preset, rng):
    """The preset's Q-network from the reference's (perturbed) init: names
    map both ways, and the μ-only, shared-noise and per-row-noise forwards
    agree, with the ε flax drew."""
    rt = refs(preset)
    trainer = V.DQNFamilyTrainer(PRESETS[preset][1](**_kw(preset)), device="cpu")
    net = trainer.make_net()
    obs_dim = rt.venv.env.obs_dim
    variables = rt.net.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))
    variables = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(scale=0.1, size=np.shape(p)), jnp.float32), variables)
    net.load_state_dict(_flax(variables))
    # the trainer's own row counts (batch, envs), so the recorders compile once
    x = jnp.asarray((rng.normal(size=(rt.cfg.batch_size, obs_dim)) * 2).astype(np.float32))
    with torch.no_grad():
        got = net(_t(x)).numpy()
    want = jax.jit(lambda v, x: rt.net.apply(v, x, deterministic=True))(variables, x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    if rt.cfg.noisy:
        for per_sample, rows in ((False, rt.cfg.batch_size), (True, rt.cfg.num_envs)):
            want, eps = record_noise(rt.net, variables, x[:rows], jax.random.PRNGKey(5),
                                     per_sample)
            assert [(a.shape[-1], b.shape[-1]) for a, b in eps] == noisy_layers(net)
            with torch.no_grad():
                got = net(_t(x[:rows]), eps).numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    back = interop.params_to_flax(net.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(variables)):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    # every edge names real layers, and every hidden unit has a consumer
    modules = dict(net.named_modules())
    for producer, consumer, lo, hi, off in net.activation_edges():
        assert 0 <= lo < hi <= modules[producer].out_features
        assert 0 <= lo + off and hi + off <= modules[consumer].in_features


# -- n-step fold -----------------------------------------------------------------------------
def test_nstep_fold_matches_reference(refs, rng):
    """``fold_window`` against ``_fold_window`` on a random [5, 32] window
    with dones (terminations and truncations) at every position, including
    two in one column."""
    rt = refs("rainbow")
    n, b, d = 5, 32, 4
    done = rng.random((n, b)) < 0.25
    done[1, 0] = done[3, 0] = True
    terminated = done & (rng.random((n, b)) < 0.6)
    leaves = (rng.normal(size=(n, b, d)).astype(np.float32),
              rng.integers(0, 2, (n, b)).astype(np.int32),
              rng.normal(size=(n, b)).astype(np.float32),
              rng.normal(size=(n, b, d)).astype(np.float32),
              terminated.astype(np.float32), done.astype(np.float32))
    want = jax.device_get(jax.jit(rt._fold_window)(R.NStepWindow(*map(jnp.asarray, leaves))))
    got = V.fold_window(V.NStepWindow(*map(torch.from_numpy, leaves)), rt.cfg.gamma)
    for f in V.Transition._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "reward":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    # column 0 ends at window step 1: two rewards folded, that step's next obs
    np.testing.assert_allclose(got.reward[0].item(),
                               leaves[2][0, 0] + 0.9 * (1 - done[0, 0]) * leaves[2][1, 0], atol=1e-6)
    np.testing.assert_array_equal(got.next_obs[0].numpy(), leaves[3][1, 0])


# -- the slice as a whole -----------------------------------------------------------------
# A free run carries Adam's amplification forward (test_torch_continuous.py):
# an entry whose step float32 agreement does not fix may end up to 2·lr
# apart, and that would shift every later forward pass. Here it stays small:
# over both iterations of every schedule below the free runs keep the same
# actions, params within 3.6e-7 and replayed obs within 6.4e-6 (FlappyBird's
# normalized obs; CartPole's within 3.6e-7) on the CPU, printed by
# ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dqn_variants.py``.
# So a free run is held like a single update: params and targets to 1e-5
# under the Adam-sign and tie rules counted over the iteration, replay
# floats to TRAJ_ATOL plus 1e-6 relative (FlappyBird's first scaled rewards
# reach ~3e6: the reward scaler's first std is 2.5e-8, the rounding of 16
# equal returns plus 1e-8, as in the reference),
# the sum-tree to rtol 1e-5; actions, flags, counts, syncs and the draw order
# exactly. Every act and update along it is also held from the same state by
# ``FamilyLockstep``.
TRAJ_ATOL = 1e-5
TRAJ_RTOL = 1e-6
# Reference iterations before a late start: three wrap the 64-slot rings;
# FlappyBird's first birds die at step 50, in the sixth iteration.
LATE_WARMUP = {"noisy_dqn_flappybird": 5}


def _late_start(rt, preset):
    jts = rt.init(jax.random.PRNGKey(0))
    for _ in range(LATE_WARMUP.get(preset, 3)):
        jts, _ = rt.train_iter(jts)
    return jts


def _assert_free_run_close(trainer, ts, jts, out, jout, log, where):
    jts = jax.device_get(jts)
    cfg = trainer.cfg
    assert (ts.env_steps, ts.learn_steps) == (int(jts.env_steps), int(jts.learn_steps)), where
    assert int(ts.episodes) == int(jts.episodes), where
    assert int(ts.target_syncs) == int(jts.target_syncs), where
    _assert_replay_close(ts.replay, jts.replay, where, atol=TRAJ_ATOL, rtol=TRAJ_RTOL,
                         tree_rtol=TREE_RTOL)
    lr = cfg.lr  # the decayed lr only shrinks
    for net, ref in (("params", jts.params), ("target_params", jts.target_params)):
        assert_params_close(getattr(ts, net).state_dict(), _flax(ref), lr, log.counts,
                            f"{net} {where}")
    count = int(np.asarray(interop._scale_by_adam_state(jts.opt_state).count))
    assert {int(s["step"]) for s in ts.opt_state.state.values()} == {count}, where
    np.testing.assert_allclose(float(ts.beta), float(jts.beta), rtol=BETA_RTOL, err_msg=where)
    np.testing.assert_allclose(ts.vec_state.obs.numpy(), jts.vec_state.obs, rtol=0,
                               atol=TRAJ_ATOL, err_msg=where)
    if cfg.normalize_obs:
        for f, x in zip(ts.obs_rms._fields, ts.obs_rms):
            np.testing.assert_allclose(x.numpy(), getattr(jts.obs_rms, f), rtol=1e-5, atol=1e-6,
                                       err_msg=f"obs_rms {f} {where}")
    if ts.window is not None:
        for f, x in zip(ts.window._fields, ts.window):
            np.testing.assert_allclose(x.numpy(), getattr(jts.window, f), rtol=0, atol=TRAJ_ATOL,
                                       err_msg=f"window {f} {where}")
    for f in ("ep_done", "ep_length"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                      err_msg=f"{f} {where}")
    np.testing.assert_allclose(out.ep_return.numpy(), np.asarray(jout.ep_return), rtol=1e-5,
                               atol=1e-4, err_msg=where)
    for k in ("loss", "beta"):
        np.testing.assert_allclose(float(out.metrics[k]), float(jout.metrics[k]), rtol=TRAJ_ATOL,
                                   atol=TRAJ_ATOL, err_msg=f"{k} {where}")


@pytest.mark.parametrize("start", ["reset", "late"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_train_iters_match_reference(refs, preset, start):
    """Whole iterations at narrow width with the reference's noise replayed.
    Every act and update along the port's trajectory is held to the
    reference's from the same state (``FamilyLockstep``); each iteration
    starts from the reference's state, the port asks for its draws in the
    reference's order, and the two free runs end with the same actions,
    episode flags, counts and syncs, and floats within TRAJ_ATOL.
    ``reset``: two iterations from the reference's init (rainbow's window
    warms up inside the first). ``late``: two iterations after LATE_WARMUP
    reference iterations — a wrapped ring (and sum-tree), β moved, target
    syncs done, the window warm, episodes ending and autoresets."""
    rt = refs(preset)
    cfg = rt.cfg
    jts = rt.init(jax.random.PRNGKey(0)) if start == "reset" else _late_start(rt, preset)
    if start == "late":
        assert int(jts.replay.size) == cfg.memory_capacity
        assert int(jts.env_steps) > cfg.memory_capacity  # the ring has wrapped
        assert float(jts.beta) > cfg.per_beta0 or not cfg.use_per
        assert int(jts.target_syncs) > 0 or cfg.target_mode == "soft"
    iters = 2
    done = updates = acts = checked = 0
    for it in range(iters):
        trainer, ts, noise = _port(preset, rt, jts)
        lockstep = FamilyLockstep(rt, trainer, FamilyGradLog(ts.params, ts.opt_state))
        size0, learn0 = ts.replay.size, ts.learn_steps
        jts, jout = rt.train_iter(jts)
        ts, out = trainer.train_iter(ts)
        where = f"{preset} {start} iteration {it}"
        sizes, size = [], size0
        for t in range(cfg.steps_per_iter):
            step0 = ts.env_steps - (cfg.steps_per_iter - t) * cfg.num_envs
            if step0 >= (cfg.n_steps - 1) * cfg.num_envs:
                size = min(size + cfg.num_envs, cfg.memory_capacity)
            sizes.append(size)
            if it == 0 and start == "reset" and preset == "rainbow" and t < 5:
                assert size == max(0, t - 3) * cfg.num_envs  # the n-step warm gate
        assert noise.calls == _expected_calls(cfg, sizes), where
        _assert_free_run_close(trainer, ts, jts, out, jout, lockstep.log, where)
        done += int(np.asarray(jout.ep_done).sum())
        updates += ts.learn_steps - learn0
        acts += lockstep.acts
        checked += lockstep.updates
    assert acts == cfg.steps_per_iter * iters
    assert checked == updates > 0
    if start == "late":
        assert done > 0, "episodes should end inside the compared iteration"


# -- interop and checkpoints ---------------------------------------------------------------
@pytest.mark.parametrize("preset", ["rainbow", "noisy_dqn_flappybird"])
def test_train_state_interop_round_trips(refs, preset):
    """A whole reference state after three iterations carried across is the
    reference's to the bit: params (noisy kernels, PReLU slopes), target,
    Adam moments and count, the PER ring and sum-tree or the uniform ring,
    the n-step window, obs statistics, the reward scaler, β and counters,
    and the env batch (FlappyBird's per-env keys dropped)."""
    rt = refs(preset)
    jts = jax.device_get(_late_start(rt, preset))
    trainer, ts, _ = _port(preset, rt, jts)
    for net, ref in (("params", jts.params), ("target_params", jts.target_params)):
        got, want = getattr(ts, net).state_dict(), _flax(ref)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    adam = interop._scale_by_adam_state(jts.opt_state)
    mu = _flax(adam.mu)
    for n, p in ts.params.named_parameters():
        np.testing.assert_array_equal(ts.opt_state.state[p]["exp_avg"].numpy(), mu[n].numpy())
        assert int(ts.opt_state.state[p]["step"]) == int(adam.count)
    back = interop.replay_to_numpy(ts.replay)
    assert (back["pos"], back["size"]) == (int(jts.replay.pos), int(jts.replay.size))
    for f in V.Transition._fields:
        np.testing.assert_array_equal(back["data"][f], getattr(jts.replay.data, f), err_msg=f)
    if rt.cfg.use_per:
        np.testing.assert_array_equal(back["tree"], jts.replay.tree)
        assert float(back["max_priority"]) == float(jts.replay.max_priority)
    if rt.cfg.n_steps > 1:
        for f, x in zip(ts.window._fields, ts.window):
            np.testing.assert_array_equal(x.numpy(), getattr(jts.window, f), err_msg=f)
    for f, x in zip(ts.obs_rms._fields, ts.obs_rms):
        np.testing.assert_array_equal(x.numpy(), getattr(jts.obs_rms, f), err_msg=f)
    scaler = ts.reward_scaler
    np.testing.assert_array_equal(scaler.ret.numpy(), jts.reward_scaler.ret)
    np.testing.assert_array_equal(scaler.rms.std.numpy(), jts.reward_scaler.rms.std)
    assert np.float32(scaler.gamma) == jts.reward_scaler.gamma
    vs = interop.vec_state_to_numpy(ts.vec_state)
    for f in type(ts.vec_state.env_state)._fields:
        np.testing.assert_array_equal(vs["env_state"][f], getattr(jts.vec_state.env_state, f))
    if preset == "noisy_dqn_flappybird":
        assert "key" not in vs["env_state"] and set(FlappyBirdState._fields) < set(
            jts.vec_state.env_state._fields)
    assert (ts.env_steps, ts.learn_steps) == (int(jts.env_steps), int(jts.learn_steps))
    for f in ("episodes", "target_syncs", "beta"):
        assert float(getattr(ts, f)) == float(getattr(jts, f)), f


_TINY = dict(num_envs=4, steps_per_iter=8, batch_size=16, updates_per_step=1, hidden_dim=16,
             pscn_dim=16, trunk_dims=(16, 8, 8), head_hidden=4, memory_capacity=64)


@pytest.mark.parametrize("name", ["ddqn_per_cartpole", "ddqn_per_duel_cartpole",
                                  "noisy_dqn_cartpole", "rainbow_dqn_cartpole",
                                  "noisy_dqn_flappybird"])
def test_cli_workload_trains_in_train_loop_on_cpu(name, tmp_path, monkeypatch, capsys):
    """The workload's trainer, config and solve bar are the reference CLI's;
    a tiny config of the same trainer trains two iterations in TrainLoop
    with eval and a final checkpoint."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([]) == 1
    assert name in capsys.readouterr().out
    trainer, algo, solve = cli.WORKLOADS[name]("cpu")
    ref_trainer, ref_algo, ref_solve = ref_cli.WORKLOADS[name]()
    assert (algo, solve) == (ref_algo, ref_solve)
    assert type(trainer).__name__ == type(ref_trainer).__name__
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(ref_trainer.cfg)
    assert trainer.device == torch.device("cpu")

    small = type(trainer)(dataclasses.replace(trainer.cfg, **_TINY), device="cpu")
    loop = TrainLoop(small, algo, log_metrics=False, log_every=1, eval_every=10 ** 9,
                     save_every=10 ** 9, eval_episodes=1)
    ts, stats = loop.train(64, solve_threshold=solve)
    warm = (small.cfg.n_steps - 1)  # rainbow's first n-1 vector steps push nothing
    assert stats["env_steps"] == ts.env_steps == 64
    assert ts.replay.size == min(4 * (16 - warm), 64)
    assert ts.learn_steps == 16 - warm - 3
    assert len(stats["curve"]) == 2 and not stats["solved"]
    assert (tmp_path / "checkpoints" / f"{algo}_{small.venv.env.name}.pt").exists()
    assert np.isfinite(loop.test(ts, episodes=1))


@pytest.mark.parametrize("preset", ["rainbow", "noisy_dqn_flappybird"])
def test_family_checkpoint_round_trip_and_mismatch_raises(preset, tmp_path):
    """Strict round trip of the family state (window, obs statistics, reward
    scaler, β, counters) with the replay (sum-tree and max priority with it)
    left out and restored fresh, as the reference does; then a mismatch."""
    cfg = PRESETS[preset][1](**{**_kw(preset), "memory_capacity": 64})
    trainer = V.DQNFamilyTrainer(cfg, device="cpu")
    ts, _ = trainer.train_iter(trainer.init(0))
    ts, _ = trainer.train_iter(ts)
    path = save_checkpoint(str(tmp_path / "family.pt"), ts)
    restored = restore_checkpoint(path, trainer.init(1))
    fresh = trainer.init(1).replay
    assert torch.load(path, weights_only=True)["replay"] is None and ts.replay.size > 0
    assert (restored.replay.pos, restored.replay.size, restored.env_steps, restored.learn_steps) \
        == (0, 0, ts.env_steps, ts.learn_steps)
    for part in ("replay", "window", "obs_rms", "reward_scaler"):
        a, b = getattr(restored, part), fresh if part == "replay" else getattr(ts, part)
        if a is None:
            assert b is None
            continue
        for x, y in zip(jax.tree_util.tree_leaves(interop.replay_to_numpy(a) if part == "replay"
                                                  else a),
                        jax.tree_util.tree_leaves(interop.replay_to_numpy(b) if part == "replay"
                                                  else b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=part)
    for f in ("episodes", "target_syncs", "beta"):
        assert float(getattr(restored, f)) == float(getattr(ts, f)), f
    # every other field came back: the next iteration from the same fresh replay is the same
    ts, out = trainer.train_iter(ts._replace(replay=fresh))
    restored, out_r = trainer.train_iter(restored)
    for net in ("params", "target_params"):
        for k, v in getattr(ts, net).state_dict().items():
            torch.testing.assert_close(getattr(restored, net).state_dict()[k], v, rtol=0, atol=0)
    for k in out.metrics:
        torch.testing.assert_close(out_r.metrics[k], out.metrics[k], rtol=0, atol=0)

    other = (dataclasses.replace(cfg, n_steps=1) if preset == "rainbow"
             else V.noisy_dqn_config(**{**_kw("noisy_dqn"), "memory_capacity": 64}))
    with pytest.raises(ValueError, match="window" if preset == "rainbow" else "pscn"):
        restore_checkpoint(path, V.DQNFamilyTrainer(other, device="cpu").init(0))
    # a replay of another capacity is no mismatch: the example's fresh one is kept
    smaller = restore_checkpoint(path, V.DQNFamilyTrainer(
        dataclasses.replace(cfg, memory_capacity=32), device="cpu").init(0))
    assert smaller.replay.data.obs.shape[0] == 32 and smaller.replay.size == 0


def test_pixel_trunk_is_not_ported():
    """The pixel options, which raised before the pixel slice, now build
    (tests/test_torch_pixels_render.py holds them to the JAX package); what
    the JAX package refuses is refused."""
    trainer = V.DQNFamilyTrainer(V.dqn_pixels_config(memory_capacity=8), device="cpu")
    assert trainer.make_net().conv.proj.in_features == 2 * 2 * 32
    assert trainer.init(0).replay.data.obs.dtype == torch.uint8
    with pytest.raises(ValueError, match="trunk"):
        V.DQNFamilyTrainer(V.DQNFamilyConfig(trunk="cnn"), device="cpu").make_net()
    with pytest.raises(ValueError, match="normalize_obs"):
        V.DQNFamilyTrainer(V.DQNFamilyConfig(obs_uint8=True, normalize_obs=True), device="cpu")


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_default_device_without_cuda_raises(preset):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.DQNFamilyTrainer(PRESETS[preset][1](num_envs=2))


def free_run_divergence(preset: str, start: str) -> list[dict]:
    """Largest free-run differences from the reference, per iteration of
    ``test_train_iters_match_reference``'s schedule: the numbers behind
    TRAJ_ATOL."""
    rt = R.DQNFamilyTrainer(PRESETS[preset][0](**_kw(preset)))
    jts = rt.init(jax.random.PRNGKey(0)) if start == "reset" else _late_start(rt, preset)
    rows = []
    for it in range(2):
        trainer, ts, _ = _port(preset, rt, jts)
        jts, _ = rt.train_iter(jts)
        ts, _ = trainer.train_iter(ts)
        ref = jax.device_get(jts)
        got, want = ts.params.state_dict(), _flax(ref.params)
        rows.append({
            "preset": preset, "start": start, "iteration": it,
            "actions_equal": bool(np.array_equal(ts.replay.data.action.numpy(),
                                                 ref.replay.data.action)),
            "obs": float(np.abs(ts.replay.data.obs.numpy() - ref.replay.data.obs).max()),
            "params": max(float(np.abs(got[k].numpy() - want[k].numpy()).max()) for k in want),
        })
    return rows


if __name__ == "__main__":
    for preset in sorted(PRESETS):
        for start in ("reset", "late"):
            for row in free_run_divergence(preset, start):
                print(row)
