"""The port's recurrent pieces against the JAX reference: flax's GRU cell,
the MLPRNN cell, the episode packer, store and queue, the hoisted sequence
forward, the recurrent losses, the packed training rows and the interop of
the recurrent nets and of a raveled (flat-optimizer) Adam state.

Both packages run on the CPU, on the same numpy-seeded inputs. Weights are
the reference's own init, perturbed so biases and PReLU slopes are not at
their initial values, carried across with ``interop.params_from_flax``.

Tolerances, each with its reason:
  * GRU and MLPRNN cells, one step: outputs, hidden and grads atol 1e-5 /
    rtol 1e-5 (float32 matmuls of width ≤ 32; ``sigmoid``/``tanh`` round
    differently by an ulp in the two frameworks).
  * the sequence forward over L = 16 steps (hoisted and stepwise, against
    the reference and against each other): logits, values and the last
    hidden atol 1e-5. The GRU's gates keep the carried rounding at the
    rounding of one step (measured: below 2e-6 here).
  * losses and metrics of one minibatch rtol 1e-5; grads rtol 1e-5 plus an
    atol of 1e-5 of each tensor's largest entry (an entry summed from
    terms that cancel keeps the terms' rounding, not its own size).
  * the episode packer, store, clear and queue, packed rows and their
    layout, interop: exact (they move data and count, no arithmetic).
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gymrl_tpu.algos import base as ref_base
from gymrl_tpu.algos.ppg import PPGConfig as RefPPGConfig
from gymrl_tpu.algos.ppg import PPGTrainer as RefPPGTrainer
from gymrl_tpu.algos.ppo_rnn import PPORNNConfig as RefConfig
from gymrl_tpu.algos.ppo_rnn import PPORNNTrainer as RefTrainer
from gymrl_tpu.nn.recurrent import MLPRNNCell as RefMLPRNNCell
from gymrl_tpu.replay import episode as ref_episode
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos.base import pack_fields, unpack_fields
from gymrl_tpu_torch.algos.ppg import PPGConfig, PPGTrainer
from gymrl_tpu_torch.algos.ppo_rnn import PPORNNConfig, PPORNNTrainer
from gymrl_tpu_torch.core.noise import Noise
from gymrl_tpu_torch.nn import initializers as gl_init
from gymrl_tpu_torch.nn.recurrent import GRUCell, MLPRNNCell
from gymrl_tpu_torch.replay import episode

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
# narrow recurrent configs: feature 32, GRU hidden 8
NARROW = dict(feature_dim=32, num_envs=4, rollout_steps=16, seq_len=8, seq_minibatch=4,
              num_epochs=2)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


def perturb(variables, rng, scale=0.1):
    """The reference's init plus N(0, scale²): nonzero biases, slopes off 0.25."""
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(scale=scale, size=np.shape(p)), jnp.float32),
        variables)


def assert_grads_close(got: dict, want: dict, where=""):
    assert set(got) == set(want), where
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=RTOL,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=f"{k} {where}")


# -- cells ----------------------------------------------------------------------------
def test_lecun_normal_matches_flax_distribution():
    """Truncated at ±2σ and of std 1/√fan_in, as flax's variance_scaling."""
    w = torch.empty(512, 64)  # torch [out, in]: fan_in 64
    gl_init.lecun_normal()(w, torch.Generator().manual_seed(0))
    k = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (64, 512)))
    std = 1.0 / np.sqrt(64)
    for x in (w.numpy(), k):
        assert np.abs(x).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6)
        assert abs(x.std() - std) < 0.03 * std


@pytest.mark.parametrize("batch_shape", [(5,), (3, 4)], ids=["rows", "rows_x_time"])
def test_gru_cell_matches_flax(batch_shape, rng):
    """One step of flax's GRUCell: names map (``hr``/``hz`` have no bias),
    and the new hidden and every gradient (params, hidden, input) agree."""
    d_in, hid = 6, 8
    ref = fnn.GRUCell(features=hid)
    h = rng.normal(size=batch_shape + (hid,)).astype(np.float32)
    x = rng.normal(size=batch_shape + (d_in,)).astype(np.float32)
    variables = perturb(ref.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x)), rng)
    cell = GRUCell(d_in, hid, generator=torch.Generator().manual_seed(0))
    assert set(cell.state_dict()) == set(_flax(variables))
    assert "hr.bias" not in cell.state_dict() and "hn.bias" in cell.state_dict()
    cell.load_state_dict(_flax(variables))
    w_out = rng.normal(size=batch_shape + (hid,)).astype(np.float32)

    def ref_loss(v, h, x):
        new_h, out = ref.apply(v, h, x)
        return jnp.sum(new_h * w_out), (new_h, out)

    (_, (want_h, want_out)), (g_v, g_h, g_x) = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(variables, jnp.asarray(h), jnp.asarray(x))
    th, tx = _t(h).requires_grad_(), _t(x).requires_grad_()
    new_h, out = cell(th, tx)
    (new_h * _t(w_out)).sum().backward()
    np.testing.assert_allclose(new_h.detach().numpy(), np.asarray(want_h), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out.detach().numpy(), new_h.detach().numpy())
    assert_grads_close({k: p.grad for k, p in cell.named_parameters()}, _flax(g_v))
    assert_grads_close({"h": th.grad, "x": tx.grad}, {"h": g_h, "x": g_x})


def test_gru_unroll_equals_stepwise_cell(rng):
    """``unroll`` (input maps batched, stacked hidden maps) = L calls of the
    cell, values and gradients."""
    cell = GRUCell(6, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in cell.parameters():
            p.add_(torch.from_numpy(rng.normal(scale=0.1, size=p.shape).astype(np.float32)))
    h0 = _t(rng.normal(size=(3, 8)).astype(np.float32))
    xs = _t(rng.normal(size=(3, 12, 6)).astype(np.float32))
    hs = cell.unroll(h0, xs)
    grads_u = torch.autograd.grad(hs.square().sum(), list(cell.parameters()))
    h, steps = h0, []
    for t in range(12):
        h, _ = cell(h, xs[:, t])
        steps.append(h)
    ref = torch.stack(steps, dim=1)
    grads_s = torch.autograd.grad(ref.square().sum(), list(cell.parameters()))
    torch.testing.assert_close(hs, ref, rtol=0, atol=ATOL)
    for (name, _), a, b in zip(cell.named_parameters(), grads_u, grads_s):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-5 * float(b.abs().max()), msg=name)


def test_mlprnn_cell_matches_flax_and_splits(rng):
    """The reference's MLPRNN: 3/4 linear (no activation) + 1/4 GRU, whose
    quarter of the output IS the new hidden (``test_mlprnn_cell_split``)."""
    ref = RefMLPRNNCell(output_dim=32)
    h = rng.normal(size=(5, 8)).astype(np.float32)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    variables = perturb(ref.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x)), rng)
    cell = MLPRNNCell(12, 32, generator=torch.Generator().manual_seed(0))
    assert cell.initial_state(2).shape == (2, 8) and not cell.initial_state(2).any()
    assert sorted(cell.state_dict()) == sorted(_flax(variables))
    cell.load_state_dict(_flax(variables))
    w_out = rng.normal(size=(5, 32)).astype(np.float32)

    def ref_loss(v):
        new_h, out = ref.apply(v, jnp.asarray(h), jnp.asarray(x))
        return jnp.sum(out * w_out), (new_h, out)

    (_, (want_h, want_out)), g_v = jax.value_and_grad(ref_loss, has_aux=True)(variables)
    new_h, out = cell(_t(h), _t(x))
    (out * _t(w_out)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(new_h.detach().numpy(), np.asarray(want_h), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out[:, 24:].detach().numpy(), new_h.detach().numpy())
    assert_grads_close({k: p.grad for k, p in cell.named_parameters()}, _flax(g_v))
    with pytest.raises(ValueError, match="divisible by 4"):
        MLPRNNCell(12, 30)


# -- the sequence forward and the losses ----------------------------------------------------
@pytest.fixture(scope="module")
def ref_nets():
    """One reference trainer per net (PPO's, PPG's) at the narrow width,
    with its perturbed params."""
    rng = np.random.default_rng(3)
    out = {}
    for kind, cls, cfg in (("ppo", RefTrainer, RefConfig(**NARROW)),
                           ("ppg", RefPPGTrainer, RefPPGConfig(**NARROW))):
        rt = cls(cfg)
        params = perturb(rt.init(jax.random.PRNGKey(0)).params, rng)
        out[kind] = (rt, params)
    return out


def _port_trainer(kind, params, **kw):
    cls, cfg = (PPORNNTrainer, PPORNNConfig) if kind == "ppo" else (PPGTrainer, PPGConfig)
    trainer = cls(cfg(**{**NARROW, **kw}), device="cpu")
    net = trainer.make_net(torch.Generator().manual_seed(0))
    assert set(net.state_dict()) == set(_flax(params))
    net.load_state_dict(_flax(params))
    return trainer, net


def _rows(rng, layout: str, mb=4, L=16, obs_dim=8, rnn=8, n_actions=4):
    """A minibatch of training rows. ``chunk``: full-length rows from
    stored (nonzero) hiddens. ``episode``: zero h0 except the first
    (continuation) row, and each row active for a prefix only."""
    obs = (rng.normal(size=(mb, L, obs_dim)) * 1.5).astype(np.float32)
    h0 = rng.normal(scale=0.5, size=(mb, rnn)).astype(np.float32)
    mask = np.ones((mb, L), np.float32)
    if layout == "episode":
        h0[1:] = 0.0
        for i, n in enumerate(rng.integers(1, L + 1, mb)):
            mask[i, n:] = 0.0
            obs[i, n:] = 0.0
    return obs, h0, mask


@pytest.mark.parametrize("layout", ["chunk", "episode"])
@pytest.mark.parametrize("kind", ["ppo", "ppg"])
def test_seq_forward_hoisted_stepwise_and_reference_agree(ref_nets, kind, layout, rng):
    """The hoisted re-unroll against the port's own step-by-step forward
    and against the reference's ``_seq_forward`` (``_aux_seq_forward`` for
    PPG), and the last hidden against the reference's stepwise carry
    (``tests/test_ppo_rnn.py::test_seq_forward_matches_stepwise_apply``)."""
    rt, params = ref_nets[kind]
    trainer, net = _port_trainer(kind, params)
    obs, h0, _ = _rows(rng, layout)
    with torch.no_grad():
        outs = net.unroll(_t(h0), _t(obs))
        logits, values = trainer._seq_forward(net, _t(h0), _t(obs))
        h, steps = _t(h0), []
        for t in range(obs.shape[1]):
            h, lg, v = trainer._apply_cell(net, h, _t(obs[:, t]))
            steps.append((lg, v))
    step_logits = torch.stack([s[0] for s in steps], 1)
    step_values = torch.stack([s[1] for s in steps], 1)
    torch.testing.assert_close(logits, step_logits, rtol=0, atol=ATOL)
    torch.testing.assert_close(values, step_values, rtol=0, atol=ATOL)
    torch.testing.assert_close(outs[:, -1, -8:], h, rtol=0, atol=ATOL)

    want_logits, want_values = rt._seq_forward(params, jnp.asarray(h0), jnp.asarray(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(want_values), rtol=0, atol=ATOL)
    want_h = jnp.asarray(h0)
    for t in range(obs.shape[1]):
        want_h = rt._apply_cell(params, want_h, jnp.asarray(obs[:, t]))[0]
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)
    if kind == "ppg":
        with torch.no_grad():
            aux_logits, aux_values = trainer._aux_seq_forward(net, _t(h0), _t(obs))
        want_logits, want_aux = rt._aux_seq_forward(params, jnp.asarray(h0), jnp.asarray(obs))
        np.testing.assert_allclose(aux_logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
        np.testing.assert_allclose(aux_values.numpy(), np.asarray(want_aux), rtol=0, atol=ATOL)


def make_minibatch(rt, params, rng, layout="episode"):
    """A minibatch dict on which the clip, the dual clip and the mask all
    act: behaviour log-probs near the current ones, advantages of both
    signs, an anchor distribution near the current one (far enough that
    the KL's gradient is not all cancellation)."""
    obs, h0, mask = _rows(rng, layout)
    mb, L = mask.shape
    logits, _ = rt._seq_forward(params, jnp.asarray(h0), jnp.asarray(obs))
    logp_all = np.asarray(jax.nn.log_softmax(logits))
    action = rng.integers(0, logp_all.shape[-1], (mb, L)).astype(np.int32)
    taken = np.take_along_axis(logp_all, action[..., None], -1)[..., 0]
    return {
        "obs": obs, "h0": h0, "mask": mask, "action": action,
        "logp": (taken + rng.normal(scale=0.4, size=(mb, L))).astype(np.float32),
        "adv": (rng.normal(size=(mb, L)) * 2).astype(np.float32),
        "v_target": (rng.normal(size=(mb, L)) * 3).astype(np.float32),
        "anchor_logp_all": np.asarray(jax.nn.log_softmax(
            logits + rng.normal(scale=0.5, size=logp_all.shape))).astype(np.float32),
    }


@pytest.mark.parametrize("loss", ["ppo", "aux_current", "aux_behavior"])
def test_losses_and_grads_match_reference(ref_nets, loss, rng):
    """The masked dual-clip loss and PPG's auxiliary loss in both clone
    targets, on one minibatch: loss, metrics and every gradient."""
    kind = "ppo" if loss == "ppo" else "ppg"
    rt, params = ref_nets[kind]
    clone = {"aux_behavior": "behavior"}.get(loss, "current")
    if kind == "ppg":
        rt = RefPPGTrainer(RefPPGConfig(**NARROW, clone_target=clone))
    trainer, net = _port_trainer(kind, params, **({"clone_target": clone} if kind == "ppg"
                                                  else {}))
    mb = make_minibatch(rt, params, rng)
    ref_fn = rt._loss if loss == "ppo" else rt._aux_loss
    (want_loss, want_metrics), want_grads = jax.value_and_grad(ref_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in mb.items()})
    port_fn = trainer._loss if loss == "ppo" else trainer._aux_loss
    got_loss, got_metrics = port_fn(net, {k: _t(v) for k, v in mb.items()})
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=RTOL)
    assert set(got_metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(got_metrics[k].detach()), float(v), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    grads = {k: p.grad for k, p in net.named_parameters() if p.grad is not None}
    want = {k: v for k, v in _flax(want_grads).items() if k in grads or np.any(v.numpy())}
    assert_grads_close(grads, want, loss)
    if loss == "ppo":
        with torch.no_grad():
            logits, _ = trainer._seq_forward(net, _t(mb["h0"]), _t(mb["obs"]))
            logp = torch.log_softmax(logits, -1).gather(-1, _t(mb["action"]).long()[..., None])
        ratio = np.exp(logp[..., 0].numpy() - mb["logp"])
        clipped = (np.abs(ratio - 1) > 0.2) & (mb["mask"] > 0)
        assert 0 < clipped.sum() < mb["mask"].sum(), "want clipped and unclipped steps"


# -- packed rows ---------------------------------------------------------------------------
def test_pack_fields_matches_reference_and_round_trips(rng):
    data = {
        "obs": rng.normal(size=(6, 5, 3)).astype(np.float32),
        "action": rng.integers(0, 4, (6, 5)).astype(np.int32),
        "mask": rng.random((6, 5)) < 0.5,
        "h0": rng.normal(size=(6, 8)).astype(np.float32),
    }
    packed, spec = pack_fields({k: _t(v) for k, v in data.items()})
    want, want_spec = ref_base.pack_fields({k: jnp.asarray(v) for k, v in data.items()})
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    assert list(spec) == list(want_spec) == sorted(data)
    assert [s[:3] for s in spec.values()] == [s[:3] for s in want_spec.values()]
    back = unpack_fields(packed[[4, 0, 2]], spec)
    for k, v in data.items():
        assert back[k].dtype == _t(v).dtype, k
        np.testing.assert_array_equal(back[k].numpy(), v[[4, 0, 2]], err_msg=k)
    with pytest.raises(TypeError, match="float32"):
        pack_fields({"x": torch.zeros(2, 2, dtype=torch.int64)})


# -- episode buffer, queue --------------------------------------------------------------------
def _assert_episode_state_equal(st, ref, where=""):
    ref = jax.device_get(ref)
    for k in st.data:
        np.testing.assert_array_equal(st.data[k].numpy(), np.asarray(ref.data[k]),
                                      err_msg=f"{k} {where}")
    for f in ("active", "lengths", "ep_index", "full", "dropped_steps", "dropped_episodes"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f"{f} {where}")


@pytest.mark.parametrize("rows_per_env", [2, 3, 8, 40])
def test_episode_buffer_pack_matches_reference(rows_per_env, rng):
    """A [40, 6] rollout with dones of varying density (one column with
    none, one done at every step): data of three dtypes and widths, active,
    lengths and both dropped counts, exactly; overflow past R counted."""
    T, B = 40, 6
    done = rng.random((T, B)) < np.array([0.0, 0.05, 0.15, 0.3, 0.5, 1.0])
    data = {
        "obs": rng.normal(size=(T, B, 5)).astype(np.float32),
        "action": rng.integers(0, 4, (T, B)).astype(np.int32),
        "h": rng.normal(size=(T, B, 8)).astype(np.float32),
    }
    st = episode.episode_buffer_pack({k: _t(v) for k, v in data.items()},
                                     _t(done.astype(np.float32)), rows_per_env)
    ref = ref_episode.episode_buffer_pack({k: jnp.asarray(v) for k, v in data.items()},
                                          jnp.asarray(done, jnp.float32), rows_per_env)
    _assert_episode_state_equal(st, ref)
    segments = 1 + done[:-1].sum(axis=0)
    assert int(st.dropped_episodes) == np.maximum(segments - rows_per_env, 0).sum()
    assert int(st.active.sum()) + int(st.dropped_steps) == T * B
    if rows_per_env == 40:
        assert int(st.dropped_steps) == 0


def test_episode_buffer_pack_cases_of_the_reference():
    """``tests/test_episode_buffer.py``'s hand-made layouts."""
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    done = torch.tensor([[0, 0], [0, 0], [1, 0], [0, 0], [1, 0], [0, 0]], dtype=torch.float32)
    st = episode.episode_buffer_pack({"x": x}, done, 3)
    assert st.lengths.tolist() == [3, 2, 1, 6, 0, 0]
    assert st.data["x"][0, :3].tolist() == [0.0, 2.0, 4.0]
    assert st.data["x"][3].tolist() == [1.0, 3.0, 5.0, 7.0, 9.0, 11.0]
    assert float(st.data["x"][1, 2:].sum()) == 0.0
    st = episode.episode_buffer_pack({"x": torch.arange(6.0)[:, None]}, torch.ones(6, 1), 2)
    assert st.lengths.tolist() == [1, 1] and st.data["x"][:, 0].tolist() == [0.0, 1.0]
    assert (int(st.dropped_episodes), int(st.dropped_steps)) == (4, 4)


def test_episode_buffer_store_and_clear_match_reference(rng):
    """Sequential stores with dones that wrap the rows: every field after
    every store, then clear."""
    example = {"r": torch.zeros(()), "a": torch.zeros(2, dtype=torch.int32)}
    st = episode.episode_buffer_init(example, n_episodes=3, max_steps=6)
    ref = ref_episode.episode_buffer_init({"r": jnp.zeros(()), "a": jnp.zeros(2, jnp.int32)},
                                          3, 6)
    for i in range(16):
        done = bool(rng.random() < 0.35) or i in (4, 9)
        r, a = float(i), rng.integers(0, 9, 2).astype(np.int32)
        st = episode.episode_buffer_store(st, {"r": r, "a": _t(a)}, done)
        ref = ref_episode.episode_buffer_store(ref, {"r": jnp.asarray(r), "a": jnp.asarray(a)},
                                               done)
        _assert_episode_state_equal(st, ref, f"store {i}")
    assert bool(st.full)
    st, ref = episode.episode_buffer_clear(st), ref_episode.episode_buffer_clear(ref)
    _assert_episode_state_equal(st, ref, "clear")


def test_queue_and_state_ring_match_reference():
    """FIFO ring: contents, pos and size after an overflow; samples come
    from the kept items (``tests/test_episode_buffer.py``'s queue test)."""
    st = episode.queue_init({"x": torch.zeros(())}, capacity=4)
    ref = ref_episode.queue_init({"x": jnp.zeros(())}, capacity=4)
    for i in range(6):
        st = episode.queue_push(st, {"x": float(i)})
        ref = ref_episode.queue_push(ref, {"x": jnp.asarray(float(i))})
    np.testing.assert_array_equal(st.data["x"].numpy(), np.asarray(ref.data["x"]))
    assert (st.pos, st.size) == (int(ref.pos), int(ref.size)) == (2, 4)
    batch = episode.queue_sample(st, Noise("cpu", 0), 16)
    assert set(batch["x"].tolist()) <= {2.0, 3.0, 4.0, 5.0}
    assert episode.StateRing is episode.QueueState
    assert episode.state_ring_sample is episode.queue_sample


# -- interop --------------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ppo", "ppg"])
def test_recurrent_net_params_map_both_ways(ref_nets, kind):
    """Every flax leaf of the recurrent nets has its torch parameter (no
    bias on ``rnn.gru.hr``/``hz``; ``rnn.rnn_linear.layer_0`` an ordinary
    Dense), and back to the bit."""
    _, params = ref_nets[kind]
    _, net = _port_trainer(kind, params)
    names = set(net.state_dict())
    assert {"rnn.gru.hr.weight", "rnn.gru.in.bias", "rnn.rnn_linear.layer_0.weight",
            "fc_head.mlp_3.act_0.negative_slope"} <= names
    assert "rnn.gru.hr.bias" not in names and "rnn.gru.hz.bias" not in names
    assert ("aux_critic_fc.layer_1.bias" in names) == (kind == "ppg")
    back = interop.params_to_flax(net.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(params)):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_flat_adam_state_loads_and_ravels_back(ref_nets, rng):
    """The reference's flat-optimizer Adam state (its optax chain over the
    one raveled vector, stepped twice with random gradients) loads into the
    port's Adam, each moment on its parameter by name, and ravels back to
    the bit."""
    rt, params = ref_nets["ppg"]
    params = jax.device_get(params)
    flat, unravel = ravel_pytree(params)
    np.testing.assert_array_equal(interop.ravel_flax(params), np.asarray(flat))
    opt_state = rt.tx.init(flat)
    for _ in range(2):
        grads = jnp.asarray(rng.normal(size=flat.shape).astype(np.float32))
        _, opt_state = rt.tx.update(grads, opt_state, flat)
    adam = interop._scale_by_adam_state(jax.device_get(opt_state))
    assert np.ndim(adam.mu) == 1
    trainer, net = _port_trainer("ppg", params, flat_optimizer=True)
    opt = trainer.init(0).opt_state
    opt = type(opt)(list(net.parameters()), **opt.defaults)
    interop.load_adam_state(opt, net, jax.device_get(opt_state))
    mu, nu = _flax(unravel(jnp.asarray(adam.mu))), _flax(unravel(jnp.asarray(adam.nu)))
    for n, p in net.named_parameters():
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), mu[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(), nu[n].numpy(),
                                      err_msg=n)
        assert int(opt.state[p]["step"]) == int(adam.count) == 2
    count, mu_back, nu_back = interop.adam_state_to_flax(opt, net, flat=True)
    assert count == 2
    np.testing.assert_array_equal(mu_back, np.asarray(adam.mu))
    np.testing.assert_array_equal(nu_back, np.asarray(adam.nu))
    with pytest.raises(ValueError, match="entries"):
        interop.unravel_flax(np.asarray(adam.mu)[:-1], params)


def test_flat_and_per_leaf_adam_agree():
    """``test_rnn_flat_optimizer_matches_pytree``'s point: the flat
    optimizer (one foreach Adam) is a representation change only — two
    iterations from one seed end with the same params."""
    states = []
    for flat in (True, False):
        trainer = PPORNNTrainer(PPORNNConfig(**NARROW, env_name="CartPole-v1",
                                             flat_optimizer=flat), device="cpu")
        ts = trainer.init(11)
        for _ in range(2):
            ts, _ = trainer.train_iter(ts)
        states.append(ts.params.state_dict())
    for k, v in states[0].items():
        torch.testing.assert_close(v, states[1][k], rtol=0, atol=ATOL, msg=k)
