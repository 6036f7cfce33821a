"""The port's mHC family pieces against the JAX reference: ``RMSNorm``,
Sinkhorn-Knopp, the mHC fuse / block / backbone, the URNN cell (flax's GRU
and OptimizedLSTM behind one packed hidden), ppo_full's ``SiluRMSMLP``, both
actor-critics (mHC and PSCN backbones), both trainers' losses, clip-cov's
``cov_drop_mask`` and the interop of both parameter trees.

Both packages run on the CPU, on the same numpy-seeded inputs. Weights are
the reference's own init perturbed by N(0, 0.1²) (so ``w`` is nonzero, β,
α, the norm scales and biases off their initial values), carried across
with ``interop.params_from_flax``.

Tolerances, each with its reason:
  * forwards (RMSNorm, Sinkhorn's P, u, v, the fuse maps, the block, the
    backbone, the cells, the MLP, the nets): rtol 1e-5 plus atol 1e-5
    (float32; ``exp``, ``sigmoid``, ``tanh`` and the norms round by an ulp
    differently in the two frameworks, and XLA contracts ``a*b + c``).
  * the cells unrolled over L steps against L calls of the cell: atol 1e-5
    (the same kernels in another grouping; measured below 1e-6).
  * losses and their metrics: rtol 1e-5 (atol 1e-7 for metrics near 0).
  * gradients: rtol 1e-5 plus an atol of 1e-5 of each tensor's largest
    entry (an entry summed from terms that cancel keeps the terms'
    rounding, not its own size).
  * ``cov_drop_mask`` from the same uniforms, the parameter trees and their
    names: exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gymrl_tpu.algos import ppo_full as RF
from gymrl_tpu.algos import ppo_lstm as RL
from gymrl_tpu.nn import layers as ref_layers
from gymrl_tpu.nn import mhc as ref_mhc
from gymrl_tpu.nn.recurrent import URNNCell as RefURNNCell
from gymrl_tpu_torch import interop
from gymrl_tpu_torch.algos import ppo_full as PF
from gymrl_tpu_torch.algos import ppo_lstm as PL
from gymrl_tpu_torch.nn import mhc
from gymrl_tpu_torch.nn.layers import RMSNorm
from gymrl_tpu_torch.nn.recurrent import URNNCell

from test_torch_recurrent import assert_grads_close, perturb

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _flax(tree):
    return interop.params_from_flax(jax.device_get(tree))


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def _port_module(module, variables):
    """``module`` with the reference's ``variables`` loaded by name (every
    leaf, no extra torch parameter)."""
    state = _flax(variables)
    assert set(module.state_dict()) == set(state)
    module.load_state_dict(state)
    return module


def _ref_grads(apply, variables, args, w_out):
    """Outputs of ``apply(variables, *args)`` and the gradients of
    ``Σ out·w_out`` with respect to the variables and the args."""
    def loss(v, *a):
        out = apply(v, *a)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, w_out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args) + 1)),
                                                 has_aux=True))(variables, *map(jnp.asarray, args))
    return out, grads


def _port_grads(module, args, w_out):
    targs = [_t(a).requires_grad_() for a in args]
    out = module(*targs)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o * _t(w)).sum() for o, w in zip(outs, w_out)).backward()
    grads = {k: p.grad for k, p in module.named_parameters() if p.grad is not None}
    return out, grads, [a.grad for a in targs]


def _check_module(ref, module, variables, args, rng, where=""):
    """Forward and every gradient of ``module`` against the flax ``ref``."""
    out_ref = jax.eval_shape(ref.apply, variables, *map(jnp.asarray, args))
    outs_ref = out_ref if isinstance(out_ref, tuple) else (out_ref,)
    w_out = [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs_ref]
    want_out, want_grads = _ref_grads(ref.apply, variables, args, w_out)
    out, grads, arg_grads = _port_grads(module, args, w_out)
    outs = out if isinstance(out, tuple) else (out,)
    wants = want_out if isinstance(want_out, tuple) else (want_out,)
    for i, (o, w) in enumerate(zip(outs, wants)):
        _close(o.detach().numpy(), w, f"output {i} {where}")
    want_params = {k: v for k, v in _flax(want_grads[0]).items() if k in grads or v.any()}
    assert_grads_close(grads, want_params, where)
    assert_grads_close({i: g for i, g in enumerate(arg_grads)},
                       {i: g for i, g in enumerate(want_grads[1:])}, f"inputs {where}")


# -- RMSNorm, SiluRMSMLP ---------------------------------------------------------------
@pytest.mark.parametrize("eps", [1e-8, 1e-6])
def test_rmsnorm_matches_flax(eps, rng):
    """``scale`` named as flax's and starting at ones; the float32
    ``rsqrt(mean(x²) + eps)``; forward and grads."""
    x = (rng.normal(size=(5, 3, 16)) * np.array([1e-3, 1.0, 30.0])[:, None]).astype(np.float32)
    ref = ref_layers.RMSNorm(eps=eps)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    fresh = RMSNorm(16, eps=eps)
    assert fresh.eps == eps and torch.equal(fresh.scale, torch.ones(16))
    assert RMSNorm(16).eps == 1e-8  # flax's default
    variables = perturb(variables, rng)
    _check_module(ref, _port_module(fresh, variables), variables, [x], rng, f"eps {eps}")


def test_silu_rms_mlp_matches_flax_and_head_gain(rng):
    """Orthogonal √2 hidden layers, RMSNorm(1e-6) between them, the head's
    gain: a 0.001 head starts tiny (``test_silu_rms_mlp_head_gain``)."""
    ref = RF.SiluRMSMLP((32, 16, 4), last_std=0.001)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    fresh = PF.SiluRMSMLP(8, (32, 16, 4), last_std=0.001,
                          generator=torch.Generator().manual_seed(0))
    assert float(fresh.fc2.weight.detach().abs().max()) < 0.01
    assert abs(float(torch.linalg.matrix_norm(fresh.fc0.weight.detach(), 2)) - np.sqrt(2.0)) < 1e-4
    assert sorted(fresh.state_dict()) == sorted(_flax(variables))
    variables = perturb(variables, rng)
    _check_module(ref, _port_module(fresh, variables), variables, [x], rng)


# -- Sinkhorn and the mHC modules ------------------------------------------------------------
@pytest.mark.parametrize("n,iters", [(2, 10), (4, 5), (2, 100)])
def test_sinkhorn_matches_reference(n, iters, rng):
    """``(P, u, v)`` of the reference's ``sinkhorn_knopp`` on ``exp`` of
    normal logits (the mHC's own inputs; spread ×2 where the iterations are
    few); doubly stochastic after 100 iterations
    (``test_sinkhorn_doubly_stochastic``)."""
    spread = 1.0 if iters == 100 else 2.0
    A = np.exp(spread * rng.normal(size=(64, n, n))).astype(np.float32)
    got = mhc.sinkhorn_knopp(_t(A), iters)
    want = ref_mhc.sinkhorn_knopp(jnp.asarray(A), iters)
    for name, g, w in zip("Puv", got, want):
        _close(g.numpy(), w, name)
    if iters == 100:
        P = got[0].numpy()
        np.testing.assert_allclose(P.sum(-1), 1.0, atol=1e-4)
        np.testing.assert_allclose(P.sum(-2), 1.0, atol=1e-4)


def _mhc_case(kind, rng):
    """(flax module, port module, perturbed variables, input) for one mHC piece."""
    if kind == "fuse":
        ref, port = ref_mhc.MHCFuse(16, 2, 10), mhc.MHCFuse(16, 2, 10)
        x = rng.normal(size=(7, 2, 16)).astype(np.float32)
    elif kind == "block":
        ref, port = ref_mhc.MHCBlock(16, 2, 10), mhc.MHCBlock(16, 2, 10)
        x = rng.normal(size=(7, 2, 16)).astype(np.float32)
    else:
        ref = ref_mhc.MHCBackbone(32, rate=2, num_layers=2, sk_iters=5)
        port = mhc.MHCBackbone(8, 32, rate=2, num_layers=2, sk_iters=5)
        x = (rng.normal(size=(7, 8)) * 2.0).astype(np.float32)
    # w nonzero: the maps then depend on the state, not on β alone
    variables = perturb(ref.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    return ref, _port_module(port, variables), variables, x


@pytest.mark.parametrize("kind", ["fuse", "block", "backbone"])
def test_mhc_modules_match_flax(kind, rng):
    """The fuse's three maps, a block and the backbone from carried params
    with nonzero ``w``: outputs and every gradient, the stop-gradient
    Sinkhorn re-applied through ``A`` as the reference has it."""
    ref, port, variables, x = _mhc_case(kind, rng)
    _check_module(ref, port, variables, [x], rng, kind)


def test_mhc_fuse_init_and_parameters():
    """The parameters' shapes and initial values (``w`` zero, α 0.01, β
    0.01 then ±2, norm weight ones) equal flax's init; at init the maps
    are β's: H_pre ≈ 0.5, H_post ≈ 1, H_res diagonal > 0.8
    (``test_mhc_fuse_identity_bias_at_init``)."""
    ref = ref_mhc.MHCFuse(16, 2, 10)
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 2, 16)))
    want = _flax(ref.init(jax.random.PRNGKey(1), jnp.asarray(h)))
    fuse = mhc.MHCFuse(16, 2, 10)
    for k, v in fuse.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    H_pre, H_post, H_res = fuse(_t(h))
    np.testing.assert_allclose(H_pre.detach().numpy(), 0.5, atol=0.02)
    np.testing.assert_allclose(H_post.detach().numpy(), 1.0, atol=0.03)
    assert (H_res[:, [0, 1], [0, 1]] > 0.8).all()


def test_stop_gradient_sinkhorn_differs_from_full_backprop(rng):
    """The reference re-applies Sinkhorn's ``u, v`` differentiably through
    ``A`` only. Backpropagating through the Sinkhorn loop as well gives
    other gradients: the port must equal the former and differ from the
    latter."""
    ref, port, variables, x = _mhc_case("fuse", rng)
    w_res = _t(rng.normal(size=(7, 2, 2)).astype(np.float32))

    def res_grads(full: bool):
        port.zero_grad()
        h = _t(x)
        if full:  # the fuse's H_res logits, then a Sinkhorn loop under autograd
            n = port.rate
            H = (port.norm_weight * h.reshape(7, -1)) @ port.w
            r = torch.linalg.vector_norm(h.reshape(7, -1), dim=-1, keepdim=True) / np.sqrt(32.0)
            A = torch.exp((H[:, 2 * n:] / (r + 1e-6) * port.alpha[2]
                           + port.beta[2 * n:]).reshape(7, n, n))
            H_res = mhc.sinkhorn_knopp(A, port.sk_iters)[0]
        else:
            H_res = port(h)[2]
        (H_res * w_res).sum().backward()
        return {k: p.grad.clone() for k, p in port.named_parameters()}

    stopped, full = res_grads(False), res_grads(True)
    _, g_ref = jax.value_and_grad(
        lambda v: jnp.sum(ref.apply(v, jnp.asarray(x))[2] * w_res.numpy()))(variables)
    want = _flax(g_ref)
    assert_grads_close({k: stopped[k] for k in ("w", "alpha", "beta")},
                       {k: want[k] for k in ("w", "alpha", "beta")})
    diff = float((stopped["beta"] - full["beta"]).abs().max())
    assert diff > 1e-3 * float(stopped["beta"].abs().max()), diff


# -- the URNN cell ------------------------------------------------------------------------
@pytest.mark.parametrize("cell_type", ["gru", "lstm"])
def test_urnn_cell_matches_flax(cell_type, rng):
    """One step of the reference's URNNCell: flax's names (``lstm/if`` and the
    other input kernels without bias, ``hi``..``ho`` with), the packed
    ``[h | c]`` carry, the new packed hidden, the output and every gradient."""
    hid, d_in = 8, 6
    ref = RefURNNCell(hid, cell_type)
    packed = rng.normal(scale=0.5, size=(5, ref.packed_size)).astype(np.float32)
    x = rng.normal(size=(5, d_in)).astype(np.float32)
    variables = perturb(ref.init(jax.random.PRNGKey(0), jnp.asarray(packed), jnp.asarray(x)), rng)
    cell = URNNCell(d_in, hid, cell_type, generator=torch.Generator().manual_seed(0))
    assert cell.packed_size == ref.packed_size
    assert cell.initial_state(3).shape == (3, ref.packed_size)
    names = set(cell.state_dict())
    if cell_type == "lstm":
        assert {"lstm.if.weight", "lstm.hf.bias"} <= names and "lstm.if.bias" not in names
    _check_module(ref, _port_module(cell, variables), variables, [packed, x], rng, cell_type)
    with pytest.raises(ValueError, match="cell_type"):
        URNNCell(d_in, hid, "rnn")


@pytest.mark.parametrize("cell_type", ["gru", "lstm"])
def test_urnn_unroll_equals_stepwise_cell(cell_type, rng):
    """``unroll`` (input maps batched over all steps) = L calls of the cell:
    outputs, the last packed hidden, and the gradients."""
    cell = URNNCell(6, 8, cell_type, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in cell.parameters():
            p.add_(_t(rng.normal(scale=0.1, size=p.shape).astype(np.float32)))
    packed = _t(rng.normal(scale=0.5, size=(3, cell.packed_size)).astype(np.float32))
    xs = _t(rng.normal(size=(3, 12, 6)).astype(np.float32))
    outs, last = cell.unroll(packed, xs)
    grads_u = torch.autograd.grad(outs.square().sum() + last.sum(), list(cell.parameters()))
    h, steps = packed, []
    for t in range(12):
        h, out = cell(h, xs[:, t])
        steps.append(out)
    ref = torch.stack(steps, dim=1)
    grads_s = torch.autograd.grad(ref.square().sum() + h.sum(), list(cell.parameters()))
    torch.testing.assert_close(outs, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(last, h, rtol=0, atol=ATOL)
    for (name, _), a, b in zip(cell.named_parameters(), grads_u, grads_s):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-5 * float(b.abs().max()), msg=name)


# -- the actor-critics ------------------------------------------------------------------------
NET_CASES = {
    "full_mhc": dict(use_mhc=True),
    "full_pscn": dict(use_mhc=False),
    "lstm_gru_mhc": dict(use_mhc=True, rnn_cell="gru"),
    "lstm_lstm_pscn": dict(use_mhc=False, rnn_cell="lstm"),
}
_LSTM_KW = dict(mhc_dim=32, mhc_sk_it=5, rnn_hidden=16, rnd_embed=64)


def net_pair(case, rng, obs_dim=8, n_actions=4):
    """The reference net of ``case``, its perturbed variables, and the port's
    net with them loaded."""
    kw = NET_CASES[case]
    gen = torch.Generator().manual_seed(0)
    obs = jnp.zeros((1, obs_dim))
    if case.startswith("full"):
        ref = RF.FullActorCritic(n_actions, kw["use_mhc"], 32, 2, 2, 5)
        variables = ref.init(jax.random.PRNGKey(0), obs)
        port = PF.FullActorCritic(obs_dim, n_actions, kw["use_mhc"], 32, 2, 2, 5, gen)
    else:
        cfg = dict(_LSTM_KW, **kw)
        ref = RL.LSTMActorCritic(n_actions, RL.PPOLSTMConfig(**cfg))
        h0 = jnp.zeros((1, ref.packed_hidden))
        variables = ref.init(jax.random.PRNGKey(0), h0, obs)
        port = PL.LSTMActorCritic(obs_dim, n_actions, PL.PPOLSTMConfig(**cfg), gen)
    variables = perturb(variables, rng)
    return ref, variables, _port_module(port, variables)


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_actor_critics_match_flax(case, rng):
    """Both nets with the mHC and the PSCN backbones, one step: every output
    (logits, value; for ppo_lstm the new packed hidden and the RND pair)
    and every gradient; the RND target gets none."""
    ref, variables, port = net_pair(case, rng)
    obs = (rng.normal(size=(6, 8)) * 1.5).astype(np.float32)
    if case.startswith("full"):
        _check_module(ref, port, variables, [obs], rng, case)
        return
    h = rng.normal(scale=0.5, size=(6, ref.packed_hidden)).astype(np.float32)
    _check_module(ref, port, variables, [h, obs], rng, case)
    port.zero_grad()
    _, _, _, predict, target = port(_t(h), _t(obs))
    (predict - target).square().mean().backward()
    assert all(p.grad is None for p in port.rnd.target.parameters())
    assert all(p.grad is not None for p in port.rnd.predictor.parameters())


def test_cov_drop_mask_matches_reference(rng):
    """The same uniforms (``jax.random.uniform`` of the reference's key) give
    the reference's mask exactly: its hand-made cases
    (``test_cov_drop_mask_exact_count``: two of five in band dropped, the
    max(·, 1) floor, nothing in band) and 1024 random covariances with
    exact band-edge values (not in band) and repeated values; the count
    dropped is ``min(max(int(n_in·ratio), 1), n_in)`` in float32."""
    small = np.array([0.5, 2.0, 3.0, 4.0, 10.0, -1.0, 2.5, 3.5], np.float32)
    big = rng.normal(scale=2.0, size=1024).astype(np.float32)
    big[:40] = 1.0
    big[40:80] = 5.0
    big[80:200] = 2.0
    cases = [(small, 0.5, 1.0, 5.0), (small, 0.01, 1.0, 5.0), (small, 0.5, 100.0, 200.0),
             (big, 0.2, 1.0, 5.0), (big, 0.2, 0.0, 5.0), (big, 1.0, -1.0, 1.0)]
    for seed in range(4):
        for covs, ratio, lo, hi in cases:
            key = jax.random.PRNGKey(seed)
            u = jax.random.uniform(key, covs.shape)
            want = np.asarray(RF.cov_drop_mask(key, jnp.asarray(covs), ratio, lo, hi))
            got = PF.cov_drop_mask(_t(u), _t(covs), ratio, lo, hi).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{ratio} {lo} {hi}")
            n_in = int(((covs > lo) & (covs < hi)).sum())
            drop = min(max(int(np.float32(n_in) * np.float32(ratio)), 1), n_in)
            assert int((got == 0).sum()) == drop
            assert (got[(covs <= lo) | (covs >= hi)] == 1.0).all()


# -- interop ------------------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["full_mhc", "lstm_gru_mhc", "lstm_lstm_pscn"])
def test_net_params_map_both_ways(case, rng):
    """Every flax leaf has its torch parameter by name (``shared/block_0/
    mhc1/w`` stays ``[N·D, N²+2N]``, ``rnn/lstm/if/kernel`` and the RND
    target's leaves included), and the port's state maps back to the bit."""
    _, variables, port = net_pair(case, rng)
    names = set(port.state_dict())
    if "mhc" in case:
        assert {"shared.block_0.mhc1.w", "shared.block_1.mhc2.norm_weight",
                "shared.final_norm.scale", "shared.input_proj.weight"} <= names
        assert tuple(port.shared.block_0.mhc1.w.shape) == (64, 8)
    if case.startswith("lstm"):
        assert "rnd.target.mlp_0.layer_0.weight" in names and "actor.norm0.scale" in names
    if case == "lstm_lstm_pscn":
        assert "rnn.lstm.if.weight" in names and "shared.mlp_4.act_0.negative_slope" in names
    back = interop.params_to_flax(port.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(variables)):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


# -- the losses ------------------------------------------------------------------------------
def _trainers(case):
    """The reference and port trainers whose nets are ``net_pair(case)``'s
    (LunarLander: 8 observations, 4 actions)."""
    kw = NET_CASES[case]
    if case.startswith("full"):
        cfg = dict(mhc_dim=32, mhc_sk_it=5, **kw)
        return (RF.PPOFullTrainer(RF.PPOFullConfig(**cfg)),
                PF.PPOFullTrainer(PF.PPOFullConfig(**cfg), device="cpu"))
    cfg = dict(_LSTM_KW, **kw)
    return (RL.PPOLSTMTrainer(RL.PPOLSTMConfig(**cfg)),
            PL.PPOLSTMTrainer(PL.PPOLSTMConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_losses_and_grads_match_reference(case, rng):
    """Each trainer's loss on a minibatch where every switch acts: old
    entropies ×U(0.9, 1.1), so ERC masks about 40%; behaviour log-probs
    ±0.4 off, so the clip-higher band and dual-clip variant (b) act;
    advantages of both signs; a random clip-cov keep mask (ppo_full,
    whose ERC and clip-cov multiply into plain means); old values near the
    returns, so the asymmetric value clip acts (ppo_lstm, whose means are
    ``masked_mean``s, plus the RND loss). Loss, metrics and every gradient
    against the reference's ``_loss``; the RND target gets no gradient."""
    _, params, net = net_pair(case, rng)
    rt, trainer = _trainers(case)
    full = case.startswith("full")
    lead = (32,) if full else (16, 4)
    mb = {"obs": (rng.normal(size=lead + (8,)) * 1.5).astype(np.float32)}
    if not full:
        mb["h0"] = np.tanh(rng.normal(size=(16, net.packed_hidden))).astype(np.float32)
    logits = jax.jit(lambda p, m: rt.net.apply(p, m["obs"])[0] if full
                     else rt._seq_forward(p, m["h0"], m["obs"])[0])(params, mb)
    logp_all = np.asarray(jax.nn.log_softmax(logits))
    action = rng.integers(0, 4, lead).astype(np.int32)
    ret = (rng.normal(size=lead) * 3).astype(np.float32)
    mb.update(
        action=action,
        logp=(np.take_along_axis(logp_all, action[..., None], -1)[..., 0]
              + rng.normal(scale=0.4, size=lead)).astype(np.float32),
        old_entropy=(-(np.exp(logp_all) * logp_all).sum(-1)
                     * rng.uniform(0.9, 1.1, lead)).astype(np.float32),
        adv=(rng.normal(size=lead) * 2).astype(np.float32), ret=ret)
    if full:
        mb["cov_keep"] = (rng.random(lead) > 0.2).astype(np.float32)
    else:
        mb["old_value"] = (ret + rng.normal(scale=0.4, size=lead)).astype(np.float32)
    ent_coef = 0.013
    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(rt._loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in mb.items()}, ent_coef)
    got_loss, got_metrics = trainer._loss(net, {k: _t(v) for k, v in mb.items()}, ent_coef)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=RTOL)
    assert set(got_metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(got_metrics[k].detach()), float(v), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    assert 0.2 < float(want_metrics["erc_clip_frac"]) < 0.8
    assert float(want_metrics["clip_frac"]) > 0
    grads = {k: p.grad for k, p in net.named_parameters() if p.grad is not None}
    want = {k: v for k, v in _flax(want_grads).items() if k in grads or np.any(v.numpy())}
    assert_grads_close(grads, want, case)
    if not full:
        assert not any(k.startswith("rnd.target.") for k in grads)
        assert all(k in grads for k in want if k.startswith("rnd.predictor."))
