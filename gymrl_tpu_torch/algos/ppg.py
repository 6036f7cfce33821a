"""Phasic Policy Gradient with a GRU (counterpart of ``gymrl_tpu/algos/ppg.py``),
the ``ppg_rnn_lunarlander`` workload.

Algorithm parity with reference algorithms/ppg_rnn_lunarlander.py, as the
JAX trainer has it:
  * network: the recurrent PPO net plus an auxiliary value head
    ``aux_critic_fc`` = MLP[32, 1]
  * phase 1: the recurrent-PPO epochs, unchanged
  * phase 2: ``aux_epochs`` epochs minimizing
    ``MSE(v_target, aux_value) + β_clone · clone`` over the same rows, with
    the same Adam. ``clone_target="current"`` (the preset, canonical PPG) is
    the KL from the post-phase-1 distribution, computed once over the whole
    buffer with no gradient; ``"behavior"`` (the reference script) is the
    MSE of the taken action's log-prob against the behaviour policy's.
  * the auxiliary phase runs on iterations ``i`` with
    ``i % aux_every == aux_every − 1`` (``i`` = env steps // T·B, a Python
    int here, so no host sync), every iteration for ``aux_every`` ≤ 1; a
    skipped phase reports zero auxiliary metrics
  * γ = 0.995

Draws: the reference splits its key three ways after collection, phase 1's
permutations from one part and phase 2's from another whether or not the
phase runs, so ``Noise.ppg_permutations`` hands out both sets every
iteration.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gymrl_tpu_torch.algos.base import IterOut, PhaseTimer, masked_mean, pack_fields
from gymrl_tpu_torch.algos.ppo_rnn import (
    PPORNNConfig, PPORNNTrainer, RecurrentActorCritic, RNNTrainState,
)
from gymrl_tpu_torch.nn.layers import MLP


@dataclass(frozen=True)
class PPGConfig(PPORNNConfig):
    gamma: float = 0.995  # ppg_rnn_lunarlander.py:46
    aux_epochs: int = 6
    beta_clone: float = 1.0
    clone_target: str = "current"  # "current" (canonical PPG) | "behavior" (the reference)
    aux_every: int = 8  # the auxiliary phase every N iterations


class PPGActorCritic(RecurrentActorCritic):
    """The recurrent net plus ``aux_critic_fc`` (ppg_rnn_lunarlander.py:143-176).
    ``forward(h, obs) -> (h', logits, value, aux_value)``."""

    def __init__(self, obs_dim: int, n_actions: int, feature_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__(obs_dim, n_actions, feature_dim, generator)
        self.aux_critic_fc = MLP(feature_dim, [32, 1], generator=generator)

    def forward(self, h, obs):
        h, out = self.cell(h, self.encode(obs))
        return (h, *self.heads(out), self.aux_critic_fc(out).squeeze(-1))

    def aux_heads(self, out):
        """Auxiliary-phase heads: (logits, aux value)."""
        return self.actor_fc(out), self.aux_critic_fc(out).squeeze(-1)


class PPGTrainer(PPORNNTrainer):
    def __init__(self, cfg: PPGConfig, device: str | torch.device = "cuda", mesh=None):
        if cfg.clone_target not in ("current", "behavior"):
            raise ValueError(f"clone_target must be 'current' or 'behavior', "
                             f"got {cfg.clone_target!r}")
        super().__init__(cfg, device, mesh)

    def make_net(self, generator: torch.Generator | None = None) -> PPGActorCritic:
        return PPGActorCritic(self.obs_dim, self.n_actions, self.cfg.feature_dim, generator)

    def _apply_cell(self, net, h, x):
        h, logits, value, _ = net(h, x)
        return h, logits, value

    def aux_runs(self, env_steps: int) -> bool:
        """Whether the iteration that starts at ``env_steps`` runs phase 2."""
        cfg = self.cfg
        if cfg.aux_every <= 1:
            return True
        return (env_steps // cfg.batch_total) % cfg.aux_every == cfg.aux_every - 1

    def train_iter(self, ts: RNNTrainState,
                   timer: PhaseTimer | None = None) -> tuple[RNNTrainState, IterOut]:
        """One iteration of both phases; updates the net and optimizer in
        place. ``timer`` gets "rollout", "gae", "sgd" (phase 1) and "aux"
        (phase 2, the anchor included)."""
        cfg = self.cfg
        mark = timer or (lambda phase: None)
        carry, stats, data, packed, spec, pack_metrics = self._rollout_and_data(ts, mark)
        perms1, perms2 = ts.noise.ppg_permutations(cfg.num_epochs, cfg.aux_epochs,
                                                    packed.shape[0])
        metrics = self._epochs(ts, packed, spec, perms1, self._loss)
        mark("sgd")
        if self.aux_runs(ts.env_steps):
            if cfg.clone_target == "current":
                # the anchor: the post-phase-1 distribution over the whole buffer
                with torch.no_grad():  # each rank its share of the rows, then gathered
                    anchor_logits, _ = self._aux_seq_forward(
                        ts.params, self._share(data["h0"]), self._share(data["obs"]))
                    anchor = self._gather(torch.log_softmax(anchor_logits, dim=-1))
                    packed, spec = pack_fields(dict(data, anchor_logp_all=anchor))
            aux = self._epochs(ts, packed, spec, perms2, self._aux_loss)
        else:
            zero = torch.zeros((), device=self.device)
            aux = {"aux_value_loss": zero, "clone_loss": zero.clone()}
        mark("aux")
        return self._finish(ts, carry, stats, metrics | aux | pack_metrics)

    def _aux_seq_forward(self, net, h0, obs_seq):
        """Logits and aux values of the re-unroll (``_seq_forward``'s shape)."""
        return net.aux_heads(net.unroll(h0, obs_seq))

    def _aux_loss(self, net, mb):
        logits, aux_values = self._aux_seq_forward(net, mb["h0"], mb["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        mask = mb["mask"]
        aux_value_loss = masked_mean(torch.square(aux_values - mb["v_target"]), mask,
                                     mesh=self.mesh)
        if self.cfg.clone_target == "current":
            anchor = mb["anchor_logp_all"]
            kl = (torch.exp(anchor) * (anchor - logp_all)).sum(dim=-1)
            clone_loss = masked_mean(kl, mask, mesh=self.mesh)
        else:
            logp = logp_all.gather(-1, mb["action"].long()[..., None]).squeeze(-1)
            clone_loss = masked_mean(torch.square(logp - mb["logp"]), mask, mesh=self.mesh)
        loss = aux_value_loss + self.cfg.beta_clone * clone_loss
        return loss, {"aux_value_loss": aux_value_loss, "clone_loss": clone_loss}


def ppg_rnn_lunarlander_config(**kw) -> PPGConfig:
    """The JAX package's canonical PPG preset: whole-episode BPTT, KL clone
    to the post-phase-1 distribution, the auxiliary phase every 8
    iterations, the flat optimizer."""
    base = dict(env_name="LunarLander-v3", whole_episode_bptt=True,
                episode_rows_per_env=8, seq_minibatch=64, flat_optimizer=True)
    base.update(kw)
    return PPGConfig(**base)
