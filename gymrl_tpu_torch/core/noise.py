"""The port's random source: the counterpart of a ``jax.random`` key.

The JAX trainers thread a key through their train state and split it for
every draw. Here one ``Noise`` object owns a ``torch.Generator`` on the
trainer's device and hands out every draw the main path makes:

  * the Gumbel noise of categorical action sampling (``gumbel``: PPO, the
    recurrent family and discrete SAC),
  * the environment's draws for a batched reset or step (``env_reset`` /
    ``env_step``, which ask the env what it needs),
  * the per-epoch minibatch permutations (``permutations``; PPG's two
    phases' together, ``ppg_permutations``) and full-tricks PPO's clip-cov
    uniforms (``cov_uniforms``),
  * DQN's ε-greedy draws (``explore``),
  * replay indices (``replay_indices``) and PER's stratified uniforms
    (``per_uniforms``),
  * the NoisyNet ε of a noisy forward, for acting (``noisy_act``: one
    draw per batch row) and for an update's online forwards
    (``noisy_update``: one shared draw per forward),
  * standard normals, one method per purpose: exploration noise of a
    deterministic actor and the SAC actor's sample (``action_noise``),
    TD3's target-policy smoothing (``target_noise``), and the two SAC
    update samples (``sac_update_noise``).

Nothing else in the port draws random numbers, so a test can hand a trainer
an object with these methods that replays the JAX reference's own key
splits, and compare the two frameworks draw for draw. A method is asked for
where the reference splits the key it draws from, so the order of the calls
is the order of the reference's splits.

``ShardedNoise`` is one data rank's view of a noise source that every rank
of a mesh holds, seeded the same: a draw for rows of the env batch or of a
learner minibatch (a method marked ``@per_row`` here) is made at the global
shape and the rank keeps its own rows, so a sharded run draws exactly what
the unsharded run draws. Every unmarked draw is global.
"""

from __future__ import annotations

import torch

from gymrl_tpu_torch.distributed.mesh import map_tensors

# float32 tiny: the lower end of jax.random.gumbel's uniform (mode "low").
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def per_row(rows_arg: int):
    """Marks a draw whose leading axis is rows of the env batch or of a
    minibatch share; argument ``rows_arg`` is their count or the draw's
    shape. ``ShardedNoise`` makes such a draw for every rank's rows and
    keeps its own."""
    def mark(fn):
        fn.rows_arg = rows_arg
        return fn
    return mark


class Noise:
    def __init__(self, device: str | torch.device, seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    # -- primitive draws -----------------------------------------------------
    def uniform(self, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u * (high - low) + low

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        """int32 in ``[low, high)`` — ``jax.random.randint``'s bounds."""
        return torch.randint(low, high, shape, generator=self.generator,
                             device=self.device, dtype=torch.int32)

    # -- what the main path asks for -----------------------------------------
    @per_row(0)
    def gumbel(self, shape) -> torch.Tensor:
        """Standard Gumbel, ``-log(-log(u))`` with ``u ~ U[tiny, 1)``, as
        ``jax.random.gumbel`` computes it."""
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return -torch.log(-torch.log(u.clamp_(min=_F32_TINY)))

    def permutations(self, count: int, n: int) -> torch.Tensor:
        """``[count, n]`` int64: one independent permutation of ``n`` per row."""
        return torch.stack([
            torch.randperm(n, generator=self.generator, device=self.device)
            for _ in range(count)
        ])

    def ppg_permutations(self, count1: int, count2: int,
                         n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """PPG's two sets of epoch permutations, ``[count1, n]`` for the
        policy phase and ``[count2, n]`` for the auxiliary phase, drawn
        together every iteration (the reference splits its key three ways
        whether or not the auxiliary phase runs)."""
        return self.permutations(count1, n), self.permutations(count2, n)

    def cov_uniforms(self, epochs: int, minibatches: int, size: int) -> torch.Tensor:
        """``U[0, 1)[epochs, minibatches, size]``: full-tricks PPO's clip-cov
        scores, one uniform per sample of each minibatch of each epoch,
        asked for after the epochs' permutations."""
        return self.uniform((epochs, minibatches, size))

    @per_row(0)
    def explore(self, num: int, n_actions: int) -> tuple[torch.Tensor, torch.Tensor]:
        """ε-greedy draws: ``U[0, 1)[num]`` to compare with ε, and random
        int32 actions in ``[0, n_actions)``."""
        return self.uniform((num,)), self.randint(0, n_actions, (num,))

    def replay_indices(self, batch_size: int, high: int) -> torch.Tensor:
        """``[batch_size]`` int64 indices, uniform in ``[0, high)``."""
        return torch.randint(0, high, (batch_size,), generator=self.generator,
                             device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    @per_row(0)
    def action_noise(self, shape) -> torch.Tensor:
        """Standard normals for acting: DDPG/TD3 exploration, the SAC sample."""
        return self.normal(shape)

    @per_row(0)
    def target_noise(self, shape) -> torch.Tensor:
        """Standard normals for TD3's target-policy smoothing."""
        return self.normal(shape)

    @per_row(0)
    def sac_update_noise(self, shape) -> tuple[torch.Tensor, torch.Tensor]:
        """The SAC update's two samples: for the next-state target, then for
        the actor loss."""
        return self.normal(shape), self.normal(shape)

    def per_uniforms(self, batch_size: int) -> torch.Tensor:
        """``U[0, 1)[batch_size]``: one uniform per PER sampling segment."""
        return self.uniform((batch_size,))

    def _noisy_eps(self, layers, rows: int | None) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``f(ε) = sign(ε)·√|ε|`` of standard normals, as ``(eps_in,
        eps_out)`` per noisy layer of ``layers`` (``(in, out)`` pairs in
        call order): ``[in]``/``[out]``, or ``[rows, in]``/``[rows, out]``.
        One draw and one scaling for the whole forward."""
        lead = () if rows is None else (rows,)
        sizes = [n for pair in layers for n in pair]
        flat = self.normal(lead + (sum(sizes),))
        flat = torch.sign(flat) * torch.sqrt(torch.abs(flat))
        parts = flat.split(sizes, dim=-1)
        return list(zip(parts[0::2], parts[1::2]))

    @per_row(1)
    def noisy_act(self, layers, rows: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The ε of one acting forward: an independent draw per batch row."""
        return self._noisy_eps(layers, rows)

    def noisy_update(self, layers, count: int) -> list[list[tuple[torch.Tensor, torch.Tensor]]]:
        """The ε of an update's ``count`` noisy online forwards (on obs, then
        on next_obs for the double-DQN argmax), each shared by the batch."""
        return [self._noisy_eps(layers, None) for _ in range(count)]

    @per_row(1)
    def env_reset(self, env, num: int):
        return env.reset_draws(self, num)

    @per_row(1)
    def env_step(self, env, num: int):
        return env.step_draws(self, num)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.generator.set_state(state["generator"])


class ShardedNoise:
    """Data rank ``rank`` of ``size``'s view of ``inner`` (a ``Noise``, or
    any object with its methods, such as a test's replay of the JAX keys).

    A draw that ``Noise`` marks ``@per_row`` (the Gumbels and the ε-greedy,
    exploration, NoisyNet-acting and env draws of the env batch, and the
    target-smoothing and SAC-update normals of a minibatch share) is asked
    of ``inner`` for ``n·size`` rows, of which this rank keeps rows
    ``[rank·n, (rank+1)·n)``. Every other draw (permutations, clip-cov
    uniforms, replay indices, PER uniforms, an update's shared NoisyNet ε)
    is global: every rank makes it whole, as the unsharded trainer does. So
    every rank's ``inner`` advances exactly as the unsharded trainer's, and
    its state (a checkpoint's) is the inner source's, the same on every
    rank."""

    def __init__(self, inner, rank: int, size: int):
        self.inner = inner
        self.rank = rank
        self.size = size

    def __getattr__(self, name: str):
        if name == "inner":  # not set yet (a copy in progress)
            raise AttributeError(name)
        draw = getattr(self.inner, name)
        at = getattr(getattr(Noise, name, None), "rows_arg", None)
        if at is None:
            return draw

        def share(*args):
            args = list(args)
            rows = args[at]
            if isinstance(rows, int):
                n, args[at] = rows, rows * self.size
            else:
                n, args[at] = rows[0], (rows[0] * self.size,) + tuple(rows[1:])
            start = self.rank * n
            return map_tensors(lambda x: x[start:start + n], draw(*args))
        return share
