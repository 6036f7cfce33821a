"""gymrl-tpu-torch: the PyTorch/CUDA port of ``gymrl_tpu``.

A second implementation of the JAX package, written for one NVIDIA H100.
It keeps the JAX package's layout (``envs/``, ``core/``, ``nn/``,
``algos/``, ``run/``, ``utils/``) so each module's counterpart is found by
path, and each is tested against that counterpart on the CPU
(``tests/test_torch_*.py``).

What changes with the framework:
  * ``vmap`` over a per-env function becomes an explicit leading batch axis
    ``[B, ...]`` on every state tensor (``reset_batch`` / ``step_batch``
    act on the whole batch directly).
  * ``lax.scan`` becomes a Python loop; ``jit`` has no counterpart (eager).
  * ``jax.random`` keys become ``torch.Generator``s held by a ``Noise``
    object (``core/noise.py``). Random draws are separate from the physics:
    the env's pure functions take their uniforms as tensor arguments.
  * Parameters live in ``nn.Module``s; the optimizer is ``torch.optim.Adam``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit ``cpu`` it raises
(``utils/device.py``). The package never imports JAX or ``gymrl_tpu``.
"""

__version__ = "0.1.0"
