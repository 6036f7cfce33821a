"""The port's distributed layer: a ``(data, model)`` mesh of processes on
``torch.distributed`` (``mesh.py``), a local launcher (``launch.py``) and the
multichip dry run (``dryrun.py``)."""

from gymrl_tpu_torch.distributed.mesh import (
    Mesh,
    batch_sharding,
    constrain_batch,
    initialize_multihost,
    make_mesh,
    gather_pytree_batch,
    train_state_shardings,
)

__all__ = [
    "Mesh", "batch_sharding", "constrain_batch", "initialize_multihost", "make_mesh",
    "gather_pytree_batch", "train_state_shardings",
]
