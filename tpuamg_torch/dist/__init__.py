"""The distributed grid solve on torch.distributed (counterpart of the
JAX package's ``dist/``).  The algebraic ``distributed_solve`` and
``distributed_pcg_step``, ``device_mesh2d`` and
``shard_preconditioner_agglomerated`` are ROADMAP Queue 1 item 12."""
from .sharding import (DeviceMesh, device_mesh, init_multihost, replicate,
                       shard_dia, shard_preconditioner, shard_vector)
from .solve import distributed_grid_solve, setup_distributed_grid

__all__ = ["DeviceMesh", "device_mesh", "init_multihost", "replicate",
           "shard_dia", "shard_preconditioner", "shard_vector",
           "distributed_grid_solve", "setup_distributed_grid"]
