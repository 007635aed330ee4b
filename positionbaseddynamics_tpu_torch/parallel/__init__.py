"""Parallelism over ``torch.distributed`` process groups (port of
``positionbaseddynamics_tpu.parallel``): rollout sharding (data
parallel), the generic and the halo-exchange intra-scene sharding, and
the fused cloth kernel on row blocks (``intra_cuda``)."""

from .intra import (gather_particles, make_intra_sharded_step_fn,
                    pad_state_for_mesh, shard_particles)
from .intra_cuda import make_cuda_intra_step_fn
from .intra_grid import halo_exchange, halo_reduce, make_grid_intra_step_fn
from .sharding import (gather_batch, make_group, make_mesh_groups,
                       make_sharded_step_fn, replicate_scene, shard_batch)
