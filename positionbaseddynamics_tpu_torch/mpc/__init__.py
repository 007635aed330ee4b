"""Sampling-based MPC over batched XPBD rollouts — the counterpart of
``positionbaseddynamics_tpu/mpc``: control models, cost terms, MPPI and
CEM updates and a receding-horizon controller. The K sampled rollouts are
a leading axis of the state; on the card a grid-cloth scene steps them
through the fused cloth substep kernel at ``n_batch = K``. The rigid-body
and obstacle terms raise until their slices (6a, 6b) are ported."""
from .controls import PinVelocityControl, RigidWrenchControl
from .costs import (as_running, combine, control_effort, particle_target,
                    rigid_sdf_obstacle, rigid_target, sdf_obstacle,
                    velocity_penalty)
from .planners import (CEMConfig, MPPIConfig, cem_update,
                       make_mpc_controller, make_sequence_cost, mppi_update,
                       plan_cem, plan_mppi)

__all__ = [
    "PinVelocityControl", "RigidWrenchControl",
    "as_running", "combine", "control_effort", "particle_target",
    "rigid_sdf_obstacle", "rigid_target", "sdf_obstacle", "velocity_penalty",
    "CEMConfig", "MPPIConfig", "cem_update", "make_mpc_controller",
    "make_sequence_cost", "mppi_update", "plan_cem", "plan_mppi",
]
