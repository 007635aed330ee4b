"""Simulation engine (port of ``positionbaseddynamics_tpu.solver``): state,
constraint containers, the grid-cloth stencil solver and the stepper."""

from .state import ParticleState, SimState
from .constraints import ConstraintSet
from .grid_cloth import GridClothBatch
from .step import StepConfig, step, rollout, make_step_fn
