"""Simulation engine (port of ``positionbaseddynamics_tpu.solver``): state,
constraint containers, the grid-cloth and tet-grid stencil solvers and the
stepper."""

from .state import ParticleState, SimState
from .constraints import ConstraintSet
from .grid_cloth import GridClothBatch
from .grid_tet import GridTetBatch
from .step import StepConfig, step, rollout, make_step_fn
