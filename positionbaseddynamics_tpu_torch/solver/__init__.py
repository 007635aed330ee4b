"""Simulation engine (port of ``positionbaseddynamics_tpu.solver``): state,
constraint containers, the grid-cloth and tet-grid stencil solvers, the
particle constraint batches and the stepper."""

from .state import ParticleState, SimState
from .constraints import (
    ConstraintSet,
    DihedralBatch,
    DistanceBatch,
    FEMTetraBatch,
    FEMTriangleBatch,
    IsometricBendingBatch,
    ShapeMatchingBatch,
    StrainTetraBatch,
    StrainTriangleBatch,
    VolumeBatch,
)
from .grid_cloth import GridClothBatch
from .grid_tet import GridTetBatch
from .step import StepConfig, step, rollout, make_step_fn
