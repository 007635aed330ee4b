"""Simulation engine (port of ``positionbaseddynamics_tpu.solver``): state,
constraint containers, the grid-cloth and tet-grid stencil solvers, the
particle constraint batches, the rigid-body joints and the stepper."""

from .state import ParticleState, RigidState, SimState
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
from .joints import JointBatch, make_joint_batch
from .step import StepConfig, step, rollout, make_step_fn
