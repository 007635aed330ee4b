"""Simulation engine (port of ``positionbaseddynamics_tpu.solver``): state,
constraint containers, the grid-cloth, tet-grid and rod-lattice stencil
solvers, the particle, rod and generic constraint batches, the rigid-body
joints, the direct stiff-rod solvers and the stepper."""

from .state import OrientationState, ParticleState, RigidState, SimState
from .constraints import (
    BendTwistBatch,
    ConstraintSet,
    DarbouxVectorBatch,
    DihedralBatch,
    DistanceBatch,
    FEMTetraBatch,
    FEMTriangleBatch,
    GenericConstraintBatch,
    GenericRigidBatch,
    GhostEdgeDistanceBatch,
    IsometricBendingBatch,
    PerpendicularBisectorBatch,
    ShapeMatchingBatch,
    StrainTetraBatch,
    StrainTriangleBatch,
    StretchShearBatch,
    VolumeBatch,
)
from .direct_rods import DirectRodBatch, DirectRodTreeBatch
from .grid_rods import RodLatticeBatch
from .grid_cloth import GridClothBatch
from .grid_tet import GridTetBatch
from .joints import JointBatch, make_joint_batch
from .step import StepConfig, step, rollout, make_step_fn
