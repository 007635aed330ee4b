"""SDF collision detection and velocity-level contacts — port of
``positionbaseddynamics_tpu/collision/`` (the reference's
``DistanceFieldCollisionDetection`` / ``CubicSDFCollisionDetection``).

Plain PyTorch on any device: JAX computes this path in XLA, outside any
Pallas kernel. ``sdf.py`` holds the shapes and grid samplers;
``sampling.py``, ``bvh.py``, ``csdf.py`` and ``bake.py`` are the port's own
numpy copies of the build-time helpers; ``detection.py`` and
``batched.py`` the unrolled and batched broad and narrow phases;
``contacts.py`` the Jacobi and sequential contact solves; ``solid.py`` the
particle–tet contacts."""

from . import sampling
from .bake import bake_mesh_sdf, bake_mesh_sdf_cached
from .contacts import solve_particle_rigid_contacts, solve_rigid_contacts
from .detection import (CollisionPipeline, ParticleGroupCollider,
                        ParticleRigidContacts, RigidCollider, RigidContacts)
from .sdf import SDFShape, grid_cubic_lagrange, grid_trilinear

__all__ = [
    "SDFShape", "grid_trilinear", "grid_cubic_lagrange",
    "bake_mesh_sdf", "bake_mesh_sdf_cached",
    "CollisionPipeline", "RigidCollider", "ParticleGroupCollider",
    "RigidContacts", "ParticleRigidContacts",
    "solve_rigid_contacts", "solve_particle_rigid_contacts", "sampling",
]
