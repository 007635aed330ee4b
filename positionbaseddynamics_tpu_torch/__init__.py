"""positionbaseddynamics_tpu_torch — the PyTorch + CUDA port of
``positionbaseddynamics_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package beside it is the reference: every module here keeps its
counterpart's path and public names, and the tests hold each one against
the JAX function on the same inputs. This package imports ``torch`` and
numpy only, never ``jax`` and never the JAX package.

Ported so far (slice 1, the 320×320 XPBD cloth step; slice 2, the
80×36×36 XPBD FEM-tet bar; slice 3, the 100k PBF breaking dam; slice 4,
the general unstructured solver; slice 5, the sampling planner; slice 6a,
rigid bodies and joints; slice 6b, collision; slice 7, rods and generic
constraints; slice 8, scene I/O and the app layer; slice 9,
parallelism):

* ``ops/integration.py`` — semi-implicit Euler, the rigid rotation step
  and the velocity updates;
* ``ops/quaternion.py``, ``ops/rigidbody.py`` — quaternion algebra, the
  masked 6-row joint solve and the contact impulses, batched over leading
  axes; ``utils/`` — the build-time numpy quaternions and mesh mass
  properties;
* ``ops/mathutils.py``, ``ops/pbd.py``, ``ops/xpbd.py`` — the 3×3
  helpers, the signed SVD in its LAPACK and Jacobi forms, the polar
  decompositions, and the classic PBD and XPBD constraint solves, batched
  over leading axes;
* ``solver/state.py`` — ``ParticleState`` / ``OrientationState`` /
  ``RigidState`` / ``SimState``;
* ``ops/rods.py``, ``ops/ghost_rods.py``, ``ops/generic.py`` — Cosserat
  and ghost-point rod solves and the user's generic constraints, their
  Jacobians by ``torch.func.jacfwd``; ``solver/grid_rods.py`` — identical
  rods as plane stencils (the rod lattice); ``solver/direct_rods.py`` —
  the direct stiff-rod chain and tree solvers;
* ``solver/joints.py`` — the 13 joint kinds (ball … stretch-bending-
  twisting) as ``JointBatch``-es, gathered, solved in one batched 6×6
  system a joint and scattered with ``index_add_`` in plain PyTorch, as
  JAX computes them in XLA;
* ``solver/coloring.py``, ``solver/constraints.py`` — greedy colouring
  and the constraint batches (distance, FEM and strain triangles, FEM and
  strain tets, volume, shape matching, dihedral and isometric bending, the
  Cosserat and ghost-point rod families, the generic particle and rigid
  constraints), gathered, solved and scattered with ``index_add_`` in
  plain PyTorch, as JAX computes them in XLA;
* ``solver/grid_cloth.py``, ``solver/grid_tet.py`` — the structured-grid
  stencil solvers of cloths and tet bars;
* ``solver/grid_cloth_cuda.py`` + ``csrc/grid_cloth_step.cu`` and
  ``solver/grid_tet_cuda.py`` + ``csrc/grid_tet_step.cu`` — the fused
  cloth and tet substeps as hand-written CUDA kernels, the cloth kernel
  also with a step's substeps in one launch and on a window of rows;
* ``solver/step.py`` — ``StepConfig``, ``step``, ``make_step_fn``,
  ``rollout``, each with an optional collision ``pipeline``;
* ``collision/`` — SDF shapes and grids, the numpy build-time helpers
  (surface samples, block spheres, ``.csdf`` reader, mesh baker), the
  unrolled and batched broad phases, rigid–rigid, particle–rigid and
  particle–tet contacts and their solves, in plain PyTorch as JAX
  computes them in XLA;
* ``models/`` — ``SceneBuilder`` for triangle and tet models, regular or
  not, with the cloth, bending and solid methods and the per-constraint
  adders, for rigid bodies with the 14 joint adders, and for line models,
  ghost-point rods, stiff rods and generic constraints;
* ``fluids/`` — the SPH kernel, the hash neighbor search, the cell-dense
  PBF pipeline (``cellgrid.py``) with its density, correction and XSPH
  passes as hand-written CUDA kernels (``cellgrid_cuda.py`` +
  ``csrc/pbf_cells.cu``), JAX's occupancy classes (``classgrid.py``,
  plain PyTorch), and ``FluidScene`` / ``make_fluid_step_fn``;
* ``scene/`` — the reference's JSON scene format loaded and built on
  the card (``load_scene``, ``load_scene_dict``, ``LoadedScene``);
  ``utils/`` — the OBJ/PLY/TetGen loaders (numpy copies), checkpoints in
  JAX's npz layout, phase timers and the log sinks; ``models/
  skinning.py`` — vis-mesh skinning of tet models; ``models/mesh.py`` —
  face and vertex normals;
* ``mpc/`` — control models, cost terms, MPPI, CEM and the
  receding-horizon controller over K rollouts stepped as one batched
  state, through the cloth kernel at ``n_batch = K`` on the card, and
  the rigid wrench control and target cost;
* ``parallel/`` — rollout sharding and the generic and halo-exchange
  intra-scene sharding over ``torch.distributed`` process groups, and the
  cloth kernel's fused row-window mode on a rank's rows (``intra_cuda``);
  ``solver/grid_window.py`` — the cloth stencil on a window of rows, the
  plain version of that mode.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise rather than run on the CPU.
"""

from . import (collision, convert, fluids, models, mpc, ops, parallel, scene,
               solver, utils)

__version__ = "0.1.0"
