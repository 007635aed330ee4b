"""positionbaseddynamics_tpu_torch — the PyTorch + CUDA port of
``positionbaseddynamics_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package beside it is the reference: every module here keeps its
counterpart's path and public names, and the tests hold each one against
the JAX function on the same inputs. This package imports ``torch`` and
numpy only, never ``jax`` and never the JAX package.

Ported so far (slice 1, the 320×320 XPBD cloth step; slice 2, the
80×36×36 XPBD FEM-tet bar; slice 3, the 100k PBF breaking dam; slice 4,
the general unstructured solver; slice 5, the sampling planner):

* ``ops/integration.py`` — semi-implicit Euler and velocity updates;
* ``ops/mathutils.py``, ``ops/pbd.py``, ``ops/xpbd.py`` — the 3×3
  helpers, the signed SVD in its LAPACK and Jacobi forms, the polar
  decompositions, and the classic PBD and XPBD constraint solves, batched
  over leading axes;
* ``solver/state.py`` — ``ParticleState`` / ``SimState``;
* ``solver/coloring.py``, ``solver/constraints.py`` — greedy colouring
  and the nine particle constraint batches (distance, FEM and strain
  triangles, FEM and strain tets, volume, shape matching, dihedral and
  isometric bending), gathered, solved and scattered with ``index_add_``
  in plain PyTorch, as JAX computes them in XLA;
* ``solver/grid_cloth.py``, ``solver/grid_tet.py`` — the structured-grid
  stencil solvers of cloths and tet bars;
* ``solver/grid_cloth_cuda.py`` + ``csrc/grid_cloth_step.cu`` and
  ``solver/grid_tet_cuda.py`` + ``csrc/grid_tet_step.cu`` — the fused
  cloth and tet substeps as hand-written CUDA kernels;
* ``solver/step.py`` — ``StepConfig``, ``step``, ``make_step_fn``,
  ``rollout``;
* ``models/`` — ``SceneBuilder`` for triangle and tet models, regular or
  not, with the cloth, bending and solid methods and the per-constraint
  adders;
* ``fluids/`` — the SPH kernel, the hash neighbor search, the cell-dense
  PBF pipeline (``cellgrid.py``) with its density, correction and XSPH
  passes as hand-written CUDA kernels (``cellgrid_cuda.py`` +
  ``csrc/pbf_cells.cu``), JAX's occupancy classes (``classgrid.py``,
  plain PyTorch), and ``FluidScene`` / ``make_fluid_step_fn``;
* ``mpc/`` — control models, cost terms, MPPI, CEM and the
  receding-horizon controller over K rollouts stepped as one batched
  state, through the cloth kernel at ``n_batch = K`` on the card.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise rather than run on the CPU.
"""

from . import convert, fluids, models, mpc, ops, solver

__version__ = "0.1.0"
