"""positionbaseddynamics_tpu_torch — the PyTorch + CUDA port of
``positionbaseddynamics_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package beside it is the reference: every module here keeps its
counterpart's path and public names, and the tests hold each one against
the JAX function on the same inputs. This package imports ``torch`` and
numpy only, never ``jax`` and never the JAX package.

Ported so far (slice 1, the 320×320 XPBD cloth step):

* ``ops/integration.py`` — semi-implicit Euler and velocity updates;
* ``solver/state.py`` — ``ParticleState`` / ``SimState``;
* ``solver/grid_cloth.py`` — the structured-grid stencil solver;
* ``solver/grid_cloth_cuda.py`` + ``csrc/grid_cloth_step.cu`` — the fused
  cloth substep as a hand-written CUDA kernel;
* ``solver/step.py`` — ``StepConfig``, ``step``, ``make_step_fn``,
  ``rollout``;
* ``models/`` — ``SceneBuilder`` for regular triangle grids.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise rather than run on the CPU.
"""

from . import convert, models, ops, solver

__version__ = "0.1.0"
