"""Position-Based Fluids (Macklin & Müller PBF) — the counterpart of
``positionbaseddynamics_tpu/fluids``: the SPH kernel, the hash neighbor
search, the cell-dense pipeline with its CUDA kernels, and the FluidDemo
model and stepper."""

from . import sph
from .neighborhood import neighbor_candidates
from .model import (
    FluidScene,
    FluidState,
    block_positions,
    box_boundary,
    cfl_dt,
    compute_density,
    compute_lambda,
    fluid_step,
    make_fluid_step_fn,
    solve_density_constraint,
    xsph_viscosity,
)

__all__ = [
    "sph", "neighbor_candidates", "FluidState", "FluidScene", "fluid_step",
    "make_fluid_step_fn", "compute_density", "compute_lambda",
    "solve_density_constraint", "xsph_viscosity", "cfl_dt",
    "block_positions", "box_boundary",
]
