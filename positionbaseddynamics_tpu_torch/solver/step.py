"""The time stepper — port of ``positionbaseddynamics_tpu/solver/step.py``,
particle path with structured grid cloths.

Per sim step: ``substeps`` × {integrate → position-constraint projection →
velocity update → damping} (``TimeStepController.cpp:93-173``), then the
time advances by ``dt``. The velocity-level projection of the JAX stepper
does nothing without rigid bodies (``step.py:480-481``), so this slice
has none; orientations, rigid bodies, joints, contacts and the
unstructured batches come with later slices of the port.

Two routes run the substeps, chosen once from the configuration:

* ``"cuda_kernel"``: one launch of the fused cloth kernel per substep
  (``grid_cloth_cuda.py``), when the scene is one grid cloth covering
  every particle with uniform XPBD parameters, on a CUDA device, in
  Jacobi mode with ``jacobi_omega = 1`` and the first-order velocity
  update;
* ``"torch_stencil"``: the PyTorch stencil ops of ``grid_cloth.py``, on
  any device, for every other configuration — as the JAX package runs
  its XLA path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops import integration
from . import grid_cloth_cuda as gcc
from .constraints import ConstraintSet
from .state import SimState

Tensor = torch.Tensor

PATH_KERNEL = "cuda_kernel"
PATH_STENCIL = "torch_stencil"


@dataclass(frozen=True)
class StepConfig:
    """Solver parameters mirroring ``TimeStepController`` defaults
    (``TimeStepController.cpp:23-73``: 5 substeps × 1 position iteration ×
    5 velocity iterations) and ``TimeManager`` dt=0.005; gravity from
    ``Simulation.cpp:16``. Every field of the JAX ``StepConfig`` is kept;
    the contact and joint fields take effect with the rigid-body slice."""

    dt: float = 0.005
    substeps: int = 5
    max_iterations: int = 1
    max_iterations_v: int = 5
    velocity_update_method: int = 0  # 0: first order, 1: second order
    damping: float = 0.0             # per-substep v *= (1 - damping)
    gravity: tuple = (0.0, -9.81, 0.0)
    solver_mode: str = "jacobi"      # "jacobi" | "gauss_seidel"
    jacobi_omega: float = 1.0        # SOR weight for averaged Jacobi
    joint_solver_mode: str = "gauss_seidel"
    contact_stiffness_rb: float = 1.0
    contact_stiffness_particle_rb: float = 100.0
    contact_solver_mode: str = "jacobi"


def project_positions(x: Tensor, inv_mass: Tensor, cset: ConstraintSet, dt,
                      cfg: StepConfig) -> Tensor:
    """Position-constraint projection, grid-cloth branch
    (``step.py:283-314``): λ starts at zero and accumulates across the
    ``max_iterations`` passes; ``gauss_seidel`` runs the lattice-coloured
    sweeps of ``project_gs``."""
    lams = cset.init_lambdas()
    gs = cfg.solver_mode == "gauss_seidel"
    for _ in range(cfg.max_iterations):
        for gi, gc in enumerate(cset.grid_cloths):
            key = f"grid_cloth{gi}"
            if gs:
                x, lams[key] = gc.project_gs(x, inv_mass, lams[key], dt)
            else:
                x, lams[key] = gc.project(x, inv_mass, lams[key], dt,
                                          cfg.jacobi_omega)
    return x


def _substep(state: SimState, cset: ConstraintSet, h, cfg: StepConfig
             ) -> SimState:
    """One substep, particle path (``step.py:366-418``)."""
    p = state.particles
    gravity = torch.as_tensor(cfg.gravity, dtype=torch.float32,
                              device=p.x.device)
    last_x, old_x = p.old_x, p.x
    x, v = integration.semi_implicit_euler(
        h, p.inv_mass, p.x, p.v, gravity.expand_as(p.x))
    x = project_positions(x, p.inv_mass, cset, h, cfg)
    if cfg.velocity_update_method == 1:
        v = integration.velocity_update_second_order(
            h, p.inv_mass, x, old_x, last_x, v)
    else:
        v = integration.velocity_update_first_order(h, p.inv_mass, x,
                                                    old_x, v)
    if cfg.damping:
        v = v * (1.0 - cfg.damping)
    particles = dataclasses.replace(p, x=x, v=v, old_x=old_x, last_x=last_x)
    return dataclasses.replace(state, particles=particles)


@dataclass(frozen=True)
class KernelPlan:
    """What the kernel route needs, computed once per step function by
    :func:`kernel_plan`."""

    params: np.ndarray
    icd: Tensor          # (H, W)
    icb: Tensor          # (H, W)
    height: int
    width: int


def kernel_plan(cset: ConstraintSet, cfg: StepConfig
                ) -> Optional[KernelPlan]:
    """The kernel route's plan when the scene and the configuration allow
    that route, else None (see the module docstring)."""
    dev = cset.device
    if dev is None or dev.type != "cuda" or len(cset.grid_cloths) != 1:
        return None
    gc = cset.grid_cloths[0]
    if cset.n_particles != gc.height * gc.width:
        return None
    if not (cfg.solver_mode == "jacobi" and cfg.jacobi_omega == 1.0
            and cfg.velocity_update_method == 0):
        return None
    if gcc.unsupported_reason(gc) is not None:
        return None
    h = cfg.dt / cfg.substeps
    return KernelPlan(
        params=gcc.kernel_params(gc, h=h, gravity=cfg.gravity,
                                 damping=cfg.damping),
        icd=gc.inv_cnt_dist.reshape(gc.height, gc.width).contiguous(),
        icb=gc.inv_cnt_bend.reshape(gc.height, gc.width).contiguous(),
        height=gc.height, width=gc.width)


def _kernel_substeps(state: SimState, plan: KernelPlan, cfg: StepConfig
                     ) -> SimState:
    """All substeps of one step through the fused kernel. ``old_x`` and
    ``last_x`` end as ``_substep`` leaves them: the inputs of the last and
    of the second-last substep."""
    p = state.particles
    hgt, wid = plan.height, plan.width
    lead = p.x.shape[:-2]
    w = p.inv_mass.reshape(-1, hgt, wid)
    w = w[0] if w.shape[0] == 1 else w.contiguous()
    xp, vp, old_p, last_p = gcc.run_substeps(
        gcc.to_planes(p.x, hgt, wid), gcc.to_planes(p.v, hgt, wid), w,
        plan.icd, plan.icb, plan.params, cfg.max_iterations, cfg.substeps)
    last_x = p.old_x if last_p is None else gcc.from_planes(last_p, lead)
    particles = dataclasses.replace(
        p, x=gcc.from_planes(xp, lead), v=gcc.from_planes(vp, lead),
        old_x=gcc.from_planes(old_p, lead), last_x=last_x)
    return dataclasses.replace(state, particles=particles)


def step(state: SimState, cset: ConstraintSet, cfg: StepConfig,
         plan: Optional[KernelPlan] = None) -> SimState:
    """One full sim step: ``substeps`` substeps, then ``time += dt``
    (``step.py:538-571``). With a ``plan`` from :func:`kernel_plan` the
    substeps run through the fused kernel, else through the stencil ops;
    ``make_step_fn`` and ``rollout`` compute the plan once."""
    if state.orientations is not None or state.rigid is not None:
        raise NotImplementedError(
            "orientations and rigid bodies come with the rod (slice 7) and "
            "rigid-body (slice 6) slices of the port")
    if plan is not None:
        state = _kernel_substeps(state, plan, cfg)
    else:
        h = cfg.dt / cfg.substeps
        for _ in range(cfg.substeps):
            state = _substep(state, cset, h, cfg)
    return dataclasses.replace(state, time=state.time + cfg.dt)


def make_step_fn(cset: ConstraintSet, cfg: StepConfig, device=None):
    """``state → state`` closure over a fixed scene on ``device`` (None
    means CUDA). ``fn.path`` names the route its steps take,
    ``"cuda_kernel"`` or ``"torch_stencil"``."""
    dev = resolve_device(device)
    if cset.device is not None and cset.device != dev:
        cset = cset.to(dev)
    plan = kernel_plan(cset, cfg)

    def fn(state: SimState) -> SimState:
        if state.particles.x.device != dev:
            raise ValueError(f"step function built for {dev}; the state "
                             f"is on {state.particles.x.device}")
        return step(state, cset, cfg, plan)

    fn.path = PATH_KERNEL if plan is not None else PATH_STENCIL
    return fn


def rollout(state: SimState, cset: ConstraintSet, cfg: StepConfig,
            n_steps: int, collect: bool = False):
    """Run ``n_steps`` sim steps. Returns ``(final state, trajectory)``:
    the stacked positions ``(n_steps, ..., N, 3)`` when ``collect``, else
    None — the shape of the JAX ``rollout``'s scan result."""
    plan = (kernel_plan(cset, cfg)
            if state.particles.x.device.type == "cuda" else None)
    xs = []
    for _ in range(n_steps):
        state = step(state, cset, cfg, plan)
        if collect:
            xs.append(state.particles.x)
    return state, (torch.stack(xs) if collect else None)
