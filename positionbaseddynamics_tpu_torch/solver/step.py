"""The time stepper — port of ``positionbaseddynamics_tpu/solver/step.py``,
particle path.

Per sim step: ``substeps`` × {integrate → position-constraint projection →
velocity update → damping} (``TimeStepController.cpp:93-173``), then the
time advances by ``dt``. The velocity-level projection of the JAX stepper
does nothing without rigid bodies (``step.py:480-481``), so the particle
path has none; orientations, rigid bodies, joints and contacts come with
later slices of the port.

Three routes run the substeps, chosen once from the scene and the
configuration:

* ``"cuda_kernel"``: the fused kernel of the scene's one grid, on a CUDA
  device, in Jacobi mode with ``jacobi_omega = 1`` and the first-order
  velocity update, when that grid covers every particle and the scene has
  no particle batch — either one grid cloth with uniform XPBD parameters
  (``grid_cloth_cuda.py``, one launch per substep) or one tet grid
  without ``inversion_handling`` (``grid_tet_cuda.py``, one launch per
  iteration of each substep);
* ``"torch_unstructured"``: a scene with any particle batch
  (``solver/constraints.py``): per family a gather, the batched op of
  ``ops/`` and an ``index_add_`` scatter, after the grid families, as the
  JAX package computes it in XLA (``step.py:153-176``);
* ``"torch_stencil"``: the PyTorch stencil ops of ``grid_cloth.py`` and
  ``grid_tet.py`` for every other configuration.

The last two run on any device.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from .._device import resolve_device
from ..ops import integration
from . import grid_cloth_cuda as gcc
from . import grid_tet_cuda as gtc
from .constraints import ConstraintSet, _index_add
from .state import SimState

Tensor = torch.Tensor

PATH_KERNEL = "cuda_kernel"
PATH_STENCIL = "torch_stencil"
PATH_UNSTRUCTURED = "torch_unstructured"


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


@dataclass(frozen=True)
class BatchPass:
    """One particle family's projection, prepared once by
    :func:`batch_passes`: its ``name`` (the λ key), the ``batch``, the
    Jacobi ``scale`` (``jacobi_omega`` times the family's 1/count column,
    or ``jacobi_omega`` alone for a self-averaged family) and, for
    ``gauss_seidel``, the colour ``subsets`` as ``[(rows, sub-batch)]``."""

    name: str
    batch: object
    scale: object
    subsets: Optional[list]


def _inv_counts(cset: ConstraintSet, key: str, n: int, idx: Tensor
                ) -> Tensor:
    """The build-time 1/count column when the set has one for ``n``
    particles, else computed here (``step.py:76-82``)."""
    pre = cset.jacobi_inv_counts.get(key)
    if pre is not None and pre.shape[0] == n:
        return pre
    ones = torch.ones((idx.numel(), 1), dtype=torch.float32,
                      device=idx.device)
    counts = _index_add(n, idx.reshape(-1), ones)
    return 1.0 / torch.clamp_min(counts, 1.0)


def batch_passes(cset: ConstraintSet, cfg: StepConfig, n: int):
    """The particle families' passes in solve order, on the set's device
    (``step.py:153-176``); the Jacobi scales and the colour subsets are
    computed here, once per step function, not in a step."""
    gs = cfg.solver_mode == "gauss_seidel"
    out = []
    for name, b in cset.particle_batches():
        scale = (cfg.jacobi_omega if b.self_averaged else
                 cfg.jacobi_omega * _inv_counts(cset, name, n, b.idx))
        out.append(BatchPass(name, b, scale,
                             b.color_subsets() if gs else None))
    return tuple(out)


def _set_rows(lam: Tensor, rows: Tensor, new: Tensor) -> Tensor:
    """``lam`` with the rows ``rows`` of its last axis replaced by
    ``new``, broadcast over ``new``'s rollout axes."""
    out = lam.expand(*new.shape[:-1], lam.shape[-1]).clone()
    out[..., rows] = new
    return out


def _project_particle_batch(x: Tensor, inv_mass: Tensor, bp: BatchPass,
                            lam: Tensor, dt) -> Tuple[Tensor, Tensor]:
    """One projection pass of one particle family (``step.py:153-176``):
    Jacobi adds the scaled sum of the corrections; Gauss-Seidel solves
    the colours one after another and adds each colour's corrections as
    they are (no two of its rows share a particle)."""
    n = x.shape[-2]
    if bp.subsets is not None:
        for rows, sub in bp.subsets:
            sub_lam = lam[..., rows] if lam.shape[-1] else lam
            corr, new_lam = sub.solve(x, inv_mass, sub_lam, dt)
            if lam.shape[-1] and new_lam.shape[-1] == sub_lam.shape[-1]:
                lam = _set_rows(lam, rows, new_lam)
            x = x + _index_add(n, sub.idx.reshape(-1), _rows(corr))
        return x, lam
    corr, lam = bp.batch.solve(x, inv_mass, lam, dt)
    dx = _index_add(n, bp.batch.idx.reshape(-1), _rows(corr))
    return x + bp.scale * dx, lam


def _rows(corr: Tensor) -> Tensor:
    """``(..., C, k, 3)`` corrections as ``(..., C·k, 3)`` rows."""
    return corr.reshape(*corr.shape[:-3], -1, corr.shape[-1])


def project_positions(x: Tensor, inv_mass: Tensor, cset: ConstraintSet, dt,
                      cfg: StepConfig, passes=None) -> Tensor:
    """Position-constraint projection (``step.py:283-322``): λ starts at
    zero and accumulates across the ``max_iterations`` passes; each pass
    runs the grid families (``gauss_seidel``: the lattice-coloured sweeps
    of ``project_gs``), then the particle families. ``passes`` are
    :func:`batch_passes`' (computed here when None)."""
    if passes is None:
        passes = batch_passes(cset, cfg, x.shape[-2])
    lams = cset.init_lambdas()
    gs = cfg.solver_mode == "gauss_seidel"
    grids = ([(f"grid_cloth{i}", b) for i, b in enumerate(cset.grid_cloths)]
             + [(f"grid_tet{i}", b) for i, b in enumerate(cset.grid_tets)])
    for _ in range(cfg.max_iterations):
        for key, b in grids:
            if gs:
                x, lams[key] = b.project_gs(x, inv_mass, lams[key], dt)
            else:
                x, lams[key] = b.project(x, inv_mass, lams[key], dt,
                                         cfg.jacobi_omega)
        for bp in passes:
            x, lams[bp.name] = _project_particle_batch(
                x, inv_mass, bp, lams[bp.name], dt)
    return x


@functools.lru_cache(maxsize=None)
def _gravity(g: tuple, device: torch.device) -> Tensor:
    """The gravity vector on ``device``, made once: a tensor copied from
    the host in every substep would make the host wait for the card."""
    return torch.tensor(g, dtype=torch.float32, device=device)


def _substep(state: SimState, cset: ConstraintSet, h, cfg: StepConfig,
             passes=None) -> SimState:
    """One substep, particle path (``step.py:366-418``)."""
    p = state.particles
    gravity = _gravity(tuple(cfg.gravity), p.x.device)
    last_x, old_x = p.old_x, p.x
    x, v = integration.semi_implicit_euler(
        h, p.inv_mass, p.x, p.v, gravity.expand_as(p.x))
    x = project_positions(x, p.inv_mass, cset, h, cfg, passes)
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
    """The kernel route of a step function, computed once by
    :func:`kernel_plan`: which kernel (``"cloth"`` or ``"tet"``), and
    ``run(particles, n)``, which runs ``n`` substeps through it and returns
    ``(x, v, old_x, last_x)``, with ``last_x`` None when ``n < 2``."""

    kernel: str
    run: Callable


def _cloth_plan(gc, cfg: StepConfig) -> KernelPlan:
    hgt, wid = gc.height, gc.width
    params = gcc.kernel_params(gc, h=cfg.dt / cfg.substeps,
                               gravity=cfg.gravity, damping=cfg.damping)
    icd = gc.inv_cnt_dist.reshape(hgt, wid).contiguous()
    icb = gc.inv_cnt_bend.reshape(hgt, wid).contiguous()

    def run(p, n):
        lead = p.x.shape[:-2]
        w = p.inv_mass.reshape(-1, hgt, wid)
        w = w[0] if w.shape[0] == 1 else w.contiguous()
        out = gcc.run_substeps(
            gcc.to_planes(p.x, hgt, wid), gcc.to_planes(p.v, hgt, wid), w,
            icd, icb, params, cfg.max_iterations, n)
        return tuple(None if a is None else gcc.from_planes(a, lead)
                     for a in out)

    return KernelPlan("cloth", run)


def _tet_plan(gt, cfg: StepConfig) -> KernelPlan:
    dims = (gt.width, gt.height, gt.depth)
    params = gtc.kernel_params(gt, h=cfg.dt / cfg.substeps,
                               gravity=cfg.gravity, damping=cfg.damping)
    ic = gt.inv_cnt.reshape(-1).contiguous()

    def run(p, n):
        if p.x.dim() != 2:
            raise NotImplementedError(
                "the grid-tet solver takes one scene's (N, 3) state, as the "
                "JAX package's does; got a rollout axis")
        out = gtc.run_substeps(gtc.to_planes(p.x), gtc.to_planes(p.v),
                               p.inv_mass.contiguous(), ic, params, dims,
                               cfg.max_iterations, n)
        return tuple(None if a is None else gtc.from_planes(a) for a in out)

    return KernelPlan("tet", run)


def kernel_plan(cset: ConstraintSet, cfg: StepConfig
                ) -> Optional[KernelPlan]:
    """The kernel route's plan when the scene and the configuration allow
    that route, else None (see the module docstring). A scene with any
    particle batch never takes it: the kernels solve their grid only."""
    dev = cset.device
    if dev is None or dev.type != "cuda" or cset.particle_batches():
        return None
    if not (cfg.solver_mode == "jacobi" and cfg.jacobi_omega == 1.0
            and cfg.velocity_update_method == 0):
        return None
    grids = cset.grid_cloths + cset.grid_tets
    if len(grids) != 1:
        return None
    if cset.grid_cloths:
        gc = cset.grid_cloths[0]
        if (cset.n_particles != gc.height * gc.width
                or gcc.unsupported_reason(gc) is not None):
            return None
        return _cloth_plan(gc, cfg)
    gt = cset.grid_tets[0]
    if (cset.n_particles != gt.width * gt.height * gt.depth
            or gtc.unsupported_reason(gt) is not None):
        return None
    return _tet_plan(gt, cfg)


def _kernel_substeps(state: SimState, plan: KernelPlan, cfg: StepConfig
                     ) -> SimState:
    """All substeps of one step through the plan's kernel. ``old_x`` and
    ``last_x`` end as ``_substep`` leaves them: the inputs of the last and
    of the second-last substep."""
    p = state.particles
    x, v, old_x, last_x = plan.run(p, cfg.substeps)
    particles = dataclasses.replace(
        p, x=x, v=v, old_x=old_x,
        last_x=p.old_x if last_x is None else last_x)
    return dataclasses.replace(state, particles=particles)


def step(state: SimState, cset: ConstraintSet, cfg: StepConfig,
         plan: Optional[KernelPlan] = None, passes=None) -> SimState:
    """One full sim step: ``substeps`` substeps, then ``time += dt``
    (``step.py:538-571``). With a ``plan`` from :func:`kernel_plan` the
    substeps run through its kernel, else through the PyTorch ops, with
    the particle families' ``passes`` from :func:`batch_passes` (computed
    here when None); ``make_step_fn`` and ``rollout`` compute both once."""
    if state.orientations is not None or state.rigid is not None:
        raise NotImplementedError(
            "orientations and rigid bodies come with the rod (slice 7) and "
            "rigid-body (slice 6) slices of the port")
    if plan is not None:
        state = _kernel_substeps(state, plan, cfg)
    else:
        if passes is None:
            passes = batch_passes(cset, cfg, state.particles.n)
        h = cfg.dt / cfg.substeps
        for _ in range(cfg.substeps):
            state = _substep(state, cset, h, cfg, passes)
    return dataclasses.replace(state, time=state.time + cfg.dt)


def _route(cset: ConstraintSet, cfg: StepConfig, n: int):
    """``(plan, passes, path)`` of a scene: the kernel plan, or the
    particle passes and the PyTorch route's name."""
    plan = kernel_plan(cset, cfg)
    if plan is not None:
        return plan, (), PATH_KERNEL
    passes = batch_passes(cset, cfg, n)
    return None, passes, PATH_UNSTRUCTURED if passes else PATH_STENCIL


def make_step_fn(cset: ConstraintSet, cfg: StepConfig, device=None):
    """``state → state`` closure over a fixed scene on ``device`` (None
    means CUDA). ``fn.path`` names the route its steps take,
    ``"cuda_kernel"``, ``"torch_unstructured"`` or ``"torch_stencil"``."""
    dev = resolve_device(device)
    if cset.device is not None and cset.device != dev:
        cset = cset.to(dev)
    n = cset.n_particles
    if n is None and cset.particle_batches():
        raise ValueError("a constraint set with particle batches needs its "
                         "n_particles; build it with SceneBuilder or "
                         "convert.scene_from_numpy")
    plan, passes, path = _route(cset, cfg, n)

    def fn(state: SimState) -> SimState:
        if state.particles.x.device != dev:
            raise ValueError(f"step function built for {dev}; the state "
                             f"is on {state.particles.x.device}")
        return step(state, cset, cfg, plan, passes)

    fn.path = path
    return fn


def rollout(state: SimState, cset: ConstraintSet, cfg: StepConfig,
            n_steps: int, collect: bool = False):
    """Run ``n_steps`` sim steps. Returns ``(final state, trajectory)``:
    the stacked positions ``(n_steps, ..., N, 3)`` when ``collect``, else
    None — the shape of the JAX ``rollout``'s scan result."""
    if state.particles.x.device.type == "cuda":
        plan, passes, _ = _route(cset, cfg, state.particles.n)
    else:
        plan, passes = None, batch_passes(cset, cfg, state.particles.n)
    xs = []
    for _ in range(n_steps):
        state = step(state, cset, cfg, plan, passes)
        if collect:
            xs.append(state.particles.x)
    return state, (torch.stack(xs) if collect else None)
