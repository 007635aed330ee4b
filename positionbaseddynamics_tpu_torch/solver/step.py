"""The time stepper — port of ``positionbaseddynamics_tpu/solver/step.py``,
particles and rigid bodies.

Per sim step: ``substeps`` × {integrate particles and rigid bodies →
position-constraint projection → velocity update → damping}
(``TimeStepController.cpp:93-173``), then the velocity-level projection of
the velocity-motor joints (``velocity_constraint_projection``,
``TimeStepController.cpp:298-357``), then the time advances by ``dt``.
With a collision pipeline (``collision/``), the particle–tet contacts are
detected once a step before the substeps and position-solved after the
particle families in every projection iteration, and the velocity-level
projection detects the rigid–rigid and particle–rigid contacts and solves
them after the motors (``step.py:283-365, 455-590``). Orientation
particles (slice 7) come with a later slice and raise.

Four routes run the substeps, chosen once from the scene and the
configuration:

* ``"cuda_kernel"``: the fused kernel of the scene's one grid, on a CUDA
  device, in Jacobi mode with ``jacobi_omega = 1`` and the first-order
  velocity update, when that grid covers every particle and the scene has
  no particle batch, no rigid body and no collision pipeline (JAX also
  steps collision scenes outside its kernels) — either one grid cloth
  with uniform XPBD parameters
  (``grid_cloth_cuda.py``, one launch per substep) or one tet grid
  without ``inversion_handling`` (``grid_tet_cuda.py``, one launch per
  iteration of each substep);
* ``"torch_unstructured"``: a scene with any particle batch
  (``solver/constraints.py``): per family a gather, the batched op of
  ``ops/`` and an ``index_add_`` scatter, after the grid families, as the
  JAX package computes it in XLA (``step.py:153-176``);
* ``"torch_rigid"``: a scene with rigid bodies or joints: the rigid
  integration, and after the particle families each joint batch
  (``solver/joints.py``) gathered, solved in one batched 6×6 system a
  joint and scattered with ``index_add_``, colour by colour in
  ``joint_solver_mode="gauss_seidel"`` (``step.py:229-280``), as the JAX
  package computes it in XLA; its grid families take the stencil ops;
* ``"torch_stencil"``: the PyTorch stencil ops of ``grid_cloth.py`` and
  ``grid_tet.py`` for every other configuration.

The last three run on any device.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from .._device import resolve_device
from ..ops import integration, quaternion as quat
from . import grid_cloth_cuda as gcc
from . import grid_tet_cuda as gtc
from .constraints import ConstraintSet, _index_add
from .state import RigidState, SimState

Tensor = torch.Tensor

PATH_KERNEL = "cuda_kernel"
PATH_STENCIL = "torch_stencil"
PATH_UNSTRUCTURED = "torch_unstructured"
PATH_RIGID = "torch_rigid"


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


def _masked_inv_diag(inertia0: Tensor, inv_mass: Tensor) -> Tensor:
    """``1/I₀`` of the dynamic bodies, 0 for static ones and for a zero
    moment, ``(R, 3)``."""
    inv_diag = torch.where(inertia0 > 0.0,
                           1.0 / torch.clamp_min(inertia0, 1e-30),
                           torch.zeros_like(inertia0))
    return inv_diag * (inv_mass > 0.0)[..., None]


def _world_inverse(rq: Tensor, inv_diag: Tensor) -> Tensor:
    """``R diag(inv_diag) Rᵀ`` of the rotations ``rq``."""
    r = quat.to_matrix(rq)
    return torch.matmul(r * inv_diag[..., None, :], r.transpose(-1, -2))


def _masked_inv_inertia_w(rq: Tensor, inertia0: Tensor,
                          inv_mass: Tensor) -> Tensor:
    """World inverse inertia ``R diag(1/I₀) Rᵀ``, zero for static bodies
    (the reference adds K blocks only where ``invMass != 0``;
    ``step.py:229-235``). Masking the diagonal first gives the same
    numbers as masking the product."""
    return _world_inverse(rq, _masked_inv_diag(inertia0, inv_mass))


def _apply_joint_position(rx, rq, px, jb, corr_x, corr_q, factor=None):
    """Joint corrections added to the bodies (and, for
    ``rb_particle_ball``, the particles), then every rotation renormalised
    (``step.py:238-253``). ``factor`` (``(C, 1, 1)``) keeps one colour's
    rows. Each correction is added into the array: in Gauss-Seidel a
    colour moves a body by one row at most (its other rows add exact
    zeros), which equals JAX's adding the summed corrections; in Jacobi
    the two orders of a body's sum may round apart."""
    if factor is not None:
        corr_x = corr_x * factor
        corr_q = corr_q * factor
    if jb.couples_particles:
        rx = rx.index_add(-2, jb._b0, corr_x[..., 0, :])
        rq = rq.index_add(-2, jb._b0, corr_q[..., 0, :])
        if px is not None:
            px = px.index_add(-2, jb._b1, corr_x[..., 1, :])
    else:
        flat = jb.bodies.reshape(-1)
        rx = rx.index_add(-2, flat, _rows(corr_x))
        rq = rq.index_add(-2, flat, _rows(corr_q))
    return rx, quat.normalize(rq), px


def _project_joints(rx, rq, rigid: RigidState, px, p_inv_mass,
                    cset: ConstraintSet, lams, time, dt, cfg: StepConfig):
    """One pass over every joint batch at position level
    (``step.py:256-280``). The masked world inverse inertia follows the
    current rotations before every solve (the reference's
    ``rotationUpdated``). Gauss-Seidel solves the whole batch once a colour
    and keeps that colour's rows, as JAX does."""
    inv_diag = _masked_inv_diag(rigid.inertia0, rigid.inv_mass)
    for k, jb in enumerate(cset.joints):
        key = f"joint{k}"
        if cfg.joint_solver_mode == "gauss_seidel":
            for sel, factor in zip(jb.color_masks, jb._color_factors):
                iw = _world_inverse(rq, inv_diag)
                corr_x, corr_q, new_lam = jb.solve_position(
                    rx, rq, rigid.inv_mass, iw, time, dt, lams[key],
                    px=px, pw=p_inv_mass)
                lams[key] = torch.where(sel[:, None], new_lam, lams[key])
                rx, rq, px = _apply_joint_position(
                    rx, rq, px, jb, corr_x, corr_q, factor=factor)
        else:
            iw = _world_inverse(rq, inv_diag)
            corr_x, corr_q, lams[key] = jb.solve_position(
                rx, rq, rigid.inv_mass, iw, time, dt, lams[key],
                px=px, pw=p_inv_mass)
            rx, rq, px = _apply_joint_position(rx, rq, px, jb, corr_x,
                                               corr_q)
    return rx, rq, px


def project_positions(x: Tensor, inv_mass: Tensor, cset: ConstraintSet, dt,
                      cfg: StepConfig, passes=None,
                      rigid: Optional[RigidState] = None, time=None,
                      solid_contacts=None):
    """Position-constraint projection (``step.py:283-364``): λ starts at
    zero and accumulates across the ``max_iterations`` passes; each pass
    runs the grid families (``gauss_seidel``: the lattice-coloured sweeps
    of ``project_gs``), then the particle families, then the joints on
    ``rigid``'s integrated bodies at the step's start ``time`` (motor
    targets), then the particle–tet ``solid_contacts``
    (``TimeStepController.cpp:288-291``). ``passes`` are
    :func:`batch_passes`' (computed here when None). Returns ``(x,
    rigid_x, rigid_q, solid_lam)``: the rigid entries None without rigid
    bodies, ``solid_lam`` the last pass's particle–tet λ (None without
    solid contacts), which the friction pass reads."""
    from ..collision.solid import solve_solid_contacts_position

    solid_lam = None
    if passes is None:
        passes = batch_passes(cset, cfg, x.shape[-2])
    lams = cset.init_lambdas()
    rx = rq = None
    if rigid is not None:
        rx, rq = rigid.x, rigid.q
        for k, jb in enumerate(cset.joints):
            lams[f"joint{k}"] = jb.init_lambda()
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
        if rigid is not None and cset.joints:
            rx, rq, x = _project_joints(rx, rq, rigid, x, inv_mass, cset,
                                        lams, time, dt, cfg)
        if solid_contacts is not None:
            dx, solid_lam = solve_solid_contacts_position(solid_contacts, x,
                                                          inv_mass)
            x = x + dx
    return x, rx, rq, solid_lam


@functools.lru_cache(maxsize=None)
def _gravity(g: tuple, device: torch.device) -> Tensor:
    """The gravity vector on ``device``, made once: a tensor copied from
    the host in every substep would make the host wait for the card."""
    return torch.tensor(g, dtype=torch.float32, device=device)


def _substep(state: SimState, cset: ConstraintSet, h, cfg: StepConfig,
             passes=None, solid_contacts=None):
    """One substep (``step.py:366-449``): particles and rigid bodies
    integrated, projected, their velocities updated. Returns ``(state,
    solid_lam)``."""
    p = state.particles
    gravity = _gravity(tuple(cfg.gravity), p.x.device)
    last_x, old_x = p.old_x, p.x
    x, v = integration.semi_implicit_euler(
        h, p.inv_mass, p.x, p.v, gravity.expand_as(p.x))
    r = state.rigid
    if r is not None:
        accel = (gravity.expand_as(r.x)
                 + r.ext_force * r.inv_mass[..., None])
        rx, rv = integration.semi_implicit_euler(h, r.inv_mass, r.x, r.v,
                                                 accel)
        iw, inv_iw = r.inertia_world()
        inv_iw = inv_iw * (r.inv_mass > 0.0)[..., None, None]
        rq, romega = integration.semi_implicit_euler_rotation(
            h, r.inv_mass, iw, inv_iw, r.q, r.omega, r.ext_torque)
        r = dataclasses.replace(r, x=rx, q=rq, v=rv, omega=romega)
    x, rx, rq, solid_lam = project_positions(
        x, p.inv_mass, cset, h, cfg, passes, rigid=r, time=state.time,
        solid_contacts=solid_contacts)
    if cfg.velocity_update_method == 1:
        v = integration.velocity_update_second_order(
            h, p.inv_mass, x, old_x, last_x, v)
    else:
        v = integration.velocity_update_first_order(h, p.inv_mass, x,
                                                    old_x, v)
    if cfg.damping:
        v = v * (1.0 - cfg.damping)
    particles = dataclasses.replace(p, x=x, v=v, old_x=old_x, last_x=last_x)
    rigid = r
    if r is not None:
        s0 = state.rigid
        if cfg.velocity_update_method == 1:
            rv = integration.velocity_update_second_order(
                h, r.inv_mass, rx, s0.x, s0.old_x, r.v)
            romega = integration.angular_velocity_update_second_order(
                h, r.inv_mass, rq, s0.q, s0.old_q, r.omega)
        else:
            rv = integration.velocity_update_first_order(
                h, r.inv_mass, rx, s0.x, r.v)
            romega = integration.angular_velocity_update_first_order(
                h, r.inv_mass, rq, s0.q, r.omega)
        rigid = dataclasses.replace(
            r, x=rx, q=rq, v=rv, omega=romega, old_x=s0.x, last_x=s0.old_x,
            old_q=s0.q, last_q=s0.old_q)
    return (dataclasses.replace(state, particles=particles, rigid=rigid),
            solid_lam)


def _max_overflow(overflow: Optional[Tensor], new: Optional[Tensor]):
    """The state's counter raised to ``new`` (JAX's ``jnp.maximum``
    accumulation, ``step.py:485-492, 553-561``)."""
    if overflow is None or new is None:
        return overflow
    return torch.maximum(overflow, new)


def velocity_constraint_projection(state: SimState, cset: ConstraintSet,
                                   cfg: StepConfig, pipeline=None,
                                   solid_contacts=None,
                                   solid_lam=None) -> SimState:
    """Velocity-level projection once a step, after the substeps
    (``TimeStepController::velocityConstraintProjection``,
    ``TimeStepController.cpp:298-357``; ``step.py:455-535``): the
    particle–tet friction pass with the last position pass's λ, then, on
    a scene with rigid bodies, the rigid–rigid and particle–rigid
    detection (its overflow into ``state.overflow``) and
    ``max_iterations_v`` passes over the velocity-motor joints and the two
    contact families (per-contact impulse sums carried across passes), in
    ``contact_solver_mode``, with the masked world inverse inertia of the
    step's final rotations."""
    from ..collision import contacts as cops
    from ..collision.batched import flat_contacts

    r = state.rigid
    vel_batches = [jb for jb in cset.joints if jb.has_velocity_solve]
    has_contacts = (pipeline is not None and pipeline.active
                    and r is not None)
    if solid_contacts is not None:
        from ..collision.solid import solve_solid_contacts_velocity
        p = state.particles
        pv = p.v + solve_solid_contacts_velocity(
            solid_contacts, p.x, p.v, p.inv_mass, lam=solid_lam)
        state = dataclasses.replace(
            state, particles=dataclasses.replace(p, v=pv))
    if r is None or not (vel_batches or has_contacts):
        return state
    p = state.particles
    rv, romega = r.v, r.omega
    iw = _masked_inv_inertia_w(r.q, r.inertia0, r.inv_mass)
    rc = pc = None
    if has_contacts:
        from ..collision.detection import contacts_overflow
        rc = pipeline.detect_rigid(r)
        pc = pipeline.detect_particles(p.x, p.v, p.inv_mass, r)
        state = dataclasses.replace(state, overflow=_max_overflow(
            state.overflow, contacts_overflow(rc, pc)))
    # the contact solves run on one flattened batch axis
    nd = r.x.dim() - 2
    lead, nr, n = r.x.shape[:nd], r.x.shape[-2], p.x.shape[-2]
    rx_f = r.x.reshape(-1, nr, 3)
    iw_f = iw.reshape(-1, nr, 3, 3)
    if rc is not None:
        rc = flat_contacts(rc, nd)
        rc_sum = torch.zeros_like(rc.nkn_inv)
    if pc is not None:
        pc = flat_contacts(pc, nd)
        pc_sum = torch.zeros_like(pc.nkn_inv)
        pv_f = p.v.reshape(-1, n, 3)
        pw = (p.inv_mass if p.inv_mass.dim() == 1
              else p.inv_mass.reshape(-1, n))
    sequential = cfg.contact_solver_mode == "gauss_seidel"
    solve_rc = (cops._solve_rigid_sequential if sequential
                else cops._solve_rigid)
    solve_pc = (cops._solve_particle_rigid_sequential if sequential
                else cops._solve_particle_rigid)
    gs = cfg.joint_solver_mode == "gauss_seidel"
    for _ in range(cfg.max_iterations_v):
        for jb in vel_batches:
            flat = jb.bodies.reshape(-1)
            for factor in (jb._color_factors if gs else (None,)):
                corr_v, corr_om = jb.solve_velocity(
                    r.x, r.q, rv, romega, r.inv_mass, iw, state.time)
                if factor is not None:
                    corr_v, corr_om = corr_v * factor, corr_om * factor
                rv = rv.index_add(-2, flat, _rows(corr_v))
                romega = romega.index_add(-2, flat, _rows(corr_om))
        if rc is None and pc is None:
            continue
        rv_f, om_f = rv.reshape(-1, nr, 3), romega.reshape(-1, nr, 3)
        if rc is not None:
            rv_f, om_f, rc_sum = solve_rc(
                rc, rx_f, rv_f, om_f, r.inv_mass, iw_f, rc_sum,
                cfg.contact_stiffness_rb)
        if pc is not None:
            pv_f, rv_f, om_f, pc_sum = solve_pc(
                pc, pv_f, pw, rx_f, rv_f, om_f, r.inv_mass, iw_f, pc_sum,
                cfg.contact_stiffness_particle_rb)
        rv = rv_f.reshape(*lead, nr, 3)
        romega = om_f.reshape(*lead, nr, 3)
    state = dataclasses.replace(
        state, rigid=dataclasses.replace(r, v=rv, omega=romega))
    if pc is not None:
        state = dataclasses.replace(state, particles=dataclasses.replace(
            p, v=pv_f.reshape(p.v.shape)))
    return state


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
    particle batch, joint or rigid body never takes it: the kernels solve
    their grid only."""
    dev = cset.device
    if (dev is None or dev.type != "cuda" or cset.particle_batches()
            or cset.joints or cset.n_rigid):
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
         plan: Optional[KernelPlan] = None, passes=None,
         pipeline=None) -> SimState:
    """One full sim step: ``substeps`` substeps, the velocity-level
    projection, then ``time += dt`` (``step.py:538-571``). With a ``plan``
    from :func:`kernel_plan` the substeps run through its kernel, else
    through the PyTorch ops, with the particle families' ``passes`` from
    :func:`batch_passes` (computed here when None); ``make_step_fn`` and
    ``rollout`` compute both once. A collision ``pipeline`` detects the
    particle–tet contacts before the substeps (their overflow into
    ``state.overflow``) and the other contacts in the velocity-level
    projection."""
    if state.orientations is not None:
        raise NotImplementedError(
            "orientation particles come with the rod slice (7) of the port")
    if plan is not None:
        if state.rigid is not None or _has_pipeline(pipeline):
            raise ValueError(
                "the kernel route steps particles only; a state with rigid "
                "bodies or a collision pipeline needs the PyTorch route "
                "(a constraint set that records its bodies, n_rigid, as "
                "SceneBuilder and convert.scene_from_numpy set it)")
        state = _kernel_substeps(state, plan, cfg)
        return dataclasses.replace(state, time=state.time + cfg.dt)
    if passes is None:
        passes = batch_passes(cset, cfg, state.particles.n)
    solid_contacts = solid_lam = None
    if pipeline is not None and pipeline.solid_pairs:
        p = state.particles
        solid_contacts = pipeline.detect_solids(p.x, p.v, p.inv_mass)
        state = dataclasses.replace(state, overflow=_max_overflow(
            state.overflow, solid_contacts.overflow))
    h = cfg.dt / cfg.substeps
    for _ in range(cfg.substeps):
        state, solid_lam = _substep(state, cset, h, cfg, passes,
                                    solid_contacts)
    state = velocity_constraint_projection(state, cset, cfg, pipeline,
                                           solid_contacts, solid_lam)
    return dataclasses.replace(state, time=state.time + cfg.dt)


def _has_pipeline(pipeline) -> bool:
    return pipeline is not None and pipeline.active


def _route(cset: ConstraintSet, cfg: StepConfig, n: int, pipeline=None):
    """``(plan, passes, path)`` of a scene: the kernel plan, or the
    particle passes and the PyTorch route's name. A collision pipeline
    takes the PyTorch route."""
    plan = None if _has_pipeline(pipeline) else kernel_plan(cset, cfg)
    if plan is not None:
        return plan, (), PATH_KERNEL
    passes = batch_passes(cset, cfg, n)
    if cset.joints or cset.n_rigid:
        return None, passes, PATH_RIGID
    return None, passes, PATH_UNSTRUCTURED if passes else PATH_STENCIL


def make_step_fn(cset: ConstraintSet, cfg: StepConfig, device=None,
                 pipeline=None):
    """``state → state`` closure over a fixed scene on ``device`` (None
    means CUDA), with its collision ``pipeline`` when given (moved to
    ``device``). ``fn.path`` names the route its steps take,
    ``"cuda_kernel"``, ``"torch_rigid"``, ``"torch_unstructured"`` or
    ``"torch_stencil"``; a scene with a pipeline never takes the kernel
    route."""
    dev = resolve_device(device)
    if cset.device is not None and cset.device != dev:
        cset = cset.to(dev)
    if pipeline is not None and pipeline.device not in (None, dev):
        pipeline = pipeline.to(dev)
    n = cset.n_particles
    if n is None and cset.particle_batches():
        raise ValueError("a constraint set with particle batches needs its "
                         "n_particles; build it with SceneBuilder or "
                         "convert.scene_from_numpy")
    plan, passes, path = _route(cset, cfg, n, pipeline)

    def fn(state: SimState) -> SimState:
        if state.particles.x.device != dev:
            raise ValueError(f"step function built for {dev}; the state "
                             f"is on {state.particles.x.device}")
        return step(state, cset, cfg, plan, passes, pipeline)

    fn.path = path
    return fn


def rollout(state: SimState, cset: ConstraintSet, cfg: StepConfig,
            n_steps: int, collect: bool = False, pipeline=None):
    """Run ``n_steps`` sim steps (with the collision ``pipeline`` when
    given). Returns ``(final state, trajectory)``: the stacked positions
    ``(n_steps, ..., N, 3)`` when ``collect``, else None — the shape of
    the JAX ``rollout``'s scan result."""
    if state.particles.x.device.type == "cuda":
        plan, passes, _ = _route(cset, cfg, state.particles.n, pipeline)
    else:
        plan, passes = None, batch_passes(cset, cfg, state.particles.n)
    xs = []
    for _ in range(n_steps):
        state = step(state, cset, cfg, plan, passes, pipeline)
        if collect:
            xs.append(state.particles.x)
    return state, (torch.stack(xs) if collect else None)
