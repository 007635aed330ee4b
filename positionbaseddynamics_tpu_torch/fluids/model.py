"""Position-Based Fluids: state, scene and time stepper — the counterpart
of ``positionbaseddynamics_tpu/fluids/model.py`` (the FluidDemo model and
stepper, ``Demos/FluidDemo/TimeStepFluidModel.cpp:21-68``): CFL-clamped
dt, semi-implicit Euler, a neighbor search, 5 iterations of the PBF
density constraint (``PositionBasedFluids.cpp``), the first-order
velocity update and XSPH viscosity, with Akinci boundary ψ weights
(``FluidModel.cpp:110-149``).

Two routes, as in JAX:

* a scene with a domain (``FluidScene.create(..., domain=(lo, hi))``)
  steps through the cell-dense tables of ``cellgrid.py``. On the card the
  density, correction and XSPH passes run as the CUDA kernels of
  ``cellgrid_cuda.py`` (11 launches a step at 5 iterations); on the CPU as
  their plain PyTorch versions. The JAX default runs the same math through
  the occupancy classes of ``classgrid.py``, which exist to shrink the
  TPU's dead pair lanes; the kernels walk each cell's real occupancy and
  need no classes. ``_fluid_step_cells(partition=True)`` takes the class
  route, in plain PyTorch on either device.
* a scene without one steps through the sort-based hash candidates of
  ``neighborhood.py`` in plain PyTorch on either device.

No step syncs the host: ``dt``, ``time`` and ``overflow`` stay 0-d device
tensors. ``overflow`` is the loud capacity counter; every drive must
check it is 0.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import sph
from .cellgrid import (CellGridSpec, build_fluid_tables, pbf_iterations,
                       scatter_planes, xsph_cell)
from .classgrid import (partition_active, pbf_iterations_classes,
                        xsph_classes)
from .neighborhood import cell_overflow, neighbor_candidates

Tensor = torch.Tensor


@dataclass(frozen=True)
class FluidState:
    """Fluid particle state (positions, velocities and step history)."""

    x: Tensor       # (N, 3)
    v: Tensor       # (N, 3)
    old_x: Tensor   # (N, 3)
    last_x: Tensor  # (N, 3)
    time: Tensor    # 0-d
    dt: Tensor      # 0-d: the CFL-adapted step carried across steps
    # running max of the capacity overflow counts (cell and active-cell
    # caps on the cell route, the per-cell candidate cap on the hash
    # route): the loud failure signal of the fluid pipeline
    overflow: Optional[Tensor] = None

    @staticmethod
    def create(x, dt0: float = 0.005, device=None) -> "FluidState":
        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        z = torch.zeros_like(x)
        return FluidState(x=x, v=z, old_x=x, last_x=x,
                          time=torch.zeros((), device=dev),
                          dt=torch.tensor(dt0, dtype=torch.float32,
                                          device=dev),
                          overflow=torch.zeros((), device=dev))


@dataclass(frozen=True)
class FluidScene:
    """Static fluid scene: particle masses, boundary particles with their
    Akinci ψ weights, and solver parameters (reference defaults
    density0 = 1000, particleRadius = 0.025, support = 4·r)."""

    mass: Tensor            # (N,)
    boundary_x: Tensor      # (B, 3)
    boundary_psi: Tensor    # (B,)
    density0: float
    support_radius: float
    viscosity: float
    iterations: int
    cap_per_cell: int
    min_dt: float
    max_dt: float
    particle_radius: float
    gravity: tuple
    # hash-route candidate cap (box wall and corner cells hold far more
    # particles than the fluid at rest)
    hash_cap: int = 12
    # the cell-dense route's grid, set when the scene has domain bounds
    cellgrid: Optional[CellGridSpec] = None

    @property
    def n_fluid(self) -> int:
        return self.mass.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def to(self, device) -> "FluidScene":
        return dataclasses.replace(
            self, mass=self.mass.to(device),
            boundary_x=self.boundary_x.to(device),
            boundary_psi=self.boundary_psi.to(device),
            cellgrid=None if self.cellgrid is None
            else self.cellgrid.to(device))

    @staticmethod
    def create(n_fluid, boundary_x, density0=1000.0, particle_radius=0.025,
               viscosity=0.02, iterations=5, cap_per_cell=12,
               min_dt=1e-4, max_dt=5e-3, gravity=(0.0, -9.81, 0.0),
               domain=None, device=None):
        """Masses per ``FluidModel::initMasses`` (0.8·diam³·ρ₀); boundary
        ψ per ``FluidModel::initBoundaryPsi`` — ψᵢ = ρ₀/ΣⱼW(xᵢ−xⱼ) over
        boundary neighbors, computed on ``device`` (None means CUDA)."""
        dev = resolve_device(device)
        support = 4.0 * particle_radius
        diam = 2.0 * particle_radius
        mass = np.full((n_fluid,), 0.8 * diam**3 * density0, np.float32)
        boundary_x = np.asarray(boundary_x, np.float32).reshape(-1, 3)

        bx = torch.tensor(boundary_x, device=dev)
        if boundary_x.shape[0]:
            # a deep per-cell cap: wall and corner cells hold up to
            # ~(h/diam)³ boundary particles
            idx, valid = neighbor_candidates(bx, support,
                                             max(cap_per_cell, 48))
            r2 = sum((bx[:, c][idx] - bx[:, c][:, None]) ** 2
                     for c in range(3))
            wk = torch.where(valid, sph.w_r(sph.sqrt(r2), support), 0.0)
            del idx, valid, r2
            wsum = torch.sum(wk, dim=-1) + sph.w_zero(support, dev)
            psi = torch.full_like(wsum, density0) / wsum
        else:
            psi = torch.zeros((0,), dtype=torch.float32, device=dev)

        grid = None
        if domain is not None:
            lo, hi = domain
            # impact compression reaches ~3× the rest occupancy, so the
            # cell cap is at least 28
            grid = CellGridSpec.create(
                lo, hi, support, cap=max(cap_per_cell, 28),
                boundary_x=boundary_x, boundary_psi=psi.cpu().numpy(),
                n_fluid_hint=n_fluid, device=dev)

        return FluidScene(
            mass=torch.tensor(mass, device=dev), boundary_x=bx,
            boundary_psi=psi, density0=float(density0),
            support_radius=float(support), viscosity=float(viscosity),
            iterations=int(iterations), cap_per_cell=int(cap_per_cell),
            min_dt=float(min_dt), max_dt=float(max_dt),
            particle_radius=float(particle_radius), gravity=tuple(gravity),
            cellgrid=grid,
            hash_cap=(max(int(cap_per_cell), 32) if boundary_x.shape[0]
                      else int(cap_per_cell)))


def _sph_sums(x_all, scene: FluidScene):
    """Neighbor candidates over the concatenated fluid + boundary array.
    Returns ``(idx, valid, is_fluid_j, weight_j)``, ``weight_j`` the mass
    of a fluid neighbor and the ψ of a boundary one."""
    n = scene.n_fluid
    idx, valid = neighbor_candidates(x_all, scene.support_radius,
                                     scene.hash_cap)
    idx = idx[:n]
    valid = valid[:n]
    is_fluid_j = idx < n
    other = (scene.boundary_psi[torch.clamp_min(idx - n, 0)]
             if scene.boundary_psi.shape[0] else 0.0)
    w_j = torch.where(is_fluid_j, scene.mass[torch.clamp_max(idx, n - 1)],
                      other)
    return idx, valid, is_fluid_j, w_j


def compute_density(x_all, idx, valid, w_j, scene: FluidScene) -> Tensor:
    """``computePBFDensity`` (``PositionBasedFluids.cpp:8-40``):
    ρᵢ = mᵢ·W(0) + Σⱼ wⱼ·W(xᵢ−xⱼ) (wⱼ = mass or boundary ψ)."""
    n = scene.n_fluid
    d = x_all[:n, None, :] - x_all[idx]
    wk = torch.where(valid, sph.w(d, scene.support_radius), 0.0)
    return (scene.mass * sph.w_zero(scene.support_radius, x_all.device)
            + torch.sum(w_j * wk, -1))


def compute_lambda(x_all, idx, valid, w_j, density, scene: FluidScene
                   ) -> Tensor:
    """``computePBFLagrangeMultiplier`` (``PositionBasedFluids.cpp:43-97``):
    C = max(ρ/ρ₀ − 1, 0); λ = −C / (Σ‖∇C‖² + ε)."""
    n = scene.n_fluid
    eps = 1.0e-6
    c = torch.clamp_min(density / scene.density0 - 1.0, 0.0)
    d = x_all[:n, None, :] - x_all[idx]
    grad_j = (-(w_j / scene.density0)[..., None]
              * sph.grad_w(d, scene.support_radius))
    grad_j = torch.where(valid[..., None], grad_j, 0.0)
    sum_grad2 = torch.sum(_sum3(grad_j * grad_j), -1)
    grad_i = -torch.sum(grad_j, -2)
    sum_grad2 = sum_grad2 + _sum3(grad_i * grad_i)
    return torch.where(c > 0.0, -c / (sum_grad2 + eps), 0.0)


def solve_density_constraint(x_all, idx, valid, is_fluid_j, w_j, lam,
                             scene: FluidScene) -> Tensor:
    """``solveDensityConstraint`` (``PositionBasedFluids.cpp:100-141``):
    Δxᵢ = −Σⱼ (λᵢ + λⱼ[fluid]) · ∇Cⱼ."""
    n = scene.n_fluid
    d = x_all[:n, None, :] - x_all[idx]
    grad_j = (-(w_j / scene.density0)[..., None]
              * sph.grad_w(d, scene.support_radius))
    lam_j = torch.where(is_fluid_j, lam[torch.clamp_max(idx, n - 1)], 0.0)
    coef = lam[:, None] + lam_j
    return -torch.sum(torch.where(valid[..., None], coef[..., None] * grad_j,
                                  0.0), dim=-2)


def xsph_viscosity(x, v, idx, valid, is_fluid_j, density, scene: FluidScene
                   ) -> Tensor:
    """XSPH smoothing (``TimeStepFluidModel::computeXSPHViscosity``):
    vᵢ ← vᵢ − ν Σⱼ (mⱼ/ρⱼ)(vᵢ−vⱼ) W(xᵢ−xⱼ) over fluid neighbors."""
    n = scene.n_fluid
    jf = torch.clamp_max(idx, n - 1)
    ok = valid & is_fluid_j
    r2 = sum((x[:, c][:, None] - x[:, c][jf]) ** 2 for c in range(3))
    wk = torch.where(ok, sph.w_r(sph.sqrt(r2), scene.support_radius), 0.0)
    coef = scene.mass[jf] / torch.clamp_min(density[jf], 1e-6) * wk
    dv = torch.stack(
        [torch.sum(coef * (v[:, c][:, None] - v[:, c][jf]), -1)
         for c in range(3)], -1)
    return v - scene.viscosity * dv


def _sum3(a: Tensor) -> Tensor:
    """Sum over a last axis of 3, left to right."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def cfl_dt(v, a, dt, scene: FluidScene) -> Tensor:
    """CFL clamp (``TimeStepFluidModel::updateTimeStepSizeCFL``):
    h = 0.4·diam/√max(0.1, max‖v + a·h‖²), clamped to [min_dt, max_dt];
    a 0-d tensor on the state's device (no host sync)."""
    u = v + a * dt
    vel2 = _sum3(u * u)
    floor = torch.full((), 0.1, dtype=torch.float32, device=v.device)
    max_vel = torch.maximum(torch.max(vel2), floor) if vel2.numel() \
        else floor
    diam = 2.0 * scene.particle_radius
    h = torch.full_like(max_vel, 0.4 * diam) / sph.sqrt(max_vel)
    return torch.clamp(h, scene.min_dt, scene.max_dt)


def _pbf_iteration(x_all, idx, valid, is_fluid_j, w_j, scene: FluidScene):
    """One density-projection iteration of the hash route: the math of
    :func:`compute_density` → :func:`compute_lambda` →
    :func:`solve_density_constraint` with the ``(N, K)`` displacement
    planes formed once. Returns ``(corr (N, 3), density (N,))``."""
    n = scene.n_fluid
    eps = 1.0e-6
    h = scene.support_radius
    dc = [x_all[:n, c][:, None] - x_all[:, c][idx] for c in range(3)]
    r2 = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]
    rl = sph.sqrt(r2)
    wk = torch.where(valid, sph.w_r(rl, h), 0.0)
    density = (scene.mass * sph.w_zero(h, x_all.device)
               + torch.sum(w_j * wk, -1))
    gc = -(w_j / scene.density0) * sph.grad_w_coef(rl, h)
    gc = torch.where(valid, gc, 0.0)
    c = torch.clamp_min(density / scene.density0 - 1.0, 0.0)
    sum_grad2 = torch.sum(gc * gc * r2, -1)
    grad_i = [-torch.sum(gc * dc[k], -1) for k in range(3)]
    sum_grad2 = sum_grad2 + sum(g * g for g in grad_i)
    lam = torch.where(c > 0.0, -c / (sum_grad2 + eps), 0.0)
    lam_j = torch.where(is_fluid_j, lam[torch.clamp_max(idx, n - 1)], 0.0)
    coef = (lam[:, None] + lam_j) * gc
    corr = torch.stack([-torch.sum(coef * dc[k], -1) for k in range(3)], -1)
    return corr, density


@functools.lru_cache(maxsize=16)
def _vector(values: tuple, device) -> Tensor:
    """A constant float32 vector on ``device``, copied from the host once
    (a copy at every step would sync the host)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _gravity(state: FluidState, scene: FluidScene) -> Tensor:
    return _vector(tuple(scene.gravity), state.x.device).expand_as(state.x)


def _overflow(state: FluidState, step_count: Tensor) -> Tensor:
    prev = state.overflow if state.overflow is not None \
        else torch.zeros((), device=state.x.device)
    return torch.maximum(prev, step_count.to(torch.float32))


def _cell_step(state: FluidState, scene: FluidScene, kernels: bool,
               chunk=None, classes: bool = False) -> FluidState:
    """The cell-dense step with the passes run as the CUDA kernels
    (``kernels``), as their plain versions (``chunk`` active cells at a
    time when given), or through the occupancy classes of ``classgrid.py``
    (``classes``), whose class overflow adds to the table build's as in
    JAX (``model.py:336-341``)."""
    spec = scene.cellgrid
    a = _gravity(state, scene)
    h = cfl_dt(state.v, a, state.dt, scene)

    last_x, old_x = state.old_x, state.x
    v = state.v + h * a
    x = state.x + h * v

    (slot, kept, xt, mt, active, nbr, nbr_ok,
     overflow) = build_fluid_tables(spec, x, scene.mass)
    nslots = spec.n_cells * spec.cap
    sl = slot.to(torch.int64)
    args = (spec, xt, mt, active, nbr, nbr_ok)
    if classes:
        narrow, full, bnd, over_c = partition_active(spec, mt)
        overflow = overflow + over_c
        xt_new, density, ctxs = pbf_iterations_classes(
            spec, xt, mt, narrow, full, bnd, scene.iterations,
            scene.density0, scene.support_radius)
    elif kernels:
        from .cellgrid_cuda import pbf_step_cuda

        xt_new, density, _ = pbf_step_cuda(
            *args, scene.iterations, scene.density0, scene.support_radius)
    else:
        xt_new, density, _ = pbf_iterations(
            *args, scene.iterations, scene.density0, scene.support_radius,
            chunk=chunk)
    x_new = torch.where(kept[:, None], xt_new.reshape(3, -1)[:, sl].t(), x)
    v = (x_new - old_x) / h

    vt = scatter_planes(v, slot, kept, nslots, (spec.n_cells, spec.cap))
    if classes:
        vt = xsph_classes(spec, xt_new, vt, mt, ctxs, density,
                          scene.viscosity, scene.support_radius)
    elif kernels:
        _, _, vt = pbf_step_cuda(
            spec, xt_new, mt, active, nbr, nbr_ok, 0, scene.density0,
            scene.support_radius, vt=vt, viscosity=scene.viscosity,
            density=density, xt0=xt)
    else:
        vt = xsph_cell(spec, xt_new, vt, mt, active, nbr, nbr_ok, density,
                       scene.viscosity, scene.support_radius, xt,
                       chunk=chunk)
    v = torch.where(kept[:, None], vt.reshape(3, -1)[:, sl].t(), v)
    return FluidState(x=x_new, v=v, old_x=old_x, last_x=last_x,
                      time=state.time + h, dt=h,
                      overflow=_overflow(state, overflow))


def _fluid_step_cells(state: FluidState, scene: FluidScene,
                      partition=None) -> FluidState:
    """Cell-dense PBF step (``cellgrid.py``): sort into per-cell tables
    once, then the density iterations and XSPH over the active cells. On
    CUDA tensors the passes are the kernels of ``cellgrid_cuda.py``; on
    CPU tensors their plain versions (:func:`fluid_step_reference` runs
    those on any device, in chunks). ``partition=True`` takes JAX's
    occupancy classes (``classgrid.py``) in plain PyTorch on either device;
    None or False keeps the route above on both (JAX's default takes the
    classes when the cap exceeds 20, ``use_classes``)."""
    if scene.cellgrid is None:
        raise ValueError("the cell-dense step needs a scene with a cell "
                         "grid (FluidScene.create(..., domain=...))")
    if partition:
        return _cell_step(state, scene, kernels=False, classes=True)
    return _cell_step(state, scene, kernels=state.x.is_cuda)


def fluid_step_reference(state: FluidState, scene: FluidScene,
                         chunk=None) -> FluidState:
    """The plain version of the cell-dense step on any device: the same
    step as :func:`_fluid_step_cells` with every pass in plain PyTorch,
    ``chunk`` active cells at a time when given (at the 100k dam the
    unchunked pair planes need ~10 GB)."""
    return _cell_step(state, scene, kernels=False, chunk=chunk)


def fluid_step(state: FluidState, scene: FluidScene) -> FluidState:
    """One PBF step (``TimeStepFluidModel::step``,
    ``TimeStepFluidModel.cpp:21-68``)."""
    if scene.cellgrid is not None:
        return _fluid_step_cells(state, scene)
    a = _gravity(state, scene)
    h = cfl_dt(state.v, a, state.dt, scene)

    last_x, old_x = state.old_x, state.x
    v = state.v + h * a
    x = state.x + h * v

    n = scene.n_fluid
    x_all = torch.cat([x, scene.boundary_x], 0)
    idx, valid, is_fluid_j, w_j = _sph_sums(x_all, scene)
    ov_step = cell_overflow(x_all, scene.support_radius, scene.hash_cap)

    density = None
    for _ in range(scene.iterations):
        corr, density = _pbf_iteration(x_all, idx, valid, is_fluid_j, w_j,
                                       scene)
        x_all = torch.cat([x_all[:n] + corr, x_all[n:]], 0)
    x = x_all[:n]

    v = (x - old_x) / h
    v = xsph_viscosity(x, v, idx, valid, is_fluid_j, density, scene)
    return FluidState(x=x, v=v, old_x=old_x, last_x=last_x,
                      time=state.time + h, dt=h,
                      overflow=_overflow(state, ov_step))


def make_fluid_step_fn(scene: FluidScene, device=None):
    """Build ``step(state) -> state`` on ``device`` (None means CUDA; the
    scene is moved there if it lies elsewhere). ``step.path`` names the
    route: ``"cuda_kernel"`` (cell tables, the PBF kernels),
    ``"torch_cells"`` (cell tables, plain passes on the CPU) or
    ``"torch_hash"`` (no domain: hash candidates in plain PyTorch)."""
    dev = resolve_device(device)
    if scene.device != dev:
        scene = scene.to(dev)
    if scene.cellgrid is None:
        path = "torch_hash"
    else:
        path = "cuda_kernel" if dev.type == "cuda" else "torch_cells"

    def step(state: FluidState) -> FluidState:
        if state.x.device != dev:
            raise ValueError(f"step was built for {dev}; got a state on "
                             f"{state.x.device}")
        return fluid_step(state, scene)

    step.path = path
    return step


# ---------------------------------------------------------------------------
# Scene helpers (breaking-dam setup of Demos/FluidDemo/main.cpp:281-360)
# ---------------------------------------------------------------------------


def block_positions(lo, counts, diam) -> np.ndarray:
    """Axis-aligned particle block: ``counts=(nx,ny,nz)`` at spacing diam."""
    ax = [np.arange(c) * diam + l for c, l in zip(counts, lo)]
    g = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(np.float32)


def box_boundary(lo, hi, diam, layers: int = 1) -> np.ndarray:
    """Boundary particle shell for an axis-aligned container box."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    counts = np.maximum(((hi - lo) / diam).astype(int) + 1, 2)
    ax = [np.linspace(lo[i], hi[i], counts[i]) for i in range(3)]
    g = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    rel = (g - lo) / (hi - lo)
    eps = (layers * diam) / np.maximum(hi - lo, 1e-9)
    on_shell = ((rel <= eps) | (rel >= 1.0 - eps)).any(axis=1)
    return g[on_shell].astype(np.float32)
