"""Simulation state as plain dataclasses of tensors.

Port of ``positionbaseddynamics_tpu/solver/state.py``: particles, the
rods' orientation particles and rigid bodies. Every field has its own
tensor: ``create`` never aliases one buffer into several fields. All
leaves may carry a leading batch shape: one scene is ``(N, 3)``, a rollout
batch ``(B, N, 3)``; the inverse masses and the body-frame inertia stay
shared.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .._device import resolve_device
from ..ops import quaternion as quat

Tensor = torch.Tensor


def _inv_mass(masses: Tensor) -> Tensor:
    nz = masses != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, masses, 1.0),
                       torch.zeros_like(masses))


@dataclass(frozen=True)
class ParticleState:
    """Particle field mirroring ``ParticleData`` (``ParticleData.h:86-101``);
    ``x0`` is kept for ``reset()``."""

    x: Tensor         # (..., N, 3) positions
    v: Tensor         # (..., N, 3) velocities
    old_x: Tensor     # (..., N, 3) position before the current substep
    last_x: Tensor    # (..., N, 3) position before the previous substep
    x0: Tensor        # (..., N, 3) initial positions (reset target)
    inv_mass: Tensor  # (..., N)

    @staticmethod
    def create(x, masses, device=None) -> "ParticleState":
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        masses = torch.as_tensor(masses, dtype=torch.float32, device=dev)
        return ParticleState(x=x.clone(), v=torch.zeros_like(x),
                             old_x=x.clone(), last_x=x.clone(),
                             x0=x.clone(), inv_mass=_inv_mass(masses))

    @property
    def n(self) -> int:
        return self.x.shape[-2]

    def to(self, device) -> "ParticleState":
        """The same state with every tensor on ``device``."""
        return ParticleState(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class OrientationState:
    """Quaternions of the Cosserat rods, mirroring ``OrientationData``
    (``ParticleData.h:316-331``; ``state.py:66-91``), layout ``[w, x, y,
    z]``: ``q``, ``omega``, ``old_q``, ``last_q`` ``(..., M, 4)`` / ``(...,
    M, 3)``, ``q0`` and ``inv_mass (M,)`` shared by the rollouts."""

    q: Tensor         # (..., M, 4)
    omega: Tensor     # (..., M, 3) angular velocities
    old_q: Tensor     # (..., M, 4)
    last_q: Tensor    # (..., M, 4)
    q0: Tensor        # (..., M, 4)
    inv_mass: Tensor  # (..., M)

    @staticmethod
    def create(q, masses, device=None) -> "OrientationState":
        dev = resolve_device(device)
        q = torch.as_tensor(q, dtype=torch.float32, device=dev)
        masses = torch.as_tensor(masses, dtype=torch.float32, device=dev)
        return OrientationState(
            q=q.clone(), omega=torch.zeros(q.shape[:-1] + (3,),
                                           dtype=torch.float32, device=dev),
            old_q=q.clone(), last_q=q.clone(), q0=q.clone(),
            inv_mass=_inv_mass(masses))

    @property
    def n(self) -> int:
        return self.q.shape[-2]

    def to(self, device) -> "OrientationState":
        """The same state with every tensor on ``device``."""
        return OrientationState(**{f.name: getattr(self, f.name).to(device)
                                   for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class RigidState:
    """Rigid bodies (``Simulation/RigidBody.h:16-77``; ``state.py:94-143``):
    positions and rotations with their history, velocities, inverse mass
    and the body-frame diagonal inertia; the world-space inertia follows
    the current rotation (:meth:`inertia_world`). ``inv_mass (R,)`` and
    ``inertia0 (R, 3)`` are shared by every rollout of a batched state;
    the other fields are ``(..., R, 3)`` or ``(..., R, 4)``."""

    x: Tensor           # (..., R, 3)
    v: Tensor           # (..., R, 3)
    q: Tensor           # (..., R, 4) [w, x, y, z]
    omega: Tensor       # (..., R, 3)
    old_x: Tensor
    last_x: Tensor
    old_q: Tensor
    last_q: Tensor
    x0: Tensor
    q0: Tensor
    inv_mass: Tensor    # (R,)
    inertia0: Tensor    # (R, 3) body-frame diagonal inertia
    ext_force: Tensor   # (..., R, 3)
    ext_torque: Tensor  # (..., R, 3)

    @staticmethod
    def create(x, q, masses, inertia_diag, device=None) -> "RigidState":
        dev = resolve_device(device)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=dev).clone()

        x, q = f32(x), f32(q)
        return RigidState(
            x=x, v=torch.zeros_like(x), q=q, omega=torch.zeros_like(x),
            old_x=x.clone(), last_x=x.clone(), old_q=q.clone(),
            last_q=q.clone(), x0=x.clone(), q0=q.clone(),
            inv_mass=_inv_mass(f32(masses)), inertia0=f32(inertia_diag),
            ext_force=torch.zeros_like(x), ext_torque=torch.zeros_like(x))

    @property
    def n(self) -> int:
        return self.x.shape[-2]

    def inertia_world(self):
        """World-space inertia and inverse inertia ``(..., R, 3, 3)``,
        ``R diag(I₀) Rᵀ`` and ``R diag(1/I₀) Rᵀ`` (``state.py:135-143``)."""
        r = quat.to_matrix(self.q)
        rt = r.transpose(-1, -2)
        iw = torch.matmul(r * self.inertia0[..., None, :], rt)
        inv_diag = torch.where(self.inertia0 > 0.0,
                               1.0 / torch.clamp_min(self.inertia0, 1e-30),
                               torch.zeros_like(self.inertia0))
        inv_iw = torch.matmul(r * inv_diag[..., None, :], rt)
        return iw, inv_iw

    def to(self, device) -> "RigidState":
        """The same state with every tensor on ``device``."""
        return RigidState(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class SimState:
    """Full simulation state: particles, the rods' orientations and the
    rigid bodies (either of the last two may be None)."""

    particles: ParticleState
    orientations: Optional[OrientationState]
    rigid: Optional[RigidState]
    time: Tensor                      # scalar
    overflow: Optional[Tensor] = None  # capacity-overflow counter

    @staticmethod
    def create(particles: ParticleState, orientations=None,
               rigid=None) -> "SimState":
        dev = particles.x.device
        for name, part in (("rigid bodies", rigid and rigid.x),
                           ("orientations", orientations and orientations.q)):
            if part is not None and part.device != dev:
                raise ValueError(f"{name} on {part.device}, particles on "
                                 f"{dev}")
        return SimState(
            particles=particles, orientations=orientations, rigid=rigid,
            time=torch.zeros((), dtype=torch.float32, device=dev),
            overflow=torch.zeros((), dtype=torch.float32, device=dev))

    def to(self, device) -> "SimState":
        """The same state with every tensor on ``device``."""
        return dataclasses.replace(
            self, particles=self.particles.to(device),
            orientations=(None if self.orientations is None
                          else self.orientations.to(device)),
            rigid=None if self.rigid is None else self.rigid.to(device),
            time=self.time.to(device),
            overflow=None if self.overflow is None
            else self.overflow.to(device))

    def reset(self) -> "SimState":
        """Restore initial positions and rotations and zero velocities
        (``SimulationModel.cpp:270-304``; ``state.py:171-195``)."""
        p = self.particles
        p = ParticleState(x=p.x0.clone(), v=torch.zeros_like(p.v),
                          old_x=p.x0.clone(), last_x=p.x0.clone(),
                          x0=p.x0, inv_mass=p.inv_mass)
        o = self.orientations
        if o is not None:
            o = dataclasses.replace(
                o, q=o.q0.clone(), omega=torch.zeros_like(o.omega),
                old_q=o.q0.clone(), last_q=o.q0.clone())
        r = self.rigid
        if r is not None:
            z = torch.zeros_like(r.v)
            r = dataclasses.replace(
                r, x=r.x0.clone(), q=r.q0.clone(), v=z, omega=z.clone(),
                old_x=r.x0.clone(), last_x=r.x0.clone(), old_q=r.q0.clone(),
                last_q=r.q0.clone(), ext_force=z.clone(),
                ext_torque=z.clone())
        return dataclasses.replace(
            self, particles=p, orientations=o, rigid=r,
            time=torch.zeros_like(self.time),
            overflow=(None if self.overflow is None
                      else torch.zeros_like(self.overflow)))
