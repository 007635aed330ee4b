"""Simulation state as plain dataclasses of tensors.

Port of ``positionbaseddynamics_tpu/solver/state.py`` (particle fields
only; orientations and rigid bodies come with later slices and stay
None). Every field has its own tensor: ``create`` never aliases one
buffer into several fields. All leaves may carry a leading batch shape:
one scene is ``(N, 3)``, a rollout batch ``(B, N, 3)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .._device import resolve_device

Tensor = torch.Tensor


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
        nz = masses != 0.0
        inv_mass = torch.where(nz, 1.0 / torch.where(nz, masses, 1.0),
                               torch.zeros_like(masses))
        return ParticleState(x=x.clone(), v=torch.zeros_like(x),
                             old_x=x.clone(), last_x=x.clone(),
                             x0=x.clone(), inv_mass=inv_mass)

    @property
    def n(self) -> int:
        return self.x.shape[-2]

    def to(self, device) -> "ParticleState":
        """The same state with every tensor on ``device``."""
        return ParticleState(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class SimState:
    """Full simulation state. ``orientations`` and ``rigid`` are None
    until the rod and rigid-body slices port them."""

    particles: ParticleState
    orientations: Optional[object]
    rigid: Optional[object]
    time: Tensor                      # scalar
    overflow: Optional[Tensor] = None  # capacity-overflow counter

    @staticmethod
    def create(particles: ParticleState, orientations=None,
               rigid=None) -> "SimState":
        if orientations is not None or rigid is not None:
            raise NotImplementedError(
                "orientations and rigid bodies come with the rod (slice 7) "
                "and rigid-body (slice 6) slices of the port")
        dev = particles.x.device
        return SimState(
            particles=particles, orientations=None, rigid=None,
            time=torch.zeros((), dtype=torch.float32, device=dev),
            overflow=torch.zeros((), dtype=torch.float32, device=dev))

    def to(self, device) -> "SimState":
        """The same state with every tensor on ``device``."""
        return dataclasses.replace(
            self, particles=self.particles.to(device),
            time=self.time.to(device),
            overflow=None if self.overflow is None
            else self.overflow.to(device))

    def reset(self) -> "SimState":
        """Restore initial positions and zero velocities
        (``SimulationModel.cpp:270-304``)."""
        p = self.particles
        p = ParticleState(x=p.x0.clone(), v=torch.zeros_like(p.v),
                          old_x=p.x0.clone(), last_x=p.x0.clone(),
                          x0=p.x0, inv_mass=p.inv_mass)
        return dataclasses.replace(
            self, particles=p, time=torch.zeros_like(self.time),
            overflow=(None if self.overflow is None
                      else torch.zeros_like(self.overflow)))
