"""Control models: how a per-step control vector enters the simulation —
the counterpart of ``positionbaseddynamics_tpu/mpc/controls.py``.

A control model is a small frozen object with ``u_dim`` and
``apply(state, u, dt) -> state``; planners treat controls as flat
``(T, u_dim)`` sequences, or ``(K, T, u_dim)`` for K rollouts.

* :class:`PinVelocityControl` — kinematic velocity of pinned particles
  (``inv_mass == 0`` items are skipped by the integrator,
  ``ops/integration.py``, so their positions advance only here). This is
  the "drag the cloth corner" actuator.
* :class:`RigidWrenchControl` — force and torque on rigid bodies, which
  come with the rigid-body slice (6a) of the port.

JAX vmaps a control model over the K sampled sequences; here ``u`` may
carry the leading rollout axis itself, ``(K, u_dim)``, against a state of
``(K, N, 3)`` positions.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..solver.grid_cloth import _sqrt

Tensor = torch.Tensor


@dataclass(frozen=True)
class PinVelocityControl:
    """u = stacked (3,) velocities of ``indices`` (pinned particles);
    applied as a kinematic position advance ``x += u dt``."""

    indices: tuple
    max_speed: float = math.inf

    @property
    def u_dim(self) -> int:
        return 3 * len(self.indices)

    def apply(self, state, u: Tensor, dt):
        """``u``: ``(u_dim,)``, or ``(K, u_dim)`` for a state of K
        rollouts. Each pin's speed is clamped to ``max_speed`` by its norm
        (``controls.py:40-44``) when ``max_speed`` is finite."""
        p = state.particles
        vel = u.reshape(*u.shape[:-1], len(self.indices), 3)
        if math.isfinite(self.max_speed):
            speed = _sqrt((vel[..., 0:1] * vel[..., 0:1]
                           + vel[..., 1:2] * vel[..., 1:2])
                          + vel[..., 2:3] * vel[..., 2:3])
            vel = vel * torch.clamp_max(
                self.max_speed / torch.clamp_min(speed, 1e-9), 1.0)
        idx = torch.as_tensor(self.indices, dtype=torch.int64,
                              device=p.x.device)
        delta = (vel * dt).expand(*p.x.shape[:-2], len(self.indices), 3)
        x = p.x.index_add(p.x.dim() - 2, idx, delta)
        return dataclasses.replace(
            state, particles=dataclasses.replace(p, x=x))


@dataclass(frozen=True)
class RigidWrenchControl:
    """u = stacked (6,) [force, torque] per controlled rigid body. Rigid
    bodies come with slice 6a of the port; building one raises."""

    body_indices: tuple
    max_force: float = math.inf

    def __post_init__(self):
        raise NotImplementedError(
            "RigidWrenchControl drives rigid bodies, which come with the "
            "rigid-body slice (6a) of the port")
