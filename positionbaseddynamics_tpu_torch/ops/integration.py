"""Time integration (symplectic Euler + velocity reconstruction).

Port of ``positionbaseddynamics_tpu/ops/integration.py``: every function
works on any leading particle/batch shape and uses ``torch.where`` masks;
static items (``inv_mass == 0``) are left untouched
(``Simulation/ParticleData.h:90``). The rotation functions serve the rigid
bodies (slice 6a) and the orientation particles of the rods (slice 7).
"""
from __future__ import annotations

import torch

from . import quaternion as quat
from .mathutils import cross

Tensor = torch.Tensor


def _active(inv_mass: Tensor) -> Tensor:
    """Dynamic-item mask with a trailing broadcast axis."""
    return (inv_mass > 0.0)[..., None]


def semi_implicit_euler(h, inv_mass: Tensor, x: Tensor, v: Tensor, a: Tensor):
    """Symplectic Euler ``v += a h; x += v h`` for dynamic items
    (``TimeIntegration.cpp:7-19``). Returns ``(x_new, v_new)``."""
    act = _active(inv_mass)
    v_new = torch.where(act, v + a * h, v)
    x_new = torch.where(act, x + v_new * h, x)
    return x_new, v_new


def _mv(m: Tensor, v: Tensor) -> Tensor:
    """``m @ v`` for ``(..., 3, 3)`` matrices and ``(..., 3)`` vectors."""
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def semi_implicit_euler_rotation(h, inv_mass: Tensor, inertia_w: Tensor,
                                 inv_inertia_w: Tensor, q: Tensor,
                                 omega: Tensor, torque: Tensor):
    """Rigid rotation with the gyroscopic term, then the quaternion step:
    ``ω += h I⁻¹ (τ − ω × (I ω)); q ← normalize(q + h/2 (0, ω) ⊗ q)``
    (``TimeIntegration.cpp:22-39``, ``integration.py:37-56``).
    ``inertia_w`` / ``inv_inertia_w`` are world-space ``(..., 3, 3)``.
    Returns ``(q_new, omega_new)``."""
    act = _active(inv_mass)
    gyro = torque - cross(omega, _mv(inertia_w, omega))
    omega_new = torch.where(act, omega + h * _mv(inv_inertia_w, gyro),
                            omega)
    q_new = torch.where(act, quat.integrate_angular(q, omega_new, h), q)
    return q_new, omega_new


def semi_implicit_euler_rotation_isotropic(h, inv_mass: Tensor, q: Tensor,
                                           omega: Tensor):
    """Orientation particles with isotropic inertia: no gyroscopic term,
    ω unchanged, only the quaternion advances
    (``TimeStepController.cpp:123-129``, ``integration.py:59-70``).
    Returns ``(q_new, omega_new)``."""
    q_new = torch.where(_active(inv_mass),
                        quat.integrate_angular(q, omega, h), q)
    return q_new, omega


def velocity_update_first_order(h, inv_mass: Tensor, x: Tensor,
                                old_x: Tensor, v: Tensor) -> Tensor:
    """``v = (x − x_old)/h`` (``TimeIntegration.cpp:42-51``)."""
    return torch.where(_active(inv_mass), (x - old_x) / h, v)


def velocity_update_second_order(h, inv_mass: Tensor, x: Tensor,
                                 old_x: Tensor, last_x: Tensor,
                                 v: Tensor) -> Tensor:
    """``v = (1.5x − 2x_old + 0.5x_last)/h`` (``TimeIntegration.cpp:69-78``)."""
    return torch.where(_active(inv_mass),
                       (1.5 * x - 2.0 * old_x + 0.5 * last_x) / h, v)


def angular_velocity_update_first_order(h, inv_mass: Tensor, q: Tensor,
                                        old_q: Tensor,
                                        omega: Tensor) -> Tensor:
    """``ω = 2/h · vec(q ⊗ q̄_old)`` (``TimeIntegration.cpp:54-66``)."""
    rel = quat.multiply(q, quat.conjugate(old_q))
    return torch.where(_active(inv_mass), quat.vec(rel) * (2.0 / h), omega)


def angular_velocity_update_second_order(h, inv_mass: Tensor, q: Tensor,
                                         old_q: Tensor, last_q: Tensor,
                                         omega: Tensor) -> Tensor:
    """The reference's "second-order" angular update
    (``TimeIntegration.cpp:82-96``) is knowingly still first order (its own
    "ToDo" comment); reproduced as the JAX package does, ``last_q``
    unused."""
    return angular_velocity_update_first_order(h, inv_mass, q, old_q, omega)
