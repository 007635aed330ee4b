"""Time integration (symplectic Euler + velocity reconstruction).

Port of ``positionbaseddynamics_tpu/ops/integration.py``: every function
works on any leading particle/batch shape and uses ``torch.where`` masks;
static items (``inv_mass == 0``) are left untouched
(``Simulation/ParticleData.h:90``). The rotation functions come with the
rigid-body and rod slices.
"""
from __future__ import annotations

import torch

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
