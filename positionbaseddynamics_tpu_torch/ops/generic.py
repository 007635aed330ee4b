"""Generic user-defined constraints, their Jacobians by forward-mode
differentiation.

Port of ``positionbaseddynamics_tpu/ops/generic.py``, after
``PositionBasedGenericConstraints.h:31-121`` (particles) and ``:218-280``
(rigid bodies), where the reference takes central finite differences.
JAX takes ``jax.jacfwd`` of the user's constraint function; here the
function is a torch function of one constraint's stacked inputs and its
Jacobian comes from ``torch.func.jacfwd``, vmapped over the constraint
rows (and rollouts) by :func:`rowwise`. Each row solves ``Σᵢ wᵢ Jᵢ Jᵢᵀ y =
C`` (plus ``1e-9·I``) and takes ``Δxᵢ = −wᵢ Jᵢᵀ y``.
"""
from __future__ import annotations

import torch

from . import quaternion as quat

Tensor = torch.Tensor


def _solve(factor: Tensor, c: Tensor) -> Tensor:
    eye = torch.eye(c.shape[-1], dtype=factor.dtype, device=factor.device)
    return torch.linalg.solve_ex(factor + 1e-9 * eye, c.unsqueeze(-1),
                                 check_errors=False)[0].squeeze(-1)


def solve_generic_particle_constraint(fn, pts: Tensor, w: Tensor,
                                      stiffness=1.0) -> Tensor:
    """One particle constraint: ``fn(pts (k, 3)) -> (d,)``, ``w (k,)``
    inverse masses. Returns corrections ``(k, 3)``
    (``generic.py:27-38``)."""
    from torch.func import jacfwd

    c = torch.atleast_1d(fn(pts))
    # a 0-D result meeting a Python scalar gets a float64 tangent
    jac = jacfwd(lambda p: torch.atleast_1d(fn(p)))(pts).to(pts.dtype)
    factor = torch.einsum("dki,k,eki->de", jac, w, jac)
    y = _solve(factor, c)
    return -stiffness * w[:, None] * torch.einsum("dki,d->ki", jac, y)


def solve_generic_rigid_constraint(fn, x: Tensor, q: Tensor, w: Tensor,
                                   inv_iw: Tensor, stiffness=1.0):
    """One rigid-body constraint: ``fn(x (k, 3), q (k, 4)) -> (d,)``. The
    rotation Jacobians are taken with respect to a world-frame angular
    displacement θ through ``δq = ½ (0, θ) ⊗ q`` (``generic.py:41-69``).
    Returns ``(corr_x (k, 3), ot (k, 3))``, ``ot`` the angular term of
    ``rotation_correction``."""
    from torch.func import jacfwd

    zeros = torch.zeros_like(x)

    def with_theta(xx, theta):
        dq = 0.5 * quat.multiply(quat.from_vec(theta), q)
        return torch.atleast_1d(fn(xx, q + dq))

    c = torch.atleast_1d(fn(x, q))
    jx, jt = (j.to(x.dtype) for j in jacfwd(with_theta, argnums=(0, 1))(
        x, zeros))                                          # (d, k, 3)
    factor = (torch.einsum("dki,k,eki->de", jx, w, jx)
              + torch.einsum("dki,kij,ekj->de", jt, inv_iw, jt))
    y = _solve(factor, c)
    corr_x = -stiffness * w[:, None] * torch.einsum("dki,d->ki", jx, y)
    ot = -stiffness * torch.einsum("kij,dkj,d->ki", inv_iw, jt, y)
    return corr_x, ot


def rowwise(solve, args, row_dims):
    """``solve`` of one constraint mapped over the rows of ``args``
    (``torch.func.vmap`` over the flattened rows). ``row_dims[i]`` is the
    number of trailing axes of ``args[i]`` that belong to one row; the axes
    before them (constraints, and rollouts) broadcast together. Returns
    ``solve``'s outputs with those leading axes in front."""
    from torch.func import vmap

    lead = torch.broadcast_shapes(*(a.shape[:a.dim() - r]
                                    for a, r in zip(args, row_dims)))
    flat = [a.expand(*lead, *a.shape[a.dim() - r:]).reshape(
        -1, *a.shape[a.dim() - r:]) for a, r in zip(args, row_dims)]
    out = vmap(solve)(*flat)
    if isinstance(out, tuple):
        return tuple(o.reshape(*lead, *o.shape[1:]) for o in out)
    return out.reshape(*lead, *out.shape[1:])
