"""Rigid-body joint and contact kernels.

Port of ``positionbaseddynamics_tpu/ops/rigidbody.py``, after
``PositionBasedDynamics/PositionBasedRigidBodyDynamics.{h,cpp}``. Every
joint is written in one masked-row form so that one batched 6×6 solve
covers all of them: a joint has up to 6 rows; row i gives body b a linear
direction ``L_b[i]`` and an angular direction ``A_b[i]`` (Jacobian row
``[L_b | A_b]``), and

    K    = Σ_b w_b L_b L_bᵀ + A_b I_b⁻¹ A_bᵀ       (6×6, masked)
    Δλ   = K⁻¹ · (−(C + α λ))
    Δx_b = w_b L_bᵀ Δλ,   Δω̂_b = I_b⁻¹ A_bᵀ Δλ,   Δq_b = ½ (0, Δω̂_b) ⊗ q_b.

The JAX functions solve one joint or contact and are ``vmap``-ed; these
take any leading shape (``(C,)`` joints, or ``(K, C)`` for K rollouts)
and keep the JAX function's arithmetic order. Inactive rows are masked;
a degenerate system gives zero corrections.

The 6×6 solve is ``torch.linalg.solve_ex(..., check_errors=False)``: LU
with partial pivoting as ``jnp.linalg.solve``, batched over every joint in
one library call, and without the host-side singularity check of
``torch.linalg.solve``, which would wait for the card once a call. JAX
also solves it outside any Pallas kernel (``rigidbody.py:164``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import quaternion as quat
from .mathutils import cross, cross_product_matrix, dot3

Tensor = torch.Tensor

NUM_ROWS = 6


@functools.lru_cache(maxsize=None)
def _eye(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The ``n×n`` identity on ``device``, made once."""
    return torch.eye(n, dtype=dtype, device=device)


def _t(m: Tensor) -> Tensor:
    return m.transpose(-1, -2)


def _mv(m: Tensor, v: Tensor) -> Tensor:
    """``m @ v`` over the leading axes."""
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def _signed_table(rows, width: int) -> np.ndarray:
    """``(4, len(rows) · width)``: ``q @ table`` lays out the matrix whose
    row-major entry k is ``factor · q[index]`` for ``rows[k] = (index,
    factor)`` (one signed component an entry, so the product is exact)."""
    t = np.zeros((4, len(rows)), np.float32)
    for k, (i, f) in enumerate(rows):
        t[i, k] = f
    return t


# entry k of each matrix as (component of q, factor); w, x, y, z = 0..3
_Q = [(0, 1), (1, -1), (2, -1), (3, -1), (1, 1), (0, 1), (3, -1), (2, 1),
      (2, 1), (3, 1), (0, 1), (1, -1), (3, 1), (2, -1), (1, 1), (0, 1)]
_QHAT = [(0, 1), (1, -1), (2, -1), (3, -1), (1, 1), (0, 1), (3, 1), (2, -1),
         (2, 1), (3, -1), (0, 1), (1, 1), (3, 1), (2, 1), (1, -1), (0, 1)]
_G = [(1, -0.5), (2, -0.5), (3, -0.5), (0, 0.5), (3, 0.5), (2, -0.5),
      (3, -0.5), (0, 0.5), (1, 0.5), (2, 0.5), (1, -0.5), (0, 0.5)]


@functools.lru_cache(maxsize=None)
def _quat_tables(device: torch.device, dtype: torch.dtype):
    return {name: torch.tensor(_signed_table(rows, 4), dtype=dtype,
                               device=device)
            for name, rows in (("q", _Q), ("qhat", _QHAT), ("g", _G))}


def quat_mat_q(q: Tensor) -> Tensor:
    """Left multiplication: ``Q(a) · vec4(b) = vec4(a ⊗ b)``
    (``computeMatrixQ``, ``PositionBasedRigidBodyDynamics.cpp:111-157``)."""
    return torch.matmul(q, _quat_tables(q.device, q.dtype)["q"]).unflatten(
        -1, (4, 4))


def quat_mat_qhat(q: Tensor) -> Tensor:
    """Right multiplication: ``Q̂(b) · vec4(a) = vec4(a ⊗ b)``
    (``computeMatrixQHat``, ``PositionBasedRigidBodyDynamics.cpp:135-156``)."""
    return torch.matmul(q, _quat_tables(q.device, q.dtype)["qhat"]
                        ).unflatten(-1, (4, 4))


def quat_mat_g(q: Tensor) -> Tensor:
    """4×3 map ``G(q) · ω = vec4(½ (0, ω) ⊗ q)`` (``computeMatrixG``,
    ``PositionBasedRigidBodyDynamics.cpp:92-109``)."""
    return torch.matmul(q, _quat_tables(q.device, q.dtype)["g"]).unflatten(
        -1, (4, 3))


def rotation_correction(ot: Tensor, q: Tensor) -> Tensor:
    """Quaternion increment ``Δq = ½ (0, ot) ⊗ q`` of an angular term (the
    ``corr_q.coeffs() = 0.5*(otQ*q)`` of every reference joint solve)."""
    return 0.5 * quat.multiply(quat.from_vec(ot), q)


def pos_row(d: Tensor, r0: Tensor, r1: Tensor):
    """Positional row of direction ``d`` acting at connectors with arms
    ``r_b = c_b − x_b``: ``(d, r0 × d, −d, −(r1 × d))`` (ball joint,
    ``PositionBasedRigidBodyDynamics.cpp:233-239``)."""
    return (d, cross(r0, d), -d, -cross(r1, d))


def pos_row_com(d: Tensor):
    """Positional row at the centres of mass, ``J = (P 0)`` (slider, damper,
    motor slider; ``PositionBasedRigidBodyDynamics.cpp:1100-1135``)."""
    z = torch.zeros_like(d)
    return d, z, -d, z


def rot_row(t: Tensor):
    """Pure rotational row ``J = (0, ±t)``."""
    z = torch.zeros_like(t)
    return z, t, z, -t


def rotational_rows(pr: Tensor, q0: Tensor, q1: Tensor):
    """Rotational values and directions from a projection ``Pr (..., p,
    4)``: ``C = Pr · vec4(q̄0 ⊗ q1)`` and ``t = −Pr (Q(q0)ᵀ G(q1))`` (hinge,
    slider, ``PositionBasedRigidBodyDynamics.cpp:694-706, 1085-1097``).
    Returns ``(c (..., p), t (..., p, 3))``."""
    c, p = _rotational_terms(pr, q0, q1)
    return c, -p


def _rotational_terms(pr: Tensor, q0: Tensor, q1: Tensor):
    """``(C, P)`` with ``P = Pr (Q(q0)ᵀ G(q1))``, so ``t = −P``."""
    rel = quat.multiply(quat.conjugate(q0), q1)
    return (_mv(pr, rel),
            torch.matmul(pr, torch.matmul(_t(quat_mat_q(q0)), quat_mat_g(q1))))


def solve_rows(c, l0, a0, l1, a1, w0, iw0, w1, iw1, alpha, lam_rows,
               active, k_a0=None, k_a1=None, masks=None):
    """The masked-row joint solve (``rigidbody.py:131-172``).

    ``c (..., 6)`` values, ``l*/a* (..., 6, 3)`` row directions, ``w*
    (...)`` inverse masses, ``iw* (..., 3, 3)`` world inverse inertias
    (zero for static bodies), ``alpha (..., 6)`` compliances,
    ``lam_rows (..., 6)`` multipliers, ``active (..., 6)`` bool row mask;
    ``k_a0 / k_a1`` override the angular rows of the K assembly only (the
    reference's velocity motor slider,
    ``PositionBasedRigidBodyDynamics.cpp:1380-1460``). Inactive rows become
    identity rows, and ``K`` gains ``1e-9·I``; ``masks``, when given, is
    ``(m, m mᵀ, diag(1 − m) + 1e-9·I)`` of ``active`` made once (the
    joints' constant masks). Returns ``(dlam (..., 6),
    dx0, ot0, dx1, ot1)``, ``ot_b`` the angular term for
    :func:`rotation_correction` (position level) or the ω correction
    (velocity level)."""
    ka0 = a0 if k_a0 is None else k_a0
    ka1 = a1 if k_a1 is None else k_a1
    w0m = w0[..., None, None]
    w1m = w1[..., None, None]
    k = (w0m * torch.matmul(l0, _t(l0))
         + torch.matmul(torch.matmul(ka0, iw0), _t(ka0))
         + w1m * torch.matmul(l1, _t(l1))
         + torch.matmul(torch.matmul(ka1, iw1), _t(ka1)))
    if alpha is not None:
        k = k + torch.diag_embed(alpha.expand(c.shape))
    if masks is None:
        m = active.to(c.dtype)
        mm = m[..., :, None] * m[..., None, :]
        k = (k * mm + torch.diag_embed(1.0 - m)
             + 1e-9 * _eye(NUM_ROWS, c.device, c.dtype))
    else:
        m, mm, d = masks
        k = k * mm + d
    rhs = -(c if alpha is None else c + alpha * lam_rows) * m
    dlam = torch.linalg.solve_ex(k, rhs.unsqueeze(-1),
                                 check_errors=False)[0].squeeze(-1)
    dx0 = w0[..., None] * _mv(_t(l0), dlam)
    ot0 = _mv(iw0, _mv(_t(a0), dlam))
    dx1 = w1[..., None] * _mv(_t(l1), dlam)
    ot1 = _mv(iw1, _mv(_t(a1), dlam))
    return dlam, dx0, ot0, dx1, ot1


# ---------------------------------------------------------------------------
# Contacts (velocity level); slice 6b's pipeline calls them
# ---------------------------------------------------------------------------


def compute_matrix_k(connector, inv_mass, x, inv_inertia_w):
    """``K = w·I − r̃ J⁻¹ r̃`` with ``r = connector − x`` (``computeMatrixK``,
    ``PositionBasedRigidBodyDynamics.cpp:11-44``); ``inv_inertia_w`` zero
    for static bodies."""
    r = cross_product_matrix(connector - x)
    eye = _eye(3, connector.device, connector.dtype)
    w = inv_mass[..., None, None] if isinstance(inv_mass, Tensor) \
        else inv_mass
    return w * eye - torch.matmul(torch.matmul(r, inv_inertia_w), r)


def _tangent_terms(u_rel, normal, k):
    """The tangent, ``1/(nᵀKn)`` and the tangential impulse cap of a
    contact (``rigidbody.py:196-208``)."""
    u_rel_n = dot3(normal, u_rel)
    t = u_rel - u_rel_n[..., None] * normal
    tl2 = dot3(t, t)
    t = torch.where((tl2 > 1e-6)[..., None],
                    t * torch.rsqrt(torch.clamp_min(tl2, 1e-12))[..., None],
                    t)
    nkn = dot3(normal, _mv(k, normal))
    big = torch.abs(nkn) > 1e-12
    nkn_inv = torch.where(big, 1.0 / torch.clamp_min(torch.abs(nkn), 1e-12),
                          torch.zeros_like(nkn))
    tkt = dot3(t, _mv(k, t))
    tbig = torch.abs(tkt) > 1e-12
    p_max = torch.where(
        tbig, dot3(u_rel, t) / torch.where(tbig, tkt, torch.ones_like(tkt)),
        torch.zeros_like(tkt))
    return u_rel_n, t, nkn_inv, p_max


def init_rigid_contact(w0, x0, v0, iw0, omega0, w1, x1, v1, iw1, omega1,
                       cp0, cp1, normal, restitution):
    """Contact set-up (``init_RigidBodyContactConstraint``,
    ``PositionBasedRigidBodyDynamics.cpp:2219-2283``). Returns ``(tangent,
    nkn_inv, p_max, goal_u_rel_n)``."""
    r0 = cp0 - x0
    r1 = cp1 - x1
    u_rel = ((v0 + cross(omega0, r0))
             - (v1 + cross(omega1, r1)))
    k = (compute_matrix_k(cp0, w0, x0, iw0)
         + compute_matrix_k(cp1, w1, x1, iw1))
    u_rel_n, t, nkn_inv, p_max = _tangent_terms(u_rel, normal, k)
    goal = torch.where(u_rel_n < 0.0, -restitution * u_rel_n,
                       torch.zeros_like(u_rel_n))
    return t, nkn_inv, p_max, goal


def _impulse(d, u_rel_n, normal, tangent, nkn_inv, p_max, goal_u_rel_n,
             stiffness, friction, sum_impulses):
    """The contact impulse ``p`` and the new impulse sum: toward the goal
    velocity, the sum kept non-negative, a penalty against penetration,
    and the Coulomb clamp ``|p_t| ≤ μ p_n`` (``rigidbody.py:234-245``)."""
    mag = nkn_inv * (goal_u_rel_n - u_rel_n)
    mag = torch.maximum(mag, -sum_impulses)
    mag = mag - torch.where(d < 0.0, stiffness * nkn_inv * d,
                            torch.zeros_like(d))
    p = mag[..., None] * normal
    new_sum = sum_impulses + mag
    pn = dot3(p, normal)
    p = p - torch.clamp(friction * pn, -p_max, p_max)[..., None] * tangent
    return p, new_sum


def velocity_solve_rigid_contact(w0, x0, v0, iw0, omega0, w1, x1, v1, iw1,
                                 omega1, cp0, cp1, normal, tangent, nkn_inv,
                                 p_max, goal_u_rel_n, stiffness, friction,
                                 sum_impulses):
    """One rigid–rigid contact impulse
    (``velocitySolve_RigidBodyContactConstraint``,
    ``PositionBasedRigidBodyDynamics.cpp:2286-2382``). Returns ``(dv0,
    domega0, dv1, domega1, new_sum_impulses)``."""
    d = dot3(normal, cp0 - cp1)
    r0 = cp0 - x0
    r1 = cp1 - x1
    u_rel = ((v0 + cross(omega0, r0))
             - (v1 + cross(omega1, r1)))
    u_rel_n = dot3(u_rel, normal)
    p, new_sum = _impulse(d, u_rel_n, normal, tangent, nkn_inv, p_max,
                          goal_u_rel_n, stiffness, friction, sum_impulses)
    dv0 = w0[..., None] * p
    domega0 = _mv(iw0, cross(r0, p))
    dv1 = -w1[..., None] * p
    domega1 = _mv(iw1, cross(r1, -p))
    return dv0, domega0, dv1, domega1, new_sum


def init_particle_rigid_contact(w0, x0, v0, w1, x1, v1, iw1, omega1, cp0,
                                cp1, normal, restitution):
    """Particle–rigid contact set-up, body 0 a point mass
    (``init_ParticleRigidBodyContactConstraint``,
    ``PositionBasedRigidBodyDynamics.cpp:2385-2448``)."""
    r1 = cp1 - x1
    u_rel = v0 - (v1 + cross(omega1, r1))
    eye = _eye(3, x0.device, x0.dtype)
    k = compute_matrix_k(cp1, w1, x1, iw1) + w0[..., None, None] * eye
    u_rel_n, t, nkn_inv, p_max = _tangent_terms(u_rel, normal, k)
    goal = torch.where(u_rel_n < 0.0, -restitution * u_rel_n,
                       torch.zeros_like(u_rel_n))
    return t, nkn_inv, p_max, goal


def velocity_solve_particle_rigid_contact(w0, v0, w1, x1, v1, iw1, omega1,
                                          cp0, cp1, normal, tangent,
                                          nkn_inv, p_max, goal_u_rel_n,
                                          stiffness, friction,
                                          sum_impulses):
    """One particle–rigid contact impulse
    (``velocitySolve_ParticleRigidBodyContactConstraint``,
    ``PositionBasedRigidBodyDynamics.cpp:2451-2539``). Returns ``(dv0,
    dv1, domega1, new_sum_impulses)``."""
    d = dot3(normal, cp0 - cp1)
    r1 = cp1 - x1
    u_rel = v0 - (v1 + cross(omega1, r1))
    u_rel_n = dot3(u_rel, normal)
    p, new_sum = _impulse(d, u_rel_n, normal, tangent, nkn_inv, p_max,
                          goal_u_rel_n, stiffness, friction, sum_impulses)
    dv0 = w0[..., None] * p
    dv1 = -w1[..., None] * p
    domega1 = _mv(iw1, cross(r1, -p))
    return dv0, dv1, domega1, new_sum
