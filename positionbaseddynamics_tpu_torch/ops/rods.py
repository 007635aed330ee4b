"""Cosserat rod constraint solves (positions and orientation quaternions).

Port of ``positionbaseddynamics_tpu/ops/rods.py``, after
``PositionBasedCosseratRods`` (``PositionBasedElasticRods.cpp:20-81``,
Kugelstadt & Schömer 2016): stretch-shear couples two particles and one
orientation quaternion; bend-twist couples two neighbouring quaternions
through the discrete Darboux vector. The JAX functions solve one
constraint and are ``vmap``-ed; these take any leading shape (``(C,)``
constraints, or ``(K, C)`` for K rollouts) and keep the JAX function's
arithmetic. Quaternions are ``[w, x, y, z]``.
"""
from __future__ import annotations

import torch

from . import quaternion as quat
from .mathutils import EPS

Tensor = torch.Tensor


def solve_stretch_shear(p0, w0, p1, w1, q0, wq0, stretch_ks, rest_length):
    """Stretch-shear constraint ``C = (p1 − p0)/L − d3(q0)``
    (``rods.py:22-54``): γ scaled by ``(w0 + w1)/L + 4 wq0 L + ε``, the
    per-axis stiffness applied in the material frame, and the quaternion
    correction ``2 wq0 L · (0, γ) ⊗ (q0 ⊗ ē3)``. Points ``(..., 3)``,
    weights and ``rest_length`` ``(...)``, ``q0 (..., 4)``, ``stretch_ks
    (..., 3)``. Returns ``(corr0, corr1, corrq0)``, the last an additive
    (unnormalised) quaternion update."""
    d3 = quat.third_director(q0)
    length = rest_length[..., None]
    gamma = (p1 - p0) / length - d3
    gamma = gamma / ((w1 + w0) / rest_length + wq0 * 4.0 * rest_length
                     + EPS)[..., None]
    r = quat.to_matrix(q0)
    local = torch.matmul(r.transpose(-1, -2), gamma.unsqueeze(-1))
    gamma = torch.matmul(r, stretch_ks.unsqueeze(-1) * local).squeeze(-1)
    corr0 = w0[..., None] * gamma
    corr1 = -w1[..., None] * gamma
    # q0 ⊗ ē3 = [qz, −qy, qx, −qw]
    q_e3_bar = torch.stack([q0[..., 3], -q0[..., 2], q0[..., 1],
                            -q0[..., 0]], dim=-1)
    corrq0 = quat.multiply(quat.from_vec(gamma), q_e3_bar)
    corrq0 = corrq0 * (2.0 * wq0 * rest_length)[..., None]
    return corr0, corr1, corrq0


def solve_bend_twist(q0, wq0, q1, wq1, bend_ks, rest_darboux):
    """Bend-twist constraint on ``Ω = q̄0 ⊗ q1`` (``rods.py:57-80``): the
    double-cover pick of ``Ω − Ω₀`` or ``Ω + Ω₀``, whichever is smaller,
    the stiffness over ``wq0 + wq1 + 1e-6`` and the scalar part zeroed.
    Returns ``(corrq0, corrq1)``, additive quaternion updates."""
    omega = quat.multiply(quat.conjugate(q0), q1)
    minus = omega - rest_darboux
    plus = omega + rest_darboux
    use_plus = (torch.sum(minus * minus, dim=-1)
                > torch.sum(plus * plus, dim=-1))
    delta = torch.where(use_plus[..., None], plus, minus)
    scale = bend_ks / (wq0 + wq1 + 1e-6)[..., None]
    delta = torch.cat([torch.zeros_like(delta[..., :1]),
                       delta[..., 1:4] * scale], dim=-1)
    corrq0 = wq0[..., None] * quat.multiply(q1, delta)
    corrq1 = -wq1[..., None] * quat.multiply(q0, delta)
    return corrq0, corrq1


def rest_darboux(q0: Tensor, q1: Tensor) -> Tensor:
    """Rest Darboux quaternion of two neighbouring frames, ``q̄0 ⊗ q1``."""
    return quat.multiply(quat.conjugate(q0), q1)
