"""Quaternion algebra on ``(..., 4)`` tensors, layout ``[w, x, y, z]``.

Port of ``positionbaseddynamics_tpu/ops/quaternion.py`` (``:22-134``). The
reference stores Eigen quaternions whose ``coeffs()`` are ``[x, y, z, w]``;
this package, like the JAX one, keeps the scalar first. Every function
takes any leading shape, where the JAX functions take it by broadcasting
or ``vmap``.

The joint solver calls these a few hundred times a step, so the Hamilton
product and the rotation matrix are one outer product and one product
with a constant ±1 / ±2 table each (three launches on the card, not
thirty): every output is a signed sum of the JAX formula's products in the
formula's order, and the table's factors are powers of two, which scale
exactly.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .mathutils import cross

Tensor = torch.Tensor


def _hamilton_table() -> np.ndarray:
    """``(16, 4)``: ``vec(a bᵀ) @ table = a ⊗ b`` (row ``4i + j`` holds the
    sign of ``a_i b_j`` in each component)."""
    t = np.zeros((16, 4), np.float32)
    terms = {0: [(0, 0, 1), (1, 1, -1), (2, 2, -1), (3, 3, -1)],
             1: [(0, 1, 1), (1, 0, 1), (2, 3, 1), (3, 2, -1)],
             2: [(0, 2, 1), (1, 3, -1), (2, 0, 1), (3, 1, 1)],
             3: [(0, 3, 1), (1, 2, 1), (2, 1, -1), (3, 0, 1)]}
    for out, ts in terms.items():
        for i, j, sign in ts:
            t[4 * i + j, out] = sign
    return t


def _matrix_table():
    """``(16, 9)`` and ``(9,)``: ``vec(q qᵀ) @ table + offset`` is the
    row-major rotation matrix of a unit ``q`` (``to_matrix``'s entries
    ``1 − 2(yy + zz)``, ``2(xy − wz)``, …)."""
    w, x, y, z = range(4)
    entries = [[(y, y, -2), (z, z, -2)], [(x, y, 2), (w, z, -2)],
               [(x, z, 2), (w, y, 2)],
               [(x, y, 2), (w, z, 2)], [(x, x, -2), (z, z, -2)],
               [(y, z, 2), (w, x, -2)],
               [(x, z, 2), (w, y, -2)], [(y, z, 2), (w, x, 2)],
               [(x, x, -2), (y, y, -2)]]
    t = np.zeros((16, 9), np.float32)
    for k, terms in enumerate(entries):
        for i, j, f in terms:
            t[4 * i + j, k] = f
    return t, np.array([1, 0, 0, 0, 1, 0, 0, 0, 1], np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype):
    """The constant tables on ``device``, made once (a constant copied from
    the host inside a step would make the host wait for the card)."""
    mt, off = _matrix_table()

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return dict(hamilton=t(_hamilton_table()), matrix=t(mt), offset=t(off),
                conj=t(np.array([1, -1, -1, -1], np.float32)))


def _outer16(a: Tensor, b: Tensor) -> Tensor:
    """``vec(a bᵀ)`` of 4-vectors, ``(..., 16)``."""
    return (a[..., :, None] * b[..., None, :]).flatten(-2)


def identity(shape=(), dtype=torch.float32, device=None) -> Tensor:
    """Identity quaternion broadcast to ``shape + (4,)``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product ``a ⊗ b`` (Eigen's ``q1 * q2``)."""
    return torch.matmul(_outer16(a, b),
                        _tables(a.device, a.dtype)["hamilton"])


def conjugate(q: Tensor) -> Tensor:
    """Quaternion conjugate ``[w, -x, -y, -z]``."""
    return q * _tables(q.device, q.dtype)["conj"]


def normalize(q: Tensor, eps: float = 1e-30) -> Tensor:
    """Unit length, as the reference renormalises after integration
    (``TimeIntegration.cpp:37``): ``q · rsqrt(max(|q|², eps))``."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.clamp_min(n2, eps))


def vec(q: Tensor) -> Tensor:
    """Imaginary part ``[x, y, z]`` (Eigen's ``q.vec()``)."""
    return q[..., 1:4]


def from_vec(v: Tensor) -> Tensor:
    """Pure quaternion ``[0, vx, vy, vz]``."""
    return torch.nn.functional.pad(v, (1, 0))


def rotate(q: Tensor, v: Tensor) -> Tensor:
    """``v`` rotated by the unit quaternion ``q``, ``q v q*``, in the
    expanded form ``v + 2 qw (qv × v) + 2 qv × (qv × v)``."""
    qw = q[..., :1]
    qv = q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def rotate_inv(q: Tensor, v: Tensor) -> Tensor:
    """``v`` rotated by the inverse of the unit quaternion ``q``."""
    return rotate(conjugate(q), v)


def to_matrix(q: Tensor) -> Tensor:
    """Rotation matrix ``(..., 3, 3)`` of a unit quaternion, ``R @ v ==
    rotate(q, v)``."""
    t = _tables(q.device, q.dtype)
    r = torch.matmul(_outer16(q, q), t["matrix"]) + t["offset"]
    return r.unflatten(-1, (3, 3))


def from_axis_angle(axis: Tensor, angle: Tensor) -> Tensor:
    """Unit quaternion of a rotation by ``angle`` (radians) about the unit
    ``axis``."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]],
                     dim=-1)


def third_director(q: Tensor) -> Tensor:
    """Third director ``d3 = q e3 q̄`` of a Cosserat frame, in the
    reference's closed form (``PositionBasedElasticRods.cpp:29-32``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        2.0 * (x * z + w * y),
        2.0 * (y * z - w * x),
        w * w - x * x - y * y + z * z,
    ], dim=-1)


def integrate_angular(q: Tensor, omega: Tensor, h) -> Tensor:
    """Explicit quaternion step ``q ← normalize(q + h/2 (0, ω) ⊗ q)``
    (``TimeIntegration::semiImplicitEulerRotation``,
    ``TimeIntegration.cpp:33-37``)."""
    dq = multiply(from_vec(omega), q)
    return normalize(q + 0.5 * h * dq)
