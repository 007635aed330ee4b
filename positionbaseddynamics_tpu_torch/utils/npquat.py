"""Host-side (numpy, float64) quaternion helpers for scene building.

The port's own copy of ``positionbaseddynamics_tpu/utils/npquat.py``
(numpy only, so the port imports nothing of the JAX package); build-time
results equal the JAX package's exactly. Layout ``[w, x, y, z]`` matching
``ops/quaternion.py``. Used by the scene
builder to precompute local joint frames / rotational projections — the
analogue of the reference's ``init_X`` joint functions
(``PositionBasedDynamics/PositionBasedRigidBodyDynamics.cpp``), which run
once at scene setup.
"""
from __future__ import annotations

import numpy as np


def multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product on ``(..., 4)`` arrays."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def conjugate(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def normalize(q: np.ndarray) -> np.ndarray:
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-300)


def to_matrix(q: np.ndarray) -> np.ndarray:
    """Rotation matrix ``(..., 3, 3)``, ``R @ v == rotate(q, v)``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = np.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], axis=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def from_matrix(r: np.ndarray) -> np.ndarray:
    """Unit quaternion from a rotation matrix (Shepperd's method,
    branch-per-item; build-time only)."""
    r = np.asarray(r, np.float64)
    single = r.ndim == 2
    rs = r.reshape(-1, 3, 3)
    out = np.empty((rs.shape[0], 4), np.float64)
    for i, m in enumerate(rs):
        tr = np.trace(m)
        if tr > 0.0:
            s = np.sqrt(tr + 1.0) * 2.0
            out[i] = [0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
            out[i] = [(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        elif m[1, 1] > m[2, 2]:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
            out[i] = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
            out[i] = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    out = normalize(out)
    return out[0] if single else out.reshape(r.shape[:-2] + (4,))


def rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qw = q[..., :1]
    qv = q[..., 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def mat_q(q: np.ndarray) -> np.ndarray:
    """Left-multiplication 4×4 (see ``ops.rigidbody.quat_mat_q``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = np.stack([
        w, -x, -y, -z,
        x, w, -z, y,
        y, z, w, -x,
        z, -y, x, w,
    ], axis=-1)
    return rows.reshape(q.shape[:-1] + (4, 4))


def mat_qhat(q: np.ndarray) -> np.ndarray:
    """Right-multiplication 4×4 (see ``ops.rigidbody.quat_mat_qhat``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = np.stack([
        w, -x, -y, -z,
        x, w, z, -y,
        y, -z, w, x,
        z, y, -x, w,
    ], axis=-1)
    return rows.reshape(q.shape[:-1] + (4, 4))


def orthonormal_basis(direction: np.ndarray) -> np.ndarray:
    """3×3 rotation with ``direction`` (normalized) as first column — the
    constraint-frame builder every reference joint init uses
    (``PositionBasedRigidBodyDynamics.cpp:585-600`` pattern: pick
    v=(1,0,0), or (0,1,0) when nearly parallel)."""
    direction = np.asarray(direction, np.float64)
    single = direction.ndim == 1
    d = np.atleast_2d(direction)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-300)
    v = np.tile(np.array([1.0, 0.0, 0.0]), (d.shape[0], 1))
    par = np.abs((v * d).sum(-1)) > 0.99
    v[par] = np.array([0.0, 1.0, 0.0])
    c1 = np.cross(d, v)
    c2 = np.cross(d, c1)
    c1 = c1 / np.maximum(np.linalg.norm(c1, axis=-1, keepdims=True), 1e-300)
    c2 = c2 / np.maximum(np.linalg.norm(c2, axis=-1, keepdims=True), 1e-300)
    r = np.stack([d, c1, c2], axis=-1)  # columns
    return r[0] if single else r


def rotational_projection(q0: np.ndarray, q1: np.ndarray,
                          direction: np.ndarray, rows: int) -> np.ndarray:
    """Precompute the constant rotational projection ``Pr (rows, 4)`` of the
    hinge/slider family: with constraint frame ``R0`` (direction = x-axis),

        q00 = (q̄0 ⊗ qR0)*,  q10 = (q̄1 ⊗ qR0)*,
        Pr  = (Q̂(q10)ᵀ Q(q00))[4-rows: , :]

    matching ``init_HingeJoint`` (rows=2, ``PositionBasedRigidBodyDynamics
    .cpp:610-619``) and ``init_SliderJoint`` / motor variants (rows=3,
    ``:1009-1022``)."""
    r0 = orthonormal_basis(direction)
    qr0 = from_matrix(r0)
    q00 = conjugate(multiply(conjugate(q0), qr0))
    q10 = conjugate(multiply(conjugate(q1), qr0))
    full = mat_qhat(q10).T @ mat_q(q00)
    return full[4 - rows:, :]
