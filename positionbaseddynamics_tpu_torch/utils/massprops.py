"""Exact mass properties of closed triangle meshes.

The port's own copy of ``positionbaseddynamics_tpu/utils/massprops.py``
(numpy only); its results equal the JAX package's exactly.

Equivalent of ``Utils/VolumeIntegration.{h,cpp}`` (Mirtich-style
projection integrals used by ``RigidBody::determineMassProperties``,
``Simulation/RigidBody.h:211-260``) — same quantities, computed instead
by signed-tetrahedron decomposition about the origin: each surface
triangle (a, b, c) spans a signed tet with the origin whose volume /
first / second moments have closed forms, and the divergence theorem sums
them to the exact polyhedral integrals. Vectorized numpy over all faces.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def mass_properties(vertices: np.ndarray, faces: np.ndarray,
                    density: float = 1.0
                    ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Return ``(mass, center_of_mass (3,), inertia (3, 3))`` of the solid
    bounded by the closed mesh, inertia about the center of mass in the
    mesh frame. Faces must be consistently outward-oriented (the same
    requirement ``VolumeIntegration`` has)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    # signed volume of tet (0, a, b, c): det[a b c] / 6
    det = np.einsum("ij,ij->i", a, np.cross(b, c))
    volume = det.sum() / 6.0

    # first moment: ∫ x dV over tet = det/24 · (a + b + c)
    first = (det[:, None] * (a + b + c)).sum(0) / 24.0
    com = first / volume

    # second moment: ∫ x xᵀ dV over tet with J = [a b c] columns equals
    # det/120 · J (1 + I) Jᵀ  (canonical-tet integral ∫ y yᵀ dy = (1+I)/120)
    s = np.ones((3, 3)) + np.eye(3)
    jmat = np.stack([a, b, c], axis=-1)              # (F, 3, 3) columns
    cov = np.einsum("f,fis,st,fjt->ij", det, jmat, s, jmat) / 120.0

    # inertia about origin, then shift to COM (parallel axis)
    inertia_o = np.trace(cov) * np.eye(3) - cov
    m = volume  # unit density
    r = com
    inertia_com = inertia_o - m * ((r @ r) * np.eye(3) - np.outer(r, r))

    rho = float(density)
    return rho * volume, com, rho * inertia_com


def principal_frame(inertia: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Diagonalize a symmetric inertia tensor. Returns
    ``(principal_moments (3,), R (3, 3))`` with ``R`` a proper rotation
    (det = +1) whose columns are the principal axes — the
    ``SelfAdjointEigenSolver`` + det flip of ``determineMassProperties``
    (``RigidBody.h:219-228``)."""
    eigs, rot = np.linalg.eigh(np.asarray(inertia, np.float64))
    if np.linalg.det(rot) < 0.0:
        rot = -rot
    return eigs, rot
