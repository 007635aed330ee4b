"""Small dense-math helpers shared by the constraint solvers.

Port of the parts of ``positionbaseddynamics_tpu/ops/mathutils.py`` that
the tet-grid slice needs: the degeneracy threshold, the guarded
reciprocal, the unrolled 3×3 products and determinant, and the signed SVD
with inversion handling in its LAPACK form (the form the JAX package
runs on the CPU). The Jacobi-eigendecomposition form of the SVD comes
with the unstructured solver (slice 4).

Matrices are ``(..., 3, 3)`` tensors; every function broadcasts over the
leading axes.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

#: Generic degeneracy threshold of the reference kernels (``XPBD.cpp:8``).
EPS = 1e-6


def safe_inv(x: Tensor, eps: float = 1e-30) -> Tensor:
    """``1/x`` where ``|x| > eps``, else 0 (``mathutils.py:20-23``)."""
    big = torch.abs(x) > eps
    return torch.where(big, 1.0 / torch.where(big, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def _sum3(terms):
    """``t0 + t1 + t2`` left to right, as the JAX package's Python ``sum``
    adds them."""
    a, b, c = terms
    return (a + b) + c


def mm3(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` for 3×3 matrices as unrolled multiply-adds."""
    return torch.stack([torch.stack(
        [_sum3([a[..., i, k] * b[..., k, j] for k in range(3)])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)


def mm3_tn(a: Tensor, b: Tensor) -> Tensor:
    """``aᵀ @ b`` unrolled (see :func:`mm3`)."""
    return torch.stack([torch.stack(
        [_sum3([a[..., k, i] * b[..., k, j] for k in range(3)])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)


def mm3_nt(a: Tensor, b: Tensor) -> Tensor:
    """``a @ bᵀ`` unrolled (see :func:`mm3`)."""
    return torch.stack([torch.stack(
        [_sum3([a[..., i, k] * b[..., j, k] for k in range(3)])
         for j in range(3)], dim=-1) for i in range(3)], dim=-2)


def det3(a: Tensor) -> Tensor:
    """Explicit 3×3 determinant by cofactors of the first row."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def svd_inversion_handling(a: Tensor):
    """Signed SVD ``A = U diag(σ) Vᵀ`` with ``U, V ∈ SO(3)``: a reflection
    in U or V becomes a rotation by negating its third column (row of Vᵀ)
    and the smallest singular value with it — the semantics of
    ``MathFunctions::svdWithInversionHandling``, in the LAPACK form of
    ``mathutils.py:177-187``. Returns ``(U, sigma, VT)``."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    su = torch.where(torch.linalg.det(u) < 0.0, -one, one)
    sv = torch.where(torch.linalg.det(vt) < 0.0, -one, one)
    u = torch.cat([u[..., :2], u[..., 2:] * su[..., None, None]], dim=-1)
    vt = torch.cat([vt[..., :2, :], vt[..., 2:, :] * sv[..., None, None]],
                   dim=-2)
    s = torch.cat([s[..., :2], s[..., 2:] * (su * sv)[..., None]], dim=-1)
    return u, s, vt
