"""XPBD (compliance-based) constraint kernels.

Port of the parts of ``positionbaseddynamics_tpu/ops/xpbd.py`` that the
structured tet grid needs: the deformation gradient and the
inversion-safe St. Venant–Kirchhoff energy (``xpbd.py:143-187``). The
JAX functions solve one constraint and are ``vmap``-ed; these take any
leading batch shape instead: points ``(..., 3)``, matrices
``(..., 3, 3)``. The per-constraint solves come with the unstructured
solver (slice 4).
"""
from __future__ import annotations

import torch

from .mathutils import mm3, svd_inversion_handling

Tensor = torch.Tensor


def _deformation_gradient(p0, p1, p2, p3, inv_rest_mat):
    """``F = D_s · D_m⁻¹`` with edge matrix columns ``pᵢ − p3``
    (``PositionBasedDynamics.cpp:958-980``)."""
    ds = torch.stack([p0 - p3, p1 - p3, p2 - p3], dim=-1)
    return mm3(ds, inv_rest_mat)


def green_strain_energy_inversion(p0, p1, p2, p3, inv_rest_mat, rest_volume,
                                  mu, lam_coef):
    """Inversion-safe St. Venant–Kirchhoff energy and first Piola stress:
    SVD with reflection handling, singular values clamped at 0.577
    (``computeGreenStrainAndPiolaStressInversion``,
    ``PositionBasedDynamics.cpp:1034-1106``). Returns ``(energy, sigma,
    F)``."""
    f = _deformation_gradient(p0, p1, p2, p3, inv_rest_mat)
    u, hat_f, vt = svd_inversion_handling(f)
    hat_f = torch.clamp_min(hat_f, 0.577)

    eps_hat = 0.5 * (hat_f * hat_f - 1.0)
    trace = (eps_hat[..., 0] + eps_hat[..., 1]) + eps_hat[..., 2]
    sigma_vec = hat_f * (2.0 * mu * eps_hat + lam_coef * trace[..., None])

    # u @ diag(d) scales u's columns
    sigma = mm3(u * sigma_vec[..., None, :], vt)
    eps_m = mm3(u * eps_hat[..., None, :], vt)
    sq = (eps_m * eps_m).reshape(*eps_m.shape[:-2], 9)
    total = sq[..., 0]
    for i in range(1, 9):
        total = total + sq[..., i]
    psi = mu * total + 0.5 * lam_coef * trace * trace
    return rest_volume * psi, sigma, f
