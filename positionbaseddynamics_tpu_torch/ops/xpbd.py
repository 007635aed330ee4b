"""XPBD (compliance-based) constraint kernels.

Port of ``positionbaseddynamics_tpu/ops/xpbd.py``. The common XPBD update
is ``α = 1/(k dt²)`` (α = 0 when k == 0), ``Δλ = −(C + αλ)/(Σ wᵢ‖∇ᵢC‖² +
α)``, ``Δxᵢ = Δλ wᵢ ∇ᵢC``; the reference's early-outs are ``torch.where``
masks that leave λ unchanged and give zero corrections. The JAX functions
solve one constraint and are ``vmap``-ed; these take any leading batch
shape instead: points ``(..., 3)``, weights, parameters and λ ``(...)``,
matrices ``(..., 3, 3)``. Each solve returns ``(corr (..., k, 3),
new_lam)``.
"""
from __future__ import annotations

import torch

from .mathutils import (EPS, cot_theta, cross3, dot3, mm3, mm3_nt, mm3_tn,
                        norm3, safe_inv, sqrt_rn, svd_inversion_handling)
from .pbd import (_grad_norm, _internal, _stencil_order, _v,
                  _volume_gradients, _weighted_sq, _zero, isometric_terms)

Tensor = torch.Tensor


def compliance(stiffness, dt):
    """``α = 1/(k dt²)``, with ``k == 0`` meaning infinitely stiff
    (α = 0), as ``XPBD.cpp:37-42``."""
    return torch.where(stiffness != 0.0, safe_inv(stiffness * dt * dt),
                       _zero(stiffness))


def solve_distance(p0, w0, p1, w1, rest_length, stiffness, dt, lam):
    """``C = ‖p0 − p1‖ − L₀`` (``XPBD.cpp:14-60``, ``xpbd.py:34-56``).
    Returns ``(corr (..., 2, 3), new_lam)``."""
    n = p0 - p1
    d = norm3(n)
    valid = d > 1e-6
    n = n * _v(safe_inv(torch.clamp_min(d, 1e-6)))
    c = d - rest_length
    alpha = compliance(stiffness, dt)
    k = w0 + w1 + alpha
    valid = valid & (torch.abs(k) > 1e-6)
    dlam = torch.where(valid, -(c + alpha * lam) * safe_inv(k), _zero(k))
    pt = n * _v(dlam)
    return torch.stack([_v(w0) * pt, _v(-w1) * pt], dim=-2), lam + dlam


def solve_volume(p0, w0, p1, w1, p2, w2, p3, w3, rest_volume, stiffness,
                 dt, lam):
    """``C = V − V₀`` (``XPBD.cpp:63-109``, ``xpbd.py:59-87``). Returns
    ``(corr (..., 4, 3), new_lam)``."""
    volume, grads = _volume_gradients(p0, p1, p2, p3)
    ws = [w0, w1, w2, w3]
    alpha = compliance(stiffness, dt)
    k = _weighted_sq(ws, grads) + alpha
    dlam = torch.where(torch.abs(k) >= EPS,
                       -((volume - rest_volume) + alpha * lam) * safe_inv(k),
                       _zero(k))
    corr = _v(dlam)[..., None, :] * torch.stack(
        [_v(w) * g for w, g in zip(ws, grads)], dim=-2)
    return corr, lam + dlam


def init_isometric_bending(p0, p1, p2, p3):
    """The 4×4 quadratic-bending matrix Q of the stencil (p0, p1) flap
    vertices, (p2, p3) shared edge, in the internal order ``[p2, p3, p0,
    p1]`` (``XPBD.cpp:112-150``, ``xpbd.py:90-117``). Returns
    ``(..., 4, 4)``."""
    x0, x1, x2, x3 = p2, p3, p0, p1
    e0, e1, e2 = x1 - x0, x2 - x0, x3 - x0
    e3, e4 = x2 - x1, x3 - x1
    c01, c02 = cot_theta(e0, e1), cot_theta(e0, e2)
    c03, c04 = cot_theta(-e0, e3), cot_theta(-e0, e4)
    a0 = 0.5 * norm3(cross3(e0, e1))
    a1 = 0.5 * norm3(cross3(e0, e2))
    coef = -3.0 / (2.0 * (a0 + a1))
    k = torch.stack([c03 + c04, c01 + c02, -c01 - c03, -c02 - c04], dim=-1)
    return coef[..., None, None] * (k[..., :, None] * k[..., None, :])


def solve_isometric_bending(p0, w0, p1, w1, p2, w2, p3, w3, q_mat,
                            stiffness, dt, lam):
    """XPBD isometric bending, energy ``½ xᵀQx`` over ``x = [p2, p3, p0,
    p1]`` (``XPBD.cpp:153-213``, ``xpbd.py:120-146``). Returns ``(corr
    (..., 4, 3) in (p0, p1, p2, p3) order, new_lam)``."""
    xs, ws = _internal(p0, p1, p2, p3, w0, w1, w2, w3)
    energy, grad = isometric_terms(q_mat, xs)
    alpha = compliance(stiffness, dt)
    sum_norm = _grad_norm(ws, grad) + alpha
    dlam = torch.where(torch.abs(sum_norm) > EPS,
                       -(energy + alpha * lam) * safe_inv(sum_norm),
                       _zero(sum_norm))
    ci = (dlam[..., None] * ws)[..., None] * grad
    return _stencil_order(ci), lam + dlam


def _deformation_gradient(p0, p1, p2, p3, inv_rest_mat):
    """``F = D_s · D_m⁻¹`` with edge matrix columns ``pᵢ − p3``
    (``PositionBasedDynamics.cpp:958-980``)."""
    ds = torch.stack([p0 - p3, p1 - p3, p2 - p3], dim=-1)
    return mm3(ds, inv_rest_mat)


def _sum9(m: Tensor) -> Tensor:
    """Sum of the nine entries of ``(..., 3, 3)``, in row-major order."""
    sq = m.reshape(*m.shape[:-2], 9)
    total = sq[..., 0]
    for i in range(1, 9):
        total = total + sq[..., i]
    return total


def green_strain_energy(p0, p1, p2, p3, inv_rest_mat, rest_volume, mu,
                        lam_coef):
    """St. Venant–Kirchhoff energy and first Piola stress: ``ε = ½(FᵀF −
    I)``, ``P = F(2με + λ tr(ε) I)``, ``Ψ = μ‖ε‖² + ½λ tr(ε)²``, ``E =
    V₀Ψ`` (``PositionBasedDynamics.cpp:958-1008``, ``xpbd.py:157-173``).
    Returns ``(energy, sigma, F)``."""
    f = _deformation_gradient(p0, p1, p2, p3, inv_rest_mat)
    eye = torch.eye(3, dtype=f.dtype, device=f.device)
    eps_m = 0.5 * (mm3_tn(f, f) - eye)
    trace = (eps_m[..., 0, 0] + eps_m[..., 1, 1]) + eps_m[..., 2, 2]
    sigma = mm3(f, _v(2.0 * mu)[..., None] * eps_m
                + _v(lam_coef * trace)[..., None] * eye)
    psi = mu * _sum9(eps_m * eps_m) + 0.5 * lam_coef * trace * trace
    return rest_volume * psi, sigma, f


def green_strain_energy_inversion(p0, p1, p2, p3, inv_rest_mat, rest_volume,
                                  mu, lam_coef):
    """Inversion-safe St. Venant–Kirchhoff energy and first Piola stress:
    signed SVD, singular values clamped at 0.577
    (``PositionBasedDynamics.cpp:1034-1106``, ``xpbd.py:176-195``).
    Returns ``(energy, sigma, F)``."""
    f = _deformation_gradient(p0, p1, p2, p3, inv_rest_mat)
    u, hat_f, vt = svd_inversion_handling(f)
    hat_f = torch.clamp_min(hat_f, 0.577)

    eps_hat = 0.5 * (hat_f * hat_f - 1.0)
    trace = (eps_hat[..., 0] + eps_hat[..., 1]) + eps_hat[..., 2]
    sigma_vec = hat_f * (_v(2.0 * mu) * eps_hat + _v(lam_coef * trace))

    # u @ diag(d) scales u's columns
    sigma = mm3(u * sigma_vec[..., None, :], vt)
    eps_m = mm3(u * eps_hat[..., None, :], vt)
    psi = mu * _sum9(eps_m * eps_m) + 0.5 * lam_coef * trace * trace
    return rest_volume * psi, sigma, f


def select_energy(p0, p1, p2, p3, inv_rest_mat, rest_volume, mu, lam_coef,
                  handle_inversion=True):
    """The FEM tet's energy and stress: with ``handle_inversion`` both
    forms are computed and a tet of volume ≤ 0 takes the inversion-safe
    one (``xpbd.py:222-231``). Returns ``(energy, sigma)``."""
    u_reg, sig_reg, _ = green_strain_energy(p0, p1, p2, p3, inv_rest_mat,
                                            rest_volume, mu, lam_coef)
    if not handle_inversion:
        return u_reg, sig_reg
    u_inv, sig_inv, _ = green_strain_energy_inversion(
        p0, p1, p2, p3, inv_rest_mat, rest_volume, mu, lam_coef)
    inverted = dot3(cross3(p1 - p0, p2 - p0), p3 - p0) / 6.0 <= 0.0
    return (torch.where(inverted, u_inv, u_reg),
            torch.where(inverted[..., None, None], sig_inv, sig_reg))


def grad_c_green(rest_volume, inv_rest_mat, sigma):
    """The energy's gradient at the four vertices: ``H = V₀ σ D_m⁻ᵀ``,
    rows ∇₀..∇₂ the columns of H and ``∇₃ = −Σ∇ᵢ``
    (``PositionBasedDynamics.cpp:1011-1031``, ``xpbd.py:198-208``).
    Returns ``(..., 4, 3)``."""
    g012 = (mm3_nt(sigma, inv_rest_mat)
            * rest_volume[..., None, None]).transpose(-1, -2)
    g3 = -((g012[..., 0, :] + g012[..., 1, :]) + g012[..., 2, :])
    return torch.cat([g012, g3[..., None, :]], dim=-2)


def solve_fem_tetra(p0, w0, p1, w1, p2, w2, p3, w3, rest_volume,
                    inv_rest_mat, youngs_modulus, poisson_ratio, dt, lam,
                    handle_inversion: bool = True):
    """XPBD FEM tet ``C = √(2U′)``, ``U′ = U/E``, compliance ``α = 1/(E
    dt²)``, with the reference's factor-C bookkeeping ``Δλ = −C(C + αλ)/(Σ
    w‖∇U′‖² + C²α)`` (``XPBD.cpp:217-294``, ``xpbd.py:211-247``). Returns
    ``(corr (..., 4, 3), new_lam)``."""
    mu = 0.5 / (1.0 + poisson_ratio)
    lame = poisson_ratio / ((1.0 + poisson_ratio)
                            * (1.0 - 2.0 * poisson_ratio))
    u_prime, sigma = select_energy(p0, p1, p2, p3, inv_rest_mat,
                                   rest_volume, mu, lame, handle_inversion)
    grad_u = grad_c_green(rest_volume, inv_rest_mat, sigma)
    c = sqrt_rn(torch.clamp_min(2.0 * u_prime, 0.0))
    ws = torch.stack([w0, w1, w2, w3], dim=-1)
    alpha = safe_inv(youngs_modulus * dt * dt)
    sum_norm = _grad_norm(ws, grad_u) + c * c * alpha
    valid = (sum_norm >= EPS) & (youngs_modulus > 0.0)
    dlam = torch.where(valid, -c * (c + alpha * lam) * safe_inv(sum_norm),
                       _zero(sum_norm))
    return (dlam[..., None] * ws)[..., None] * grad_u, lam + dlam
