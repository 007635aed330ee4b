"""Classic PBD constraint kernels (stiffness ∈ [0, 1], no Lagrange
multiplier).

Port of ``positionbaseddynamics_tpu/ops/pbd.py`` except
``solve_shape_matching``, which extracts its rotation through quaternions
and comes with the rigid-body slice (6a). The JAX functions solve one
constraint and are ``vmap``-ed; these take any leading batch shape
instead: points ``(..., 3)``, weights and parameters ``(...)``, matrices
``(..., n, n)``. The reference's early-outs are ``torch.where`` masks that
give zero corrections. Each function returns the per-particle corrections
stacked on a new axis before the last, ``(..., k, 3)``.
"""
from __future__ import annotations

import torch

from .mathutils import (EPS, cross3, dot3, norm3, polar_decomposition_stable,
                        safe_inv, sqrt_rn)

Tensor = torch.Tensor


def _v(s):
    """A per-constraint scalar as a factor of a 3-vector (a Python number
    stays as it is)."""
    return s[..., None] if isinstance(s, Tensor) else s


def _zero(like: Tensor) -> Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def solve_distance(p0, w0, p1, w1, rest_length, stiffness):
    """Classic distance constraint (``PositionBasedDynamics.cpp:13-35``,
    ``pbd.py:18-31``). Returns ``corr (..., 2, 3)``."""
    w_sum = w0 + w1
    n = p1 - p0
    d = norm3(n)
    n = n * _v(safe_inv(torch.clamp_min(d, 1e-12)))
    corr = _v(torch.where(w_sum > 0.0,
                          stiffness * (d - rest_length) * safe_inv(w_sum),
                          _zero(d))) * n
    return torch.stack([_v(w0) * corr, _v(-w1) * corr], dim=-2)


def solve_dihedral(p0, w0, p1, w1, p2, w2, p3, w3, rest_angle, stiffness):
    """Dihedral-angle bending over triangles (p0, p2, p3) and (p1, p3, p2)
    with shared edge (p2, p3) (``pbd.py:34-70``). Returns
    ``corr (..., 4, 3)``."""
    e = p3 - p2
    elen = norm3(e)
    inv_elen = safe_inv(torch.clamp_min(elen, EPS))

    n1 = cross3(p2 - p0, p3 - p0)
    n1 = n1 * _v(safe_inv(torch.clamp_min(dot3(n1, n1), 1e-24)))
    n2 = cross3(p3 - p1, p2 - p1)
    n2 = n2 * _v(safe_inv(torch.clamp_min(dot3(n2, n2), 1e-24)))

    d0 = _v(elen) * n1
    d1 = _v(elen) * n2
    d2 = (_v(dot3(p0 - p3, e) * inv_elen) * n1
          + _v(dot3(p1 - p3, e) * inv_elen) * n2)
    d3 = (_v(dot3(p2 - p0, e) * inv_elen) * n1
          + _v(dot3(p2 - p1, e) * inv_elen) * n2)

    n1u = n1 * _v(safe_inv(torch.clamp_min(norm3(n1), 1e-12)))
    n2u = n2 * _v(safe_inv(torch.clamp_min(norm3(n2), 1e-12)))
    phi = torch.arccos(torch.clamp(dot3(n1u, n2u), -1.0, 1.0))

    denom = (((w0 * dot3(d0, d0) + w1 * dot3(d1, d1))
              + w2 * dot3(d2, d2)) + w3 * dot3(d3, d3))
    valid = (elen >= EPS) & (denom != 0.0) & ((w0 > 0.0) | (w1 > 0.0))
    lam = torch.where(valid, (phi - rest_angle) * safe_inv(denom)
                      * stiffness, _zero(denom))
    lam = torch.where(dot3(cross3(n1u, n2u), e) > 0.0, -lam, lam)
    return torch.stack([_v(-w0 * lam) * d0, _v(-w1 * lam) * d1,
                        _v(-w2 * lam) * d2, _v(-w3 * lam) * d3], dim=-2)


def _volume_gradients(p0, p1, p2, p3):
    """Signed volume ``(p1−p0)×(p2−p0)·(p3−p0)/6`` and its four gradients
    (``pbd.py:76-82``)."""
    volume = dot3(cross3(p1 - p0, p2 - p0), p3 - p0) / 6.0
    grads = [cross3(p1 - p2, p3 - p2), cross3(p2 - p0, p3 - p0),
             cross3(p0 - p1, p3 - p1), cross3(p1 - p0, p2 - p0)]
    return volume, grads


def _weighted_sq(ws, grads):
    """``Σⱼ wⱼ‖∇ⱼ‖²``, added in vertex order."""
    total = ws[0] * dot3(grads[0], grads[0])
    for w, g in zip(ws[1:], grads[1:]):
        total = total + w * dot3(g, g)
    return total


def solve_volume(p0, w0, p1, w1, p2, w2, p3, w3, rest_volume, stiffness):
    """Classic tet volume preservation (``pbd.py:73-92``). Returns
    ``corr (..., 4, 3)``."""
    volume, grads = _volume_gradients(p0, p1, p2, p3)
    ws = [w0, w1, w2, w3]
    denom = _weighted_sq(ws, grads)
    valid = (stiffness != 0.0) & (torch.abs(denom) >= EPS)
    lam = torch.where(valid, stiffness * (volume - rest_volume)
                      * safe_inv(denom), _zero(denom))
    return torch.stack([_v(-lam * w) * g for w, g in zip(ws, grads)],
                       dim=-2)


def isometric_terms(q_mat, xs):
    """``E = ½ xᵀQx`` and ``∇ = Q x`` over the internal stencil ``xs``
    ``(..., 4, 3)`` (``pbd.py:104-105``). Returns ``(energy, grad)``."""
    grad = q_mat[..., :, 0, None] * xs[..., None, 0, :]
    for k in range(1, 4):
        grad = grad + q_mat[..., :, k, None] * xs[..., None, k, :]
    energy = dot3(xs[..., 0, :], grad[..., 0, :])
    for j in range(1, 4):
        energy = energy + dot3(xs[..., j, :], grad[..., j, :])
    return 0.5 * energy, grad


def _internal(p0, p1, p2, p3, w0, w1, w2, w3):
    """The isometric stencil in its internal order ``[p2, p3, p0, p1]``."""
    return (torch.stack([p2, p3, p0, p1], dim=-2),
            torch.stack([w2, w3, w0, w1], dim=-1))


def _stencil_order(ci: Tensor) -> Tensor:
    """Internal ``[p2, p3, p0, p1]`` rows back in ``(p0, p1, p2, p3)``
    order (slices: an index list would be copied from the host)."""
    return torch.cat([ci[..., 2:, :], ci[..., :2, :]], dim=-2)


def _grad_norm(ws, grad):
    """``Σⱼ wⱼ‖∇ⱼ‖²`` of stacked ``(..., 4)`` weights and ``(..., 4, 3)``
    gradients."""
    return _weighted_sq([ws[..., j] for j in range(ws.shape[-1])],
                        [grad[..., j, :] for j in range(grad.shape[-2])])


def solve_isometric_bending(p0, w0, p1, w1, p2, w2, p3, w3, q_mat,
                            stiffness):
    """Classic isometric bending, ``Δλ = −k·E / Σ w‖∇E‖²``
    (``pbd.py:95-116``). Returns ``corr (..., 4, 3)`` in (p0, p1, p2, p3)
    order."""
    xs, ws = _internal(p0, p1, p2, p3, w0, w1, w2, w3)
    energy, grad = isometric_terms(q_mat, xs)
    sum_norm = _grad_norm(ws, grad)
    dlam = torch.where(torch.abs(sum_norm) > EPS,
                       -stiffness * energy * safe_inv(sum_norm),
                       _zero(sum_norm))
    ci = (dlam[..., None] * ws)[..., None] * grad
    return _stencil_order(ci)


def solve_fem_triangle(p0, w0, p1, w1, p2, w2, area, inv_rest_mat,
                       youngs_x, youngs_y, youngs_shear,
                       poisson_xy, poisson_yx):
    """Orthotropic St. Venant–Kirchhoff membrane triangle
    (``PositionBasedDynamics.cpp:843-931``, ``pbd.py:119-169``);
    ``inv_rest_mat (..., 2, 2)``. Returns ``corr (..., 3, 3)``."""
    inv_den = safe_inv(1.0 - poisson_xy * poisson_yx)
    c00 = youngs_x * inv_den
    c01 = youngs_x * poisson_yx * inv_den
    c11 = youngs_y * inv_den
    c10 = youngs_y * poisson_xy * inv_den
    c22 = youngs_shear

    irm = inv_rest_mat
    e0, e1 = p0 - p2, p1 - p2
    # F (3, 2) = [p0 − p2 | p1 − p2] · invRestMat, by columns
    f0 = e0 * _v(irm[..., 0, 0]) + e1 * _v(irm[..., 1, 0])
    f1 = e0 * _v(irm[..., 0, 1]) + e1 * _v(irm[..., 1, 1])
    e00 = 0.5 * (dot3(f0, f0) - 1.0)
    e11 = 0.5 * (dot3(f1, f1) - 1.0)
    e01 = 0.5 * dot3(f0, f1)
    s00 = c00 * e00 + c01 * e11
    s11 = c10 * e00 + c11 * e11
    s01 = c22 * e01
    # area · (F · stress) · invRestMatᵀ, by columns
    a0 = _v(area) * (f0 * _v(s00) + f1 * _v(s01))
    a1 = _v(area) * (f0 * _v(s01) + f1 * _v(s11))
    energy = area * (0.5 * ((e00 * s00 + e11 * s11) + 2.0 * e01 * s01))
    grad0 = a0 * _v(irm[..., 0, 0]) + a1 * _v(irm[..., 0, 1])
    grad1 = a0 * _v(irm[..., 1, 0]) + a1 * _v(irm[..., 1, 1])
    grad2 = -grad0 - grad1
    ws, grads = [w0, w1, w2], [grad0, grad1, grad2]
    denom = _weighted_sq(ws, grads)
    s = torch.where(torch.abs(denom) > EPS, energy * safe_inv(denom),
                    _zero(denom))
    return torch.stack([_v(-s * w) * g for w, g in zip(ws, grads)], dim=-2)


def _strain_pass(ps, corr, ws, inv_rest, i, j, stretch_k, shear_k,
                 normalize_stretch, normalize_shear):
    """One (i, j) sub-constraint of the strain-based solve, Gauss-Seidel
    over the pairs inside the constraint (``pbd.py:172-219``). Divisions
    are guarded with ``safe_inv`` and a ``|denom| < EPS`` mask, as JAX's."""
    dim = len(ps) - 1
    cols = [(ps[k + 1] + corr[k + 1]) - (ps[0] + corr[0]) for k in range(dim)]

    def col_times(c):
        out = cols[0] * _v(inv_rest[..., 0, c])
        for k in range(1, dim):
            out = out + cols[k] * _v(inv_rest[..., k, c])
        return out

    fi, fj = col_times(i), col_times(j)
    sij = dot3(fi, fj)
    ds = [fj * _v(inv_rest[..., k, i]) + fi * _v(inv_rest[..., k, j])
          for k in range(dim)]
    if normalize_shear and i != j:
        wi2, wj2 = dot3(fi, fi), dot3(fj, fj)
        wi = sqrt_rn(torch.clamp_min(wi2, 1e-24))
        wj = sqrt_rn(torch.clamp_min(wj2, 1e-24))
        s1 = safe_inv(wi * wj)
        s3 = s1 * s1 * s1
        ds = [_v(s1) * dk - _v(sij * s3)
              * (_v(wj2) * fi * _v(inv_rest[..., k, i])
                 + _v(wi2) * fj * _v(inv_rest[..., k, j]))
              for k, dk in enumerate(ds)]
        sij = sij * s1
    d0 = -ds[0]
    for dk in ds[1:]:
        d0 = d0 - dk
    dall = [d0] + ds
    denom = _weighted_sq(ws, dall)

    if i == j:
        if normalize_stretch:
            s = sqrt_rn(torch.clamp_min(sij, 0.0))
            lam = 2.0 * s * (s - 1.0) * safe_inv(denom) * stretch_k[..., i]
        else:
            lam = (sij - 1.0) * safe_inv(denom) * stretch_k[..., i]
    else:
        lam = sij * safe_inv(denom) * shear_k[..., i + j - 1]
    lam = torch.where(torch.abs(denom) < EPS, _zero(lam), lam)
    return [c - _v(lam * w) * d for c, w, d in zip(corr, ws, dall)]


def _strain_solve(ps, ws, inv_rest_mat, stretch_k, shear_k,
                  normalize_stretch, normalize_shear):
    dim = len(ps) - 1
    corr = [torch.zeros_like(ps[0]) for _ in ps]
    for i in range(dim):
        for j in range(i + 1):
            corr = _strain_pass(ps, corr, ws, inv_rest_mat, i, j,
                                stretch_k, shear_k,
                                normalize_stretch, normalize_shear)
    return torch.stack(corr, dim=-2)


def solve_strain_triangle(p0, w0, p1, w1, p2, w2, inv_rest_mat,
                          stretch_k, shear_k,
                          normalize_stretch=False, normalize_shear=False):
    """Strain-based dynamics triangle, sub-constraints S00, S10, S11
    (``PositionBasedDynamics.cpp:590-688``, ``pbd.py:222-238``).
    ``stretch_k (..., 2)``, ``shear_k (..., 1)``. Returns
    ``corr (..., 3, 3)``."""
    return _strain_solve([p0, p1, p2], [w0, w1, w2], inv_rest_mat,
                         stretch_k, shear_k, normalize_stretch,
                         normalize_shear)


def solve_strain_tetra(p0, w0, p1, w1, p2, w2, p3, w3, inv_rest_mat,
                       stretch_k, shear_k,
                       normalize_stretch=False, normalize_shear=False):
    """Strain-based dynamics tetrahedron, six sub-constraints Sij
    (``PositionBasedDynamics.cpp:711-805``, ``pbd.py:241-256``).
    ``stretch_k (..., 3)``, ``shear_k (..., 3)``. Returns
    ``corr (..., 4, 3)``."""
    return _strain_solve([p0, p1, p2, p3], [w0, w1, w2, w3], inv_rest_mat,
                         stretch_k, shear_k, normalize_stretch,
                         normalize_shear)


def solve_fem_tetra_classic(p0, w0, p1, w1, p2, w2, p3, w3,
                            rest_volume, inv_rest_mat, youngs, poisson,
                            handle_inversion=True):
    """Classic FEM tet: one Newton step on the StVK energy with Young's
    modulus in the Lamé parameters (``PositionBasedDynamics.cpp:1109-1170``,
    ``pbd.py:259-290``); a tet of volume ≤ 0 takes the inversion-safe
    energy. Returns ``corr (..., 4, 3)``."""
    from . import xpbd as _xpbd

    mu = youngs * 0.5 * safe_inv(1.0 + poisson)
    lame = youngs * poisson * safe_inv((1.0 + poisson)
                                       * (1.0 - 2.0 * poisson))
    energy, sigma = _xpbd.select_energy(p0, p1, p2, p3, inv_rest_mat,
                                        rest_volume, mu, lame,
                                        handle_inversion)
    grads = _xpbd.grad_c_green(rest_volume, inv_rest_mat, sigma)
    ws = torch.stack([w0, w1, w2, w3], dim=-1)
    denom = _grad_norm(ws, grads)
    valid = (denom >= EPS) & (youngs > 0.0)
    s = torch.where(valid, energy * safe_inv(denom), _zero(denom))
    return (-s[..., None] * ws)[..., None] * grads


def solve_shape_matching_cluster(x, x0, w, rest_cm, stiffness, mask):
    """Stateless cluster shape matching through the reference's stable
    polar decomposition (``PositionBasedDynamics.cpp:481-558``,
    ``pbd.py:293-318``): masses ``m = mask/(w + EPS)``, goal
    ``g = cm + R(x0 − cm0)``, correction ``(g − x)·k``. ``x, x0 (..., K,
    3)``, ``w, mask (..., K)``, ``rest_cm (..., 3)``, ``stiffness (...)``.
    Returns ``corr (..., K, 3)``."""
    m = mask / (w + EPS)
    cm = (m[..., None] * x).sum(dim=-2) * _v(safe_inv(m.sum(dim=-1)))
    p = x - cm[..., None, :]
    q0c = x0 - rest_cm[..., None, :]
    a_pq = torch.einsum("...k,...ki,...kj->...ij", m, p, q0c)
    r = polar_decomposition_stable(a_pq)
    goal = cm[..., None, :] + torch.matmul(q0c, r.transpose(-1, -2))
    return mask[..., None] * stiffness[..., None, None] * (goal - x)


def _stiffness_for(c, compression_stiffness, stretch_stiffness):
    return torch.where(c < 0.0, compression_stiffness, stretch_stiffness)


def solve_edge_point_distance(p, w, p0, w0, p1, w1, rest_dist,
                              compression_stiffness, stretch_stiffness):
    """Point against edge distance (``PositionBasedDynamics.cpp:239-289``,
    ``pbd.py:327-351``). Returns ``corr (..., 3, 3)`` for (p, p0, p1)."""
    d = p1 - p0
    d2 = dot3(d, d)
    t = torch.where(d2 < EPS * EPS, torch.full_like(d2, 0.5),
                    torch.clamp(dot3(d, p - p1) * safe_inv(
                        torch.clamp_min(d2, 1e-30)), 0.0, 1.0))
    n = p - (p0 + d * _v(t))
    dist = norm3(n)
    n = n * _v(safe_inv(torch.clamp_min(dist, 1e-12)))
    c = dist - rest_dist
    b0, b1 = 1.0 - t, t
    s_den = (w + w0 * b0 * b0) + w1 * b1 * b1
    k = _stiffness_for(c, compression_stiffness, stretch_stiffness)
    s = torch.where(s_den > 0.0, k * c * safe_inv(
        torch.clamp_min(s_den, 1e-30)), _zero(s_den))
    return torch.stack([_v(-s * w) * n, _v(s * w0 * b0) * n,
                        _v(s * w1 * b1) * n], dim=-2)


def _edge_t(pa, pb, pt):
    dd = pb - pa
    dd2 = dot3(dd, dd)
    return torch.where(dd2 == 0.0, torch.full_like(dd2, 0.5),
                       torch.clamp(dot3(dd, pt - pa) * safe_inv(
                           torch.clamp_min(dd2, 1e-30)), 0.0, 1.0))


def solve_triangle_point_distance(p, w, p0, w0, p1, w1, p2, w2, rest_dist,
                                  compression_stiffness,
                                  stretch_stiffness):
    """Point against triangle distance, the closest point by barycentric
    region (``PositionBasedDynamics.cpp:291-384``, ``pbd.py:354-411``).
    Returns ``corr (..., 4, 3)`` for (p, p0, p1, p2)."""
    d1 = p1 - p0
    d2 = p2 - p0
    pp0 = p - p0
    a = dot3(d1, d1)
    b = dot3(d2, d1)
    cdot = dot3(pp0, d1)
    e = dot3(d2, d2)
    f = dot3(pp0, d2)
    det = a * e - b * b
    nz = det != 0.0
    inv_det = safe_inv(torch.where(nz, det, torch.ones_like(det)))
    s = (cdot * e - b * f) * inv_det
    t = (a * f - cdot * b) * inv_det
    third = torch.full_like(det, 1.0 / 3.0)
    b0 = torch.where(nz, 1.0 - s - t, third)
    b1 = torch.where(nz, s, third)
    b2 = torch.where(nz, t, third)

    # the reference's else-if chain over the region edges, branch-free
    t12 = _edge_t(p1, p2, p)
    t20 = _edge_t(p2, p0, p)
    t01 = _edge_t(p0, p1, p)
    on12 = nz & (b0 < 0.0)
    on20 = nz & (b0 >= 0.0) & (b1 < 0.0)
    on01 = nz & (b0 >= 0.0) & (b1 >= 0.0) & (b2 < 0.0)
    zero = torch.zeros_like(det)
    b0n = torch.where(on12, zero, torch.where(
        on20, t20, torch.where(on01, 1.0 - t01, b0)))
    b1n = torch.where(on12, 1.0 - t12, torch.where(
        on20, zero, torch.where(on01, t01, b1)))
    b2n = torch.where(on12, t12, torch.where(
        on20, 1.0 - t20, torch.where(on01, zero, b2)))
    b0, b1, b2 = b0n, b1n, b2n

    q = (p0 * _v(b0) + p1 * _v(b1)) + p2 * _v(b2)
    n = p - q
    dist = norm3(n)
    n = n * _v(safe_inv(torch.clamp_min(dist, 1e-12)))
    c = dist - rest_dist
    s_den = ((w + w0 * b0 * b0) + w1 * b1 * b1) + w2 * b2 * b2
    k = _stiffness_for(c, compression_stiffness, stretch_stiffness)
    ss = torch.where(s_den > 0.0, k * c * safe_inv(
        torch.clamp_min(s_den, 1e-30)), zero)
    return torch.stack([_v(-ss * w) * n, _v(ss * w0 * b0) * n,
                        _v(ss * w1 * b1) * n, _v(ss * w2 * b2) * n], dim=-2)


def solve_edge_edge_distance(p0, w0, p1, w1, p2, w2, p3, w3, rest_dist,
                             compression_stiffness, stretch_stiffness):
    """Edge against edge distance, the parallel case by the reference's
    overlap-midpoint rule (``PositionBasedDynamics.cpp:386-478``,
    ``pbd.py:414-471``). Returns ``corr (..., 4, 3)``."""
    d0 = p1 - p0
    d1 = p3 - p2
    a = dot3(d0, d0)
    b = -dot3(d0, d1)
    cc = dot3(d0, d1)
    d = -dot3(d1, d1)
    e = dot3(p2 - p0, d0)
    f = dot3(p2 - p0, d1)
    det = a * d - b * cc
    nondeg = det != 0.0
    one, zero = torch.ones_like(det), torch.zeros_like(det)
    half = torch.full_like(det, 0.5)
    inv_det = safe_inv(torch.where(nondeg, det, one))
    s_nd = (e * d - b * f) * inv_det
    t_nd = (a * f - e * cc) * inv_det

    # parallel case: the overlap's midpoint along d0
    s0, s1 = dot3(p0, d0), dot3(p1, d0)
    t0, t1 = dot3(p2, d0), dot3(p3, d0)
    flip0, flip1 = s0 > s1, t0 > t1
    s0s, s1s = torch.minimum(s0, s1), torch.maximum(s0, s1)
    t0s, t1s = torch.minimum(t0, t1), torch.maximum(t0, t1)
    disjoint_a = s0s >= t1s
    disjoint_b = t0s >= s1s
    mid = torch.where(s0s > t0s, 0.5 * (s0s + t1s), 0.5 * (t0s + s1s))
    s_ov = torch.where(s0s == s1s, half, (mid - s0s) * safe_inv(
        torch.where(s1s != s0s, s1s - s0s, one)))
    t_ov = torch.where(t0s == t1s, half, (mid - t0s) * safe_inv(
        torch.where(t1s != t0s, t1s - t0s, one)))
    s_par = torch.where(disjoint_a, torch.where(flip0, one, zero),
                        torch.where(disjoint_b, torch.where(flip0, zero, one),
                                    s_ov))
    t_par = torch.where(disjoint_a, torch.where(flip1, zero, one),
                        torch.where(disjoint_b, torch.where(flip1, one, zero),
                                    t_ov))

    s = torch.clamp(torch.where(nondeg, s_nd, s_par), 0.0, 1.0)
    t = torch.clamp(torch.where(nondeg, t_nd, t_par), 0.0, 1.0)
    b0, b1 = 1.0 - s, s
    b2, b3 = 1.0 - t, t
    n = (p0 * _v(b0) + p1 * _v(b1)) - (p2 * _v(b2) + p3 * _v(b3))
    dist = norm3(n)
    n = n * _v(safe_inv(torch.clamp_min(dist, 1e-12)))
    c = dist - rest_dist
    s_den = ((w0 * b0 * b0 + w1 * b1 * b1) + w2 * b2 * b2) + w3 * b3 * b3
    k = _stiffness_for(c, compression_stiffness, stretch_stiffness)
    ss = torch.where(s_den > 0.0, k * c * safe_inv(
        torch.clamp_min(s_den, 1e-30)), zero)
    return torch.stack([_v(-ss * w0 * b0) * n, _v(-ss * w1 * b1) * n,
                        _v(ss * w2 * b2) * n, _v(ss * w3 * b3) * n], dim=-2)
