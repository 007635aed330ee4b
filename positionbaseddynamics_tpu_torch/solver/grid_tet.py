"""Structured-grid XPBD FEM-tet solids on tensors — port of
``positionbaseddynamics_tpu/solver/grid_tet.py`` (the XLA stencil path).

On a regular tet bar (``regular_tet_grid``: hex cells split into 5 tets,
mirrored in odd cells so neighbours share faces) every tet is one of 5
families whose 4 vertices sit at fixed cell-corner offsets. The gather →
solve → scatter round becomes shifted-slice arithmetic: the 8 cell-corner
vertex grids are 8 slices of the ``(W, H, D, 3)`` position grid, each
family's 4 points are parity selections of two corners, and the
corrections accumulate into 8 per-corner buffers that 8 slice-adds write
back. Per-cell rest data is congruent within a parity class, so it
collapses to 2 × 5 constants.

This module is the plain PyTorch version: it runs on the CPU and, on the
card, for every configuration the fused kernel of ``grid_tet_cuda.py``
does not cover. The solve (``XPBD.cpp:217-294``) matches the JAX
package's operation by operation: every sum is added left to right, as
the JAX code's Python ``sum`` adds, and the square root is correctly
rounded on the CPU (``grid_cloth._sqrt``).

Positions are one scene's ``(N, 3)`` or ``K`` rollouts' ``(K, N, 3)``
(any leading axes, with inverse masses ``(N,)`` shared or ``(K, N)``),
as JAX's planner ``vmap``s the grid path over its samples
(``mpc/planners.py:90, :105``); λ is ``(..., 5, cells)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import reduce
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.mathutils import EPS, safe_inv
from .grid_cloth import _sqrt

Tensor = torch.Tensor

# cell corner offsets in (i, j, k) — vertex flat index i*H*D + j*D + k;
# numbering mirrors ``regular_tet_grid`` (p0..p7)
_CORNERS = np.array([
    (0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0),
    (0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0),
], np.int32)
# 5 tet families per cell; odd cells ((i+j+k)%2==1) use the mirrored set
_TETS_ODD = np.array([
    (2, 1, 6, 3), (6, 3, 4, 7), (4, 1, 6, 5), (3, 1, 4, 0), (6, 1, 4, 3),
], np.int32)
_TETS_EVEN = np.array([
    (0, 2, 5, 1), (7, 2, 0, 3), (5, 2, 7, 6), (7, 0, 5, 4), (0, 2, 7, 5),
], np.int32)


def _lsum(terms):
    """Left-to-right sum, the order of the JAX code's Python ``sum``."""
    return reduce(lambda a, b: a + b, terms)


def _collapse_uniform(a, what):
    """Congruent cells produce identical rest data up to float64 rounding;
    collapse to the mean or refuse the grid path."""
    flat = a.reshape(-1, *a.shape[3:])
    mean = flat.mean(axis=0)
    scale = np.maximum(np.abs(mean), 1e-12)
    if not np.all(np.abs(flat - mean) <= 1e-5 * scale + 1e-9):
        raise NotImplementedError(
            f"grid tet fast path requires congruent cells ({what} varies)")
    return mean


def _cell_grid(wc: int, hc: int, dc: int):
    return np.meshgrid(np.arange(wc), np.arange(hc), np.arange(dc),
                       indexing="ij")


def odd_cells(width: int, height: int, depth: int) -> np.ndarray:
    """``(C,)`` parity ``(i+j+k) % 2 == 1`` of the cells in ``i, j, k``
    order, ``C = (W−1)(H−1)(D−1)``."""
    ii, jj, kk = _cell_grid(width - 1, height - 1, depth - 1)
    return ((ii + jj + kk) % 2 == 1).reshape(-1)


@dataclass(frozen=True)
class GridTetBatch:
    """Stencil-form XPBD FEM-tet constraints of one regular tet grid."""

    inv_rest_odd: Tensor     # (5, 3, 3) per-family inverse rest matrix
    inv_rest_even: Tensor    # (5, 3, 3)
    rest_vol_odd: Tensor     # (5,)
    rest_vol_even: Tensor    # (5,)
    youngs: Tensor           # scalar
    poisson: Tensor          # scalar
    inv_cnt: Tensor          # (W, H, D, 1) 1/#tets per vertex
    width: int
    height: int
    depth: int
    offset: int
    # True = the reference's inversion semantics: the SVD energy is
    # evaluated for every tet and selected where the tet's volume is
    # ≤ 0. Without inversions the two settings give bitwise-identical
    # trajectories (see the JAX module's field docstring).
    inversion_handling: bool = False
    # (C,) bool cell parity, derived once
    odd: Optional[Tensor] = field(default=None, repr=False)

    def __post_init__(self):
        if self.odd is None:
            object.__setattr__(self, "odd", torch.as_tensor(
                odd_cells(self.width, self.height, self.depth),
                device=self.inv_cnt.device))

    @property
    def device(self) -> torch.device:
        return self.inv_cnt.device

    @property
    def n_cells(self) -> int:
        return (self.width - 1) * (self.height - 1) * (self.depth - 1)

    # -- build -------------------------------------------------------------

    @staticmethod
    def create(width: int, height: int, depth: int, offset: int,
               x0: np.ndarray, stiffness: float, poisson_ratio: float,
               inversion_handling: bool = False,
               device=None) -> "GridTetBatch":
        """``x0`` is the full scene rest-position array; the tet grid
        occupies rows ``offset : offset + W*H*D`` in ``i*H*D + j*D + k``
        order (``regular_tet_grid``). Raises NotImplementedError when the
        cells are not congruent."""
        dev = resolve_device(device)
        w, h, d = width, height, depth
        blk = np.asarray(x0, np.float64)[offset:offset + w * h * d]
        g = blk.reshape(w, h, d, 3)
        wc, hc, dc = w - 1, h - 1, d - 1

        corners = [g[a:a + wc, b:b + hc, c:c + dc] for a, b, c in _CORNERS]
        ii, jj, kk = _cell_grid(wc, hc, dc)
        odd = ((ii + jj + kk) % 2 == 1)

        def _family_rest(tet_table, mask):
            irm, vol = [], []
            for t in range(5):
                p0, p1, p2, p3 = [corners[c][mask] for c in tet_table[t]]
                dm = np.stack([p0 - p3, p1 - p3, p2 - p3], axis=-1)
                v = np.abs(np.einsum(
                    "cd,cd->c", np.cross(p1 - p0, p2 - p0), p3 - p0) / 6.0)
                irm.append(_collapse_uniform(
                    np.linalg.inv(dm).reshape(-1, 1, 1, 3, 3), "rest matrix"))
                vol.append(float(_collapse_uniform(
                    v.reshape(-1, 1, 1), "rest volume")))
            return np.stack(irm), np.asarray(vol)

        irm_o, vol_o = _family_rest(_TETS_ODD, odd)
        irm_e, vol_e = _family_rest(_TETS_EVEN, ~odd)

        cnt = np.zeros((w * h * d,), np.float64)
        hd = h * d
        cell_base = (ii * hd + jj * d + kk).ravel()
        for t in range(5):
            for parity, table in ((odd, _TETS_ODD), (~odd, _TETS_EVEN)):
                for c in table[t]:
                    a, b, cc = _CORNERS[c]
                    vidx = cell_base[parity.ravel()] + a * hd + b * d + cc
                    np.add.at(cnt, vidx, 1.0)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return GridTetBatch(
            inv_rest_odd=f32(irm_o), inv_rest_even=f32(irm_e),
            rest_vol_odd=f32(vol_o), rest_vol_even=f32(vol_e),
            youngs=f32(stiffness), poisson=f32(poisson_ratio),
            inv_cnt=f32((1.0 / np.maximum(cnt, 1.0)).reshape(w, h, d, 1)),
            width=w, height=h, depth=d, offset=offset,
            inversion_handling=bool(inversion_handling))

    def init_lambda(self) -> Tensor:
        return torch.zeros((5, self.n_cells), dtype=torch.float32,
                           device=self.device)

    # -- solve ---------------------------------------------------------------

    def lame_parameters(self) -> Tuple[Tensor, Tensor]:
        """The Lamé parameters per unit Young's modulus, ``(μ/E, λ/E)``, in
        float32 as ``_solve_family`` computes them; E enters through the
        compliance ``α = 1/(E h²)``."""
        p = self.poisson
        return 0.5 / (1.0 + p), p / ((1.0 + p) * (1.0 - 2.0 * p))

    def _solve_family(self, pts, ws, irm9, vol, dt, lam):
        """XPBD FEM-tet solve over all cells of one family — the math of
        ``XPBD::solve_FEMTetraConstraint`` (``XPBD.cpp:217-294``) unrolled
        over component planes, as ``grid_tet.py:179-268``.

        ``pts`` 4×[(C,) x, y, z], ``ws`` 4×(C,), ``irm9`` 3×3 list of
        (C,) (inverse rest matrix), ``vol`` (C,). Returns (4×3 list of
        (C,) corrections, new λ)."""
        mu, lame = self.lame_parameters()

        # edge vectors dᵢ = pᵢ − p₃ as component planes: ds[a][i]
        ds = [[pts[i][a] - pts[3][a] for i in range(3)] for a in range(3)]
        # F = D_s · D_m⁻¹  (PositionBasedDynamics.cpp:958-980)
        f = [[_lsum(ds[a][c] * irm9[c][b] for c in range(3))
              for b in range(3)] for a in range(3)]

        # ε = ½(FᵀF − I), symmetric
        eps = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(a, 3):
                ftf = f[0][a] * f[0][b] + f[1][a] * f[1][b] \
                    + f[2][a] * f[2][b]
                eps[a][b] = eps[b][a] = (0.5 * (ftf - 1.0) if a == b
                                         else 0.5 * ftf)
        trace = eps[0][0] + eps[1][1] + eps[2][2]
        # σ = F(2με + λ tr(ε) I); Ψ = μ‖ε‖² + ½λ tr²  (…cpp:958-1008)
        two_mu = 2.0 * mu
        lame_tr = lame * trace
        s_in = [[two_mu * eps[a][b] + lame_tr if a == b
                 else two_mu * eps[a][b] for b in range(3)] for a in range(3)]
        sigma = [[_lsum(f[a][c] * s_in[c][b] for c in range(3))
                  for b in range(3)] for a in range(3)]
        psi = mu * _lsum(eps[a][b] * eps[a][b]
                         for a in range(3) for b in range(3)) \
            + 0.5 * lame * trace * trace
        u_prime = vol * psi

        if self.inversion_handling:
            # a tet of volume ≤ 0 takes the reference's SVD path
            # (computeGreenStrainAndPiolaStressInversion,
            # PositionBasedDynamics.cpp:1034-1106), computed for every
            # tet and selected, as the unstructured batch does
            from ..ops.xpbd import green_strain_energy_inversion
            p_vecs = [torch.stack(pts[i], dim=-1) for i in range(4)]
            irm_m = torch.stack([torch.stack(irm9[a], dim=-1)
                                 for a in range(3)], dim=-2)
            cr = torch.linalg.cross(p_vecs[1] - p_vecs[0],
                                    p_vecs[2] - p_vecs[0], dim=-1)
            e3 = p_vecs[3] - p_vecs[0]
            volume = _lsum(cr[..., k] * e3[..., k] for k in range(3)) / 6.0
            u_inv, sig_inv, _f = green_strain_energy_inversion(
                *p_vecs, irm_m, vol, mu, lame)
            inv = volume <= 0.0
            u_prime = torch.where(inv, u_inv, u_prime)
            sigma = [[torch.where(inv, sig_inv[..., a, b], sigma[a][b])
                      for b in range(3)] for a in range(3)]

        # H = V₀ σ D_m⁻ᵀ; columns are ∇₀..∇₂, ∇₃ = −Σ (computeGradCGreen)
        grad = [[vol * _lsum(sigma[a][c] * irm9[b][c] for c in range(3))
                 for a in range(3)] for b in range(3)]   # grad[j][comp]
        grad.append([-(grad[0][a] + grad[1][a] + grad[2][a])
                     for a in range(3)])

        c = _sqrt(torch.clamp_min(2.0 * u_prime, 0.0))
        sum_norm = _lsum(ws[j] * (grad[j][0] * grad[j][0]
                                  + grad[j][1] * grad[j][1]
                                  + grad[j][2] * grad[j][2])
                         for j in range(4))
        alpha = safe_inv(self.youngs * dt * dt)
        sum_norm = sum_norm + c * c * alpha
        valid = (sum_norm >= EPS) & (self.youngs > 0.0)
        dlam = torch.where(valid,
                           -c * (c + alpha * lam) * safe_inv(sum_norm),
                           torch.zeros_like(sum_norm))
        corrs = [[dlam * ws[j] * grad[j][a] for a in range(3)]
                 for j in range(4)]
        return corrs, lam + dlam

    # -- the grid block and its per-family views -----------------------------

    def _block(self, x: Tensor, inv_mass: Tensor):
        """The grid's positions ``(..., W, H, D, 3)`` and inverse masses
        ``(..., W, H, D)`` of ``x (..., N, 3)`` and ``inv_mass (..., N)``."""
        w, h, d, o = self.width, self.height, self.depth, self.offset
        n_blk = w * h * d
        return (x[..., o:o + n_blk, :].reshape(*x.shape[:-2], w, h, d, 3),
                inv_mass[..., o:o + n_blk].reshape(
                    *inv_mass.shape[:-1], w, h, d))

    def _unblock(self, x: Tensor, g: Tensor) -> Tensor:
        o = self.offset
        flat = g.reshape(*g.shape[:-4], -1, 3)
        if o == 0 and flat.shape[-2] == x.shape[-2] \
                and flat.shape == x.shape:
            return flat
        x = x.expand(*flat.shape[:-2], *x.shape[-2:]).clone()
        x[..., o:o + flat.shape[-2], :] = flat
        return x

    def _corners(self, grid, vec: bool):
        """The 8 corner slices of a ``(..., W, H, D)`` grid (``vec``: with
        a trailing 3), each flattened to cells: ``[(..., C[, 3])] × 8``."""
        wc, hc, dc = self.width - 1, self.height - 1, self.depth - 1
        if vec:
            grid = grid.movedim(-1, 0)
        out = [grid[..., a:a + wc, b:b + hc, c:c + dc].flatten(-3)
               for a, b, c in _CORNERS]
        return [o.movedim(0, -1) for o in out] if vec else out

    def _family_rest(self, t):
        """Per-cell inverse rest matrix (3×3 list of (C,)) and rest volume
        (C,) of family ``t``, selected by cell parity."""
        odd = self.odd
        irm9 = [[torch.where(odd, self.inv_rest_odd[t, a, b],
                             self.inv_rest_even[t, a, b])
                 for b in range(3)] for a in range(3)]
        vol = torch.where(odd, self.rest_vol_odd[t], self.rest_vol_even[t])
        return irm9, vol

    def _family_points(self, corners_x, corners_w, t):
        co, ce = _TETS_ODD[t], _TETS_EVEN[t]
        odd = self.odd
        pts = [[torch.where(odd, corners_x[co[k]][..., a],
                            corners_x[ce[k]][..., a]) for a in range(3)]
               for k in range(4)]
        ws = [torch.where(odd, corners_w[co[k]], corners_w[ce[k]])
              for k in range(4)]
        return pts, ws

    def _add_corners(self, dx, planes):
        """``dx[corner slice] += planes[corner]`` for corners 0..7, in
        order. ``dx`` is ``(..., W, H, D, 3)``, ``planes[ci]`` ``(..., C,
        3)`` or None."""
        wc, hc, dc = self.width - 1, self.height - 1, self.depth - 1
        for ci, (a, b, c) in enumerate(_CORNERS):
            if planes[ci] is not None:
                pl = planes[ci]
                dx[..., a:a + wc, b:b + hc, c:c + dc, :].add_(
                    pl.reshape(*pl.shape[:-2], wc, hc, dc, 3))
        return dx

    # -- projections ---------------------------------------------------------

    def project_gs(self, x: Tensor, inv_mass: Tensor, lams: Tensor, dt
                   ) -> Tuple[Tensor, Tensor]:
        """Colour-sequential Gauss-Seidel on the tet grid: per family, per
        ``(i%2, j%2, k%2)`` lattice colour — tets of one family in
        non-adjacent cells share no vertices, so each of the 8 colours
        applies its corrections at once (``grid_tet.py:270-331``)."""
        g, wg = self._block(x, inv_mass)
        ii, jj, kk = _cell_grid(self.width - 1, self.height - 1,
                                self.depth - 1)
        oddf = self.odd.to(torch.float32)
        evenf = 1.0 - oddf
        colors = [torch.as_tensor(
            ((ii % 2 == a) & (jj % 2 == b) & (kk % 2 == c)).reshape(-1),
            dtype=torch.float32, device=self.device)
            for a in (0, 1) for b in (0, 1) for c in (0, 1)]
        corners_w = self._corners(wg, False)
        new_lams = [lams[..., t, :] for t in range(5)]
        for t in range(5):
            co, ce = _TETS_ODD[t], _TETS_EVEN[t]
            irm9, vol = self._family_rest(t)
            for cm in colors:
                pts, ws = self._family_points(self._corners(g, True),
                                              corners_w, t)
                corrs, nl = self._solve_family(pts, ws, irm9, vol, dt,
                                               new_lams[t])
                new_lams[t] = new_lams[t] + (nl - new_lams[t]) * cm
                dx = torch.zeros_like(g)
                for k in range(4):
                    for parf, corner in ((oddf, co[k]), (evenf, ce[k])):
                        plane = torch.stack([corrs[k][a] * parf * cm
                                             for a in range(3)], dim=-1)
                        self._add_corners(
                            dx, [plane if ci == corner else None
                                 for ci in range(8)])
                g = g + dx            # disjoint within a colour
        return self._unblock(x, g), torch.stack(new_lams, dim=-2)

    def project(self, x: Tensor, inv_mass: Tensor, lams: Tensor, dt,
                omega: float = 1.0) -> Tuple[Tensor, Tensor]:
        """One Jacobi pass of all 5 tet families on the grid block of
        ``x``, averaged by the per-vertex tet counts and scaled by
        ``omega`` (``grid_tet.py:333-385``). Per corner the families add
        in ascending order, then the corners 0..7 in order."""
        g, wg = self._block(x, inv_mass)
        corners_x = self._corners(g, True)
        corners_w = self._corners(wg, False)
        oddf = self.odd.to(torch.float32)
        evenf = 1.0 - oddf

        acc = [[torch.zeros_like(oddf) for _c in range(3)] for _k in range(8)]
        new_lams = []
        for t in range(5):
            co, ce = _TETS_ODD[t], _TETS_EVEN[t]
            pts, ws = self._family_points(corners_x, corners_w, t)
            irm9, vol = self._family_rest(t)
            corrs, nl = self._solve_family(pts, ws, irm9, vol, dt,
                                           lams[..., t, :])
            new_lams.append(nl)
            for k in range(4):
                # parity-route the correction back to the two corners
                for a in range(3):
                    acc[co[k]][a] = acc[co[k]][a] + oddf * corrs[k][a]
                    acc[ce[k]][a] = acc[ce[k]][a] + evenf * corrs[k][a]

        dx = self._add_corners(torch.zeros_like(g),
                               [torch.stack(acc[ci], dim=-1)
                                for ci in range(8)])
        g = g + omega * self.inv_cnt * dx
        return self._unblock(x, g), torch.stack(new_lams, dim=-2)

    def to(self, device) -> "GridTetBatch":
        """The same batch with every tensor on ``device``."""
        moved = {f: getattr(self, f).to(device) for f in (
            "inv_rest_odd", "inv_rest_even", "rest_vol_odd", "rest_vol_even",
            "youngs", "poisson", "inv_cnt")}
        return dataclasses.replace(self, odd=None, **moved)
