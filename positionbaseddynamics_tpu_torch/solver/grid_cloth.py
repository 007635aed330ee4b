"""Structured-grid XPBD cloth on tensors — port of
``positionbaseddynamics_tpu/solver/grid_cloth.py`` (the XLA stencil path).

On a regular triangle grid (``regular_triangle_grid``) every constraint
family is a fixed stencil, so the gather-solve-scatter round becomes
shifted-slice arithmetic with no index arrays on the device. This module
is the plain PyTorch version: it runs on the CPU and, on the card, for
every configuration the fused kernel of ``grid_cloth_cuda.py`` does not
cover.

Families (alternating-diagonal triangulation, ``helper = (i%2 == j%2)``):

* distance: horizontal ``(i,j)-(i,j+1)``, vertical ``(i,j)-(i+1,j)`` and
  one diagonal per quad — ``(i,j)-(i+1,j+1)`` where ``helper`` else
  ``(i,j+1)-(i+1,j)``;
* isometric bending, one stencil per interior edge, flaps blended by
  parity: horizontal edge flaps ``(i±1, j+h)``, vertical edge flaps
  ``(i+h, j±1)``, quad diagonal flaps the two off-diagonal corners.

Positions are ``(..., N, 3)``; any leading batch shape broadcasts
through every pass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.mathutils import sqrt_rn as _sqrt
from .constraints import _init_isometric_bending_s_np

Tensor = torch.Tensor


def _helper_grid(height: int, width: int) -> np.ndarray:
    """``helper(i,j) = (i%2 == j%2)`` over the quad grid (H-1, W-1)."""
    i, j = np.meshgrid(np.arange(height - 1), np.arange(width - 1),
                       indexing="ij")
    return (i % 2 == j % 2)


def _grid_edges_np(height: int, width: int):
    """Flat ``(a, b)`` index grids of the 3 distance families, keyed
    ``"h"``, ``"v"``, ``"d"``, in family-grid shape."""
    h, w = height, width
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flat = ii * w + jj

    hz = (flat[:, :-1], flat[:, 1:])                        # (H, W-1)
    vt = (flat[:-1, :], flat[1:, :])                        # (H-1, W)
    hp = _helper_grid(h, w)
    da = np.where(hp, flat[:-1, :-1], flat[:-1, 1:])        # (H-1, W-1)
    db = np.where(hp, flat[1:, 1:], flat[1:, :-1])
    return {"h": hz, "v": vt, "d": (da, db)}


def _bend_stencils_np(height: int, width: int):
    """Flat stencil indices ``(f0, f1, a, b)`` of the 3 bending families
    ``"bh"``, ``"bv"``, ``"bd"``, in family-grid shape."""
    h, w = height, width
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flat = ii * w + jj
    par = np.zeros((h, w), bool)
    par[: h - 1, : w - 1] = _helper_grid(h, w)

    out = {}
    # horizontal interior edges: i in 1..H-2, j in 0..W-2
    if h > 2:
        hp = par[1:-1, : w - 1]
        a = flat[1:-1, :-1]
        b = flat[1:-1, 1:]
        f0 = np.where(hp, flat[2:, 1:], flat[2:, :-1])        # (i+1, j+h)
        f1 = np.where(hp, flat[:-2, 1:], flat[:-2, :-1])      # (i-1, j+h)
        out["bh"] = (f0, f1, a, b)
    # vertical interior edges: i in 0..H-2, j in 1..W-2
    if w > 2:
        hp = par[: h - 1, 1:-1]
        a = flat[:-1, 1:-1]
        b = flat[1:, 1:-1]
        f0 = np.where(hp, flat[1:, 2:], flat[:-1, 2:])        # (i+h, j+1)
        f1 = np.where(hp, flat[1:, :-2], flat[:-1, :-2])      # (i+h, j-1)
        out["bv"] = (f0, f1, a, b)
    # quad diagonals: every quad
    hp = par[: h - 1, : w - 1]
    a = np.where(hp, flat[:-1, :-1], flat[:-1, 1:])
    b = np.where(hp, flat[1:, 1:], flat[1:, :-1])
    f0 = np.where(hp, flat[:-1, 1:], flat[:-1, :-1])
    f1 = np.where(hp, flat[1:, :-1], flat[1:, 1:])
    out["bd"] = (f0, f1, a, b)
    return out


_DIST_FAMILIES = ("h", "v", "d")
_BEND_FAMILIES = ("bh", "bv", "bd")


def _sl(g, rows, cols):
    """``g[..., rows, cols, :]`` on a ``(..., H, W, k)`` plane stack."""
    return g[..., rows, cols, :]


def _sum3(a):
    """Sum over the trailing axis of 3, kept, added left to right as the
    JAX package's ``jnp.sum`` adds it (``torch.sum`` pairs the terms in
    another order, which moves the result by an ulp)."""
    return (a[..., 0:1] + a[..., 1:2]) + a[..., 2:3]


_ALL = slice(None)
_HEAD = slice(None, -1)     # [:-1]
_TAIL = slice(1, None)      # [1:]
_MID = slice(1, -1)         # [1:-1]
_HEAD2 = slice(None, -2)    # [:-2]
_TAIL2 = slice(2, None)     # [2:]


@dataclass(frozen=True)
class GridClothBatch:
    """Stencil-form distance + isometric-bending constraints of one regular
    grid cloth. Per-constraint data lives in family-grid-shaped tensors,
    or in scalars where the family is uniform."""

    rest: dict          # family -> rest length, (Fh, Fw) or scalar
    stiff: dict         # family -> stiffness scalar (distance families)
    q_mat: dict         # family -> rank-1 bending factor S, (Fh, Fw, 4) or (4,)
    bend_stiff: dict    # family -> stiffness scalar
    inv_cnt_dist: Tensor    # (H, W, 1) 1/#distance constraints per particle
    inv_cnt_bend: Tensor    # (H, W, 1) 1/#bending stencils per particle
    height: int
    width: int
    offset: int
    xpbd_distance: bool
    xpbd_bending: bool
    has_distance: bool
    has_bending: bool
    # (H-1, W-1, 1) float triangulation parity, derived once
    parity: Optional[Tensor] = field(default=None, repr=False)

    def __post_init__(self):
        if self.parity is None:
            hp = _helper_grid(self.height, self.width)[..., None]
            object.__setattr__(self, "parity", torch.as_tensor(
                hp, dtype=torch.float32, device=self.inv_cnt_dist.device))

    @property
    def device(self) -> torch.device:
        return self.inv_cnt_dist.device

    # -- build -------------------------------------------------------------

    @staticmethod
    def create(height: int, width: int, offset: int, x0: np.ndarray,
               distance_stiffness, bending_stiffness=None,
               xpbd_distance: bool = True, xpbd_bending: bool = True,
               device=None) -> "GridClothBatch":
        """``x0`` is the full scene rest-position array (N, 3); the cloth
        occupies rows ``offset : offset + H*W`` in row-major order.
        ``distance_stiffness=None`` / ``bending_stiffness=None`` disable
        that family."""
        dev = resolve_device(device)
        h, w = height, width
        blk = np.asarray(x0, np.float64)[offset:offset + h * w]
        edges = _grid_edges_np(h, w)
        rest, stiff = {}, {}
        cnt_d = np.zeros((h * w,), np.float64)
        has_distance = distance_stiffness is not None

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def _collapse(a, shape):
            """Uniform per-constraint data collapses to its mean (a scalar
            or sub-array): congruent stencils agree up to f64→f32 init
            rounding, within a few f32 ulps."""
            flat = a.reshape(-1, *a.shape[len(shape):])
            mean = flat.mean(axis=0)
            scale = np.maximum(np.abs(mean), 1e-12)
            if np.all(np.abs(flat - mean) <= 1e-5 * scale + 1e-7):
                return f32(mean)
            return f32(a)

        if has_distance:
            for fam in _DIST_FAMILIES:
                ai, bi = edges[fam]
                r = np.linalg.norm(blk[ai] - blk[bi], axis=-1)
                rest[fam] = _collapse(r, r.shape)
                stiff[fam] = f32(distance_stiffness)
                np.add.at(cnt_d, ai.ravel(), 1.0)
                np.add.at(cnt_d, bi.ravel(), 1.0)

        q_mat, bstiff = {}, {}
        cnt_b = np.zeros((h * w,), np.float64)
        has_bending = bending_stiffness is not None
        if has_bending:
            for fam, (f0, f1, a, b) in _bend_stencils_np(h, w).items():
                sten = np.stack([f0, f1, a, b], axis=-1)       # (Fh, Fw, 4)
                pts = blk[sten.reshape(-1, 4)]                 # (F, 4, 3)
                s_vec = _init_isometric_bending_s_np(pts)
                q_mat[fam] = _collapse(
                    s_vec.reshape(sten.shape[:2] + (4,)), sten.shape[:2])
                bstiff[fam] = f32(bending_stiffness)
                np.add.at(cnt_b, sten.reshape(-1), 1.0)

        return GridClothBatch(
            rest=rest, stiff=stiff, q_mat=q_mat, bend_stiff=bstiff,
            inv_cnt_dist=f32((1.0 / np.maximum(cnt_d, 1.0)).reshape(h, w, 1)),
            inv_cnt_bend=f32((1.0 / np.maximum(cnt_b, 1.0)).reshape(h, w, 1)),
            height=h, width=w, offset=offset,
            xpbd_distance=bool(xpbd_distance),
            xpbd_bending=bool(xpbd_bending),
            has_distance=has_distance, has_bending=has_bending)

    def _family_shape(self, fam):
        h, w = self.height, self.width
        return {"h": (h, w - 1), "v": (h - 1, w), "d": (h - 1, w - 1),
                "bh": (h - 2, w - 1), "bv": (h - 1, w - 2),
                "bd": (h - 1, w - 1)}[fam]

    def init_lambda(self):
        def zeros(f):
            return torch.zeros(self._family_shape(f), dtype=torch.float32,
                               device=self.device)
        return ({f: zeros(f) for f in self.rest},
                {f: zeros(f) for f in self.q_mat})

    # -- family gathers (slices + parity blends) -----------------------------

    @staticmethod
    def _dist_endpoints(g, fam, hp):
        if fam == "h":
            return _sl(g, _ALL, _HEAD), _sl(g, _ALL, _TAIL)
        if fam == "v":
            return _sl(g, _HEAD, _ALL), _sl(g, _TAIL, _ALL)
        a = hp * _sl(g, _HEAD, _HEAD) + (1.0 - hp) * _sl(g, _HEAD, _TAIL)
        b = hp * _sl(g, _TAIL, _TAIL) + (1.0 - hp) * _sl(g, _TAIL, _HEAD)
        return a, b

    @staticmethod
    def _scatter_dist(acc, fam, hp, ca, cb):
        """Add the endpoint corrections ``ca``, ``cb`` into ``acc`` (a
        fresh buffer owned by the caller, updated in place)."""
        if fam == "h":
            _sl(acc, _ALL, _HEAD).add_(ca)
            _sl(acc, _ALL, _TAIL).add_(cb)
        elif fam == "v":
            _sl(acc, _HEAD, _ALL).add_(ca)
            _sl(acc, _TAIL, _ALL).add_(cb)
        else:
            _sl(acc, _HEAD, _HEAD).add_(ca * hp)
            _sl(acc, _HEAD, _TAIL).add_(ca * (1.0 - hp))
            _sl(acc, _TAIL, _TAIL).add_(cb * hp)
            _sl(acc, _TAIL, _HEAD).add_(cb * (1.0 - hp))
        return acc

    @staticmethod
    def _bend_points(g, fam, hp):
        """``([a, b, f0, f1], scatter)``: the 4 stencil point grids, each
        ``(..., Fh, Fw, k)``, and a closure that adds the matching list of
        4 correction grids into an accumulator in place."""
        def blend(p, x1, x0):
            return p * x1 + (1.0 - p) * x0

        def add_blend(acc, p, c, s1, s0):
            _sl(acc, *s1).add_(c * p)
            _sl(acc, *s0).add_(c * (1 - p))

        if fam == "bh":
            # helper(i, j) for i in 1..H-2 (hp has quad-grid shape)
            p = hp[1:, :]
            a, b = _sl(g, _MID, _HEAD), _sl(g, _MID, _TAIL)
            f0 = blend(p, _sl(g, _TAIL2, _TAIL), _sl(g, _TAIL2, _HEAD))
            f1 = blend(p, _sl(g, _HEAD2, _TAIL), _sl(g, _HEAD2, _HEAD))

            def scatter(acc, c):
                ca, cb, c0, c1 = c
                _sl(acc, _MID, _HEAD).add_(ca)
                _sl(acc, _MID, _TAIL).add_(cb)
                add_blend(acc, p, c0, (_TAIL2, _TAIL), (_TAIL2, _HEAD))
                add_blend(acc, p, c1, (_HEAD2, _TAIL), (_HEAD2, _HEAD))
                return acc
        elif fam == "bv":
            p = hp[:, 1:]
            a, b = _sl(g, _HEAD, _MID), _sl(g, _TAIL, _MID)
            f0 = blend(p, _sl(g, _TAIL, _TAIL2), _sl(g, _HEAD, _TAIL2))
            f1 = blend(p, _sl(g, _TAIL, _HEAD2), _sl(g, _HEAD, _HEAD2))

            def scatter(acc, c):
                ca, cb, c0, c1 = c
                _sl(acc, _HEAD, _MID).add_(ca)
                _sl(acc, _TAIL, _MID).add_(cb)
                add_blend(acc, p, c0, (_TAIL, _TAIL2), (_HEAD, _TAIL2))
                add_blend(acc, p, c1, (_TAIL, _HEAD2), (_HEAD, _HEAD2))
                return acc
        else:  # bd
            p = hp
            a = blend(p, _sl(g, _HEAD, _HEAD), _sl(g, _HEAD, _TAIL))
            b = blend(p, _sl(g, _TAIL, _TAIL), _sl(g, _TAIL, _HEAD))
            f0 = blend(p, _sl(g, _HEAD, _TAIL), _sl(g, _HEAD, _HEAD))
            f1 = blend(p, _sl(g, _TAIL, _HEAD), _sl(g, _TAIL, _TAIL))

            def scatter(acc, c):
                ca, cb, c0, c1 = c
                add_blend(acc, p, ca, (_HEAD, _HEAD), (_HEAD, _TAIL))
                add_blend(acc, p, cb, (_TAIL, _TAIL), (_TAIL, _HEAD))
                add_blend(acc, p, c0, (_HEAD, _TAIL), (_HEAD, _HEAD))
                add_blend(acc, p, c1, (_TAIL, _HEAD), (_TAIL, _TAIL))
                return acc
        return [a, b, f0, f1], scatter

    # -- per-family solves ---------------------------------------------------

    def _dist_solve(self, fam, pa, pb, wa, wb, lam, dt):
        """Distance solve of one family (``XPBD.cpp:14-60`` / classic
        ``PositionBasedDynamics.cpp:13``). Returns ``(correction along
        (a − b) for unit weights, Δλ)``; Δλ is None for non-XPBD."""
        n = pa - pb
        d = _sqrt(_sum3(n * n))
        c = d[..., 0] - self.rest[fam]
        nn = n / torch.clamp_min(d, 1e-6)
        stiff = self.stiff[fam]
        zero = torch.zeros((), dtype=torch.float32, device=d.device)
        if self.xpbd_distance:
            alpha = torch.where(stiff != 0.0, 1.0 / (stiff * dt * dt), zero)
            k = wa[..., 0] + wb[..., 0] + alpha
            valid = (d[..., 0] > 1e-6) & (torch.abs(k) > 1e-6)
            dlam = torch.where(valid, -(c + alpha * lam) / k, zero)
            return nn * dlam[..., None], dlam
        k = wa[..., 0] + wb[..., 0]
        valid = (d[..., 0] > 1e-6) & (k > 1e-9)
        s = torch.where(valid, stiff * c / torch.clamp_min(k, 1e-9), zero)
        return nn * (-s[..., None]), None

    def _bend_solve(self, fam, xs, ws4, lam, dt):
        """Rank-1 isometric-bending solve of one family (``XPBD.cpp:153-213``
        / classic ``PositionBasedDynamics.h:241``): ``t = Σⱼ Sⱼxⱼ``,
        ``C = −½|t|²``, ``∇ⱼC = −Sⱼt``. Returns ``(4 corrections, Δλ)``;
        Δλ is None for non-XPBD."""
        s = self.q_mat[fam]
        sj = [s[..., j, None] for j in range(4)]
        t = sj[0] * xs[0]
        for j in range(1, 4):
            t = t + sj[j] * xs[j]
        t2 = _sum3(t * t)[..., 0]
        energy = -0.5 * t2
        w_s2 = sum(ws4[j][..., 0] * s[..., j] * s[..., j] for j in range(4))
        sum_norm = w_s2 * t2
        zero = torch.zeros((), dtype=torch.float32, device=t.device)
        one = torch.ones((), dtype=torch.float32, device=t.device)
        stiffk = self.bend_stiff[fam]
        if self.xpbd_bending:
            alpha = torch.where(stiffk != 0.0, 1.0 / (stiffk * dt * dt), zero)
            kk = sum_norm + alpha
            valid = torch.abs(kk) > 1e-9
            dlam = torch.where(valid, -(energy + alpha * lam)
                               / torch.where(valid, kk, one), zero)
            lam_out = dlam
        else:
            valid = torch.abs(sum_norm) > 1e-9
            dlam = torch.where(valid, -stiffk * energy
                               / torch.where(valid, sum_norm, one), zero)
            lam_out = None
        dt_plane = dlam[..., None] * t
        return [-ws4[j] * sj[j] * dt_plane for j in range(4)], lam_out

    # -- Jacobi passes -------------------------------------------------------

    def _distance_pass(self, g, wg, lams, dt, omega):
        """One Jacobi pass of the 3 distance families."""
        hp = self.parity
        acc = torch.zeros_like(g)
        new_lams = {}
        for fam in _DIST_FAMILIES:
            pa, pb = self._dist_endpoints(g, fam, hp)
            wa, wb = self._dist_endpoints(wg, fam, hp)
            pt, dlam = self._dist_solve(fam, pa, pb, wa, wb, lams[fam], dt)
            new_lams[fam] = lams[fam] if dlam is None else lams[fam] + dlam
            self._scatter_dist(acc, fam, hp, wa * pt, -wb * pt)
        return g + omega * self.inv_cnt_dist * acc, new_lams

    def _bending_pass(self, g, wg, lams, dt, omega):
        """One Jacobi pass of the 3 isometric-bending families."""
        hp = self.parity
        acc = torch.zeros_like(g)
        new_lams = {}
        for fam in self.q_mat:
            xs, scatter = self._bend_points(g, fam, hp)
            ws4, _ = self._bend_points(wg, fam, hp)
            corr, dlam = self._bend_solve(fam, xs, ws4, lams[fam], dt)
            new_lams[fam] = lams[fam] if dlam is None else lams[fam] + dlam
            scatter(acc, corr)
        return g + omega * self.inv_cnt_bend * acc, new_lams

    # lattice colouring per family: constraints at lattice cells (i, j)
    # and (i', j') share a vertex iff |Δi| / |Δj| are within the family's
    # stencil reach, so (i mod a, j mod b) with (a, b) = reach+1 is an
    # exact colouring (SimulationModel.cpp:1033-1094 on the grid)
    _GS_COLORS = {"h": (1, 2), "v": (2, 1), "d": (2, 2),
                  "bh": (3, 2), "bv": (2, 3), "bd": (2, 2)}

    def _color_masks(self, shape, fam):
        a, b = self._GS_COLORS[fam]
        ii = torch.arange(shape[0], device=self.device)[:, None]
        jj = torch.arange(shape[1], device=self.device)[None, :]
        return [((ii % a == ca) & (jj % b == cb)).to(torch.float32)
                for ca in range(a) for cb in range(b)]

    def _block(self, x, inv_mass):
        h, w, o = self.height, self.width, self.offset
        lead = x.shape[:-2]
        g = x[..., o:o + h * w, :].reshape(*lead, h, w, 3)
        wg = inv_mass[..., o:o + h * w].reshape(*inv_mass.shape[:-1], h, w, 1)
        return g, wg

    def _unblock(self, x, g):
        h, w, o = self.height, self.width, self.offset
        flat = g.reshape(*g.shape[:-3], h * w, 3)
        if o == 0 and h * w == x.shape[-2]:
            return flat
        x = x.clone()
        x[..., o:o + h * w, :] = flat
        return x

    def project_gs(self, x: Tensor, inv_mass: Tensor, lams, dt
                   ) -> Tuple[Tensor, tuple]:
        """Colour-sequential Gauss-Seidel projection on the grid: per
        family, per lattice colour, solve from the current positions and
        apply the colour's vertex-disjoint corrections at once. The sweep
        order (families h, v, d, bh, bv, bd × lexicographic colours) is a
        valid Gauss-Seidel order, not the unstructured builder's greedy
        colouring."""
        g, wg = self._block(x, inv_mass)
        hp = self.parity
        dist_lams, bend_lams = dict(lams[0]), dict(lams[1])
        if self.has_distance:
            for fam in _DIST_FAMILIES:
                for cm in self._color_masks(dist_lams[fam].shape[-2:], fam):
                    pa, pb = self._dist_endpoints(g, fam, hp)
                    wa, wb = self._dist_endpoints(wg, fam, hp)
                    pt, dlam = self._dist_solve(
                        fam, pa, pb, wa, wb, dist_lams[fam], dt)
                    if dlam is not None:
                        dist_lams[fam] = dist_lams[fam] + dlam * cm
                    pt = pt * cm[..., None]
                    g = g + self._scatter_dist(
                        torch.zeros_like(g), fam, hp, wa * pt, -wb * pt)
        if self.has_bending:
            for fam in self.q_mat:
                for cm in self._color_masks(bend_lams[fam].shape[-2:], fam):
                    xs, scatter = self._bend_points(g, fam, hp)
                    ws4, _ = self._bend_points(wg, fam, hp)
                    corr, dlam = self._bend_solve(fam, xs, ws4,
                                                  bend_lams[fam], dt)
                    if dlam is not None:
                        bend_lams[fam] = bend_lams[fam] + dlam * cm
                    corr = [c * cm[..., None] for c in corr]
                    g = g + scatter(torch.zeros_like(g), corr)
        return self._unblock(x, g), (dist_lams, bend_lams)

    def project(self, x: Tensor, inv_mass: Tensor, lams, dt,
                omega: float = 1.0) -> Tuple[Tensor, tuple]:
        """Distance family pass, then bending family pass, on the grid
        block of ``x`` (Jacobi, averaged by the per-particle counts and
        scaled by ``omega``)."""
        g, wg = self._block(x, inv_mass)
        dist_lams, bend_lams = lams
        if self.has_distance:
            g, dist_lams = self._distance_pass(g, wg, dist_lams, dt, omega)
        if self.has_bending:
            g, bend_lams = self._bending_pass(g, wg, bend_lams, dt, omega)
        return self._unblock(x, g), (dist_lams, bend_lams)

    def to(self, device) -> "GridClothBatch":
        """The same batch with every tensor on ``device``."""
        def mv(d):
            return {k: v.to(device) for k, v in d.items()}
        return dataclasses.replace(
            self, rest=mv(self.rest), stiff=mv(self.stiff),
            q_mat=mv(self.q_mat), bend_stiff=mv(self.bend_stiff),
            inv_cnt_dist=self.inv_cnt_dist.to(device),
            inv_cnt_bend=self.inv_cnt_bend.to(device), parity=None)
