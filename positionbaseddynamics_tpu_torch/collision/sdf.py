"""Signed-distance fields — analytic shapes and dense grids.

Port of ``positionbaseddynamics_tpu/collision/sdf.py``, the reference's
implicit collision geometry (``Simulation/DistanceFieldCollisionDetection
.h:32-104``: Box, Sphere, Torus, Cylinder, HollowSphere, HollowBox) and its
cubic-grid SDF wrapper (``Simulation/CubicSDFCollisionDetection.h:14-42``).
The ``invert`` factor follows ``DistanceFieldCollisionDetection.cpp:
600-680``; analytic shapes take their exact gradients as normals, grids
the central difference of the interpolated field.

An :class:`SDFShape` is a frozen dataclass of tensors with a static
``kind``. Its parameters may carry leading axes: a stack of same-kind
shapes (:meth:`SDFShape.stack`) has ``params (M, P)``, and
:meth:`SDFShape.take` selects one shape per row of an index tensor, as
JAX's ``vmap`` over a stacked shape pytree does. ``distance`` and
``normal`` take points ``(*lead, *pts, 3)`` whose leading axes are the
parameters' leading axes; an unstacked shape broadcasts over any points.
A stacked grid keeps its values once, ``(M, nx, ny, nz)``, and a selection
records which grid each row reads (``grid_row``) rather than copying it.
Grid lookups index the flattened values with the same clamping as JAX.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.mathutils import dot3, sqrt_rn

Tensor = torch.Tensor

SPHERE = "sphere"
BOX = "box"
TORUS = "torus"
CYLINDER = "cylinder"
HOLLOW_SPHERE = "hollow_sphere"
HOLLOW_BOX = "hollow_box"
GRID = "grid"
GRID_CUBIC = "grid_cubic"
CSDF = "csdf"            # Discregrid 32-node serendipity cells (.csdf)
PLANE = "plane"

GRID_KINDS = (GRID, GRID_CUBIC, CSDF)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device, dtype=torch.float32
           ) -> Tensor:
    """A small constant tensor on ``device``, made once (a constant copied
    from the host inside a step makes the host wait for the card)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _norm(p: Tensor) -> Tensor:
    return sqrt_rn(dot3(p, p))


# ---------------------------------------------------------------------------
# Raw signed-distance functions (local frame, (..., 3) points); parameters
# broadcast against the points' leading axes
# ---------------------------------------------------------------------------


def sdf_sphere(p: Tensor, radius) -> Tensor:
    """``|p| - r`` (``DistanceFieldCollisionSphere::distance``)."""
    return _norm(p) - radius


def sdf_box(p: Tensor, half_extents) -> Tensor:
    """Exact box SDF (``DistanceFieldCollisionBox::distance``)."""
    d = torch.abs(p) - half_extents
    outside = _norm(torch.clamp_min(d, 0.0))
    inside = torch.clamp_max(torch.amax(d, dim=-1), 0.0)
    return outside + inside


def sdf_torus(p: Tensor, major_r, minor_r) -> Tensor:
    """Torus around the y axis (``DistanceFieldCollisionTorus::distance``)."""
    qx = sqrt_rn(p[..., 0] ** 2 + p[..., 2] ** 2) - major_r
    return sqrt_rn(qx ** 2 + p[..., 1] ** 2) - minor_r


def sdf_cylinder(p: Tensor, radius, half_height) -> Tensor:
    """Finite y-axis cylinder (``DistanceFieldCollisionCylinder::distance``;
    the reference stores ``m_dim = (radius, height/2)``)."""
    ln = sqrt_rn(p[..., 0] ** 2 + p[..., 2] ** 2)
    d0 = torch.abs(ln) - radius
    d1 = torch.abs(p[..., 1]) - half_height
    m0, m1 = torch.clamp_min(d0, 0.0), torch.clamp_min(d1, 0.0)
    outside = sqrt_rn(m0 * m0 + m1 * m1)
    inside = torch.clamp_max(torch.maximum(d0, d1), 0.0)
    return outside + inside


def sdf_hollow_sphere(p: Tensor, radius, thickness) -> Tensor:
    """``| |p|-r | - thickness`` (``DistanceFieldCollisionHollowSphere``)."""
    return torch.abs(_norm(p) - radius) - thickness


def sdf_hollow_box(p: Tensor, half_extents, thickness) -> Tensor:
    """``|box_sdf| - thickness`` (``DistanceFieldCollisionHollowBox``)."""
    return torch.abs(sdf_box(p, half_extents)) - thickness


def sdf_plane(p: Tensor, normal, offset) -> Tensor:
    """Half-space ``n·p - offset``."""
    return dot3(p, normal) - offset


def _normalize_or_zero(v: Tensor) -> Tensor:
    n2 = dot3(v, v)[..., None]
    return torch.where(n2 < 1e-12, torch.zeros_like(v),
                       v / sqrt_rn(torch.clamp_min(n2, 1e-30)))


def _box_gradient(p: Tensor, half) -> Tensor:
    """Exact gradient of :func:`sdf_box`: outside, the normalized
    positive-part vector (signed per axis); inside, ±1 on the axis of the
    largest ``d`` (the first of equal ones, as ``jnp.argmax``)."""
    d = torch.abs(p) - half
    outside = torch.any(d > 0.0, dim=-1, keepdim=True)
    g_out = _normalize_or_zero(torch.clamp_min(d, 0.0) * torch.sign(p))
    amax = torch.argmax(d, dim=-1, keepdim=True)
    onehot = torch.zeros_like(p).scatter_(-1, amax, 1.0)
    g_in = onehot * torch.sign(p)
    return torch.where(outside, g_out, g_in)


def _radial(p: Tensor, ln: Tensor) -> Tensor:
    z = torch.zeros_like(ln)
    r = (torch.stack([p[..., 0], z, p[..., 2]], -1)
         / torch.clamp_min(ln, 1e-30)[..., None])
    return torch.where(ln[..., None] < 1e-12, torch.zeros_like(r), r)


def _cylinder_gradient(p: Tensor, radius, half_height) -> Tensor:
    """Exact gradient of :func:`sdf_cylinder` (2-D box logic over
    (radial, axial))."""
    ln = sqrt_rn(p[..., 0] ** 2 + p[..., 2] ** 2)
    radial = _radial(p, ln)
    z = torch.zeros_like(ln)
    axial = torch.stack([z, torch.sign(p[..., 1]), z], -1)
    dr = ln - radius
    dy = torch.abs(p[..., 1]) - half_height
    g0, g1 = torch.clamp_min(dr, 0.0), torch.clamp_min(dy, 0.0)
    g2n = sqrt_rn(torch.clamp_min(g0 * g0 + g1 * g1, 1e-30))
    outside = (dr > 0.0) | (dy > 0.0)
    g_out = (g0[..., None] * radial + g1[..., None] * axial) / g2n[..., None]
    g_in = torch.where((dr > dy)[..., None], radial, axial)
    return torch.where(outside[..., None], g_out, g_in)


def _torus_gradient(p: Tensor, major_r, minor_r) -> Tensor:
    ln = sqrt_rn(p[..., 0] ** 2 + p[..., 2] ** 2)
    radial = _radial(p, ln)
    qx = ln - major_r
    qy = p[..., 1]
    qn = sqrt_rn(torch.clamp_min(qx * qx + qy * qy, 1e-30))
    z = torch.zeros_like(ln)
    up = torch.stack([z, torch.ones_like(ln), z], -1)
    g = (qx[..., None] * radial + qy[..., None] * up) / qn[..., None]
    return torch.where((qx * qx + qy * qy)[..., None] < 1e-12,
                       torch.zeros_like(g), g)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SDFShape:
    """One collision geometry: a static ``kind`` plus parameter tensors.
    ``invert`` flips inside/outside (scene-format ``invertSDF``). For the
    grid kinds the field lives in ``grid_values`` over a box starting at
    ``grid_origin`` with ``grid_inv_cell`` cells per unit; ``grid_row``
    (None for one shape) says which grid of a stack each row reads."""

    kind: str
    params: Tensor = None          # (*lead, P); (*lead, 32, 3) for CSDF
    invert: Tensor = None          # (*lead,) +1/-1
    grid_values: Tensor = None     # (nx, ny, nz) or a stack (M, ...)
    grid_origin: Tensor = None     # (*lead, 3)
    grid_inv_cell: Tensor = None   # (*lead, 3)
    grid_row: Optional[Tensor] = None   # (*lead,) int64 into the stack

    @staticmethod
    def sphere(radius, invert=False) -> "SDFShape":
        return _shape(SPHERE, [radius], invert)

    @staticmethod
    def box(half_extents, invert=False) -> "SDFShape":
        return _shape(BOX, list(half_extents), invert)

    @staticmethod
    def torus(major_r, minor_r, invert=False) -> "SDFShape":
        return _shape(TORUS, [major_r, minor_r], invert)

    @staticmethod
    def cylinder(radius, height, invert=False) -> "SDFShape":
        return _shape(CYLINDER, [radius, 0.5 * height], invert)

    @staticmethod
    def hollow_sphere(radius, thickness, invert=False) -> "SDFShape":
        return _shape(HOLLOW_SPHERE, [radius, thickness], invert)

    @staticmethod
    def hollow_box(half_extents, thickness, invert=False) -> "SDFShape":
        return _shape(HOLLOW_BOX, list(half_extents) + [thickness], invert)

    @staticmethod
    def plane(normal=(0.0, 1.0, 0.0), offset=0.0, invert=False) -> "SDFShape":
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        return _shape(PLANE, list(n) + [offset], invert)

    @staticmethod
    def grid(values, origin, extent, invert=False, order=1) -> "SDFShape":
        """Dense-grid SDF. ``order=1`` → trilinear; ``order=3`` → separable
        cubic Lagrange on a 4×4×4 stencil (``sdf.py:202-225``)."""
        if order not in (1, 3):
            raise ValueError(f"grid SDF order must be 1 or 3, got {order}")
        values = np.asarray(values, np.float32)
        origin = np.asarray(origin, np.float32)
        extent = np.asarray(extent, np.float32)
        cells = np.asarray(values.shape, np.float32) - 1.0
        return SDFShape(
            kind=GRID if order == 1 else GRID_CUBIC,
            params=torch.zeros((1,), dtype=torch.float32),
            invert=torch.tensor(-1.0 if invert else 1.0),
            grid_values=torch.as_tensor(values),
            grid_origin=torch.as_tensor(origin),
            grid_inv_cell=torch.as_tensor(cells / extent))

    @staticmethod
    def from_csdf(path, invert=False, scale=1.0) -> "SDFShape":
        """Load a Discregrid ``.csdf`` cubic SDF as shipped
        (``sdf.py:227-245``); ``scale`` scales domain and distances."""
        from .csdf import load_csdf

        data = load_csdf(path)
        s = float(scale)
        return SDFShape(
            kind=CSDF,
            params=torch.as_tensor(data["node_xi"]),
            invert=torch.tensor(-1.0 if invert else 1.0),
            grid_values=torch.as_tensor(data["cell_values"] * s),
            grid_origin=torch.as_tensor(
                np.asarray(data["domain_min"] * s, np.float32)),
            grid_inv_cell=torch.as_tensor(
                np.asarray(1.0 / (data["cell_size"] * s), np.float32)))

    # -- tensors ------------------------------------------------------------

    def to(self, device) -> "SDFShape":
        """The same shape with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), Tensor)})

    @property
    def n_lead(self) -> int:
        """Leading (stack or selection) axes of the parameters."""
        return self.params.dim() - (2 if self.kind == CSDF else 1)

    @staticmethod
    def stack(shapes) -> "SDFShape":
        """Same-kind shapes stacked along a new leading axis (the batched
        narrow phase's per-kind group, ``batched.py:68-70``)."""
        first = shapes[0]
        out = {"kind": first.kind}
        for name in ("params", "invert", "grid_origin", "grid_inv_cell"):
            if getattr(first, name) is not None:
                out[name] = torch.stack([getattr(s, name) for s in shapes])
        if first.grid_values is not None:
            out["grid_values"] = torch.stack([s.grid_values for s in shapes])
            out["grid_row"] = torch.arange(len(shapes),
                                           device=first.params.device)
        return SDFShape(**out)

    def take(self, idx: Tensor) -> "SDFShape":
        """The shapes of a stack at ``idx`` (any shape): parameters
        gathered, grid values shared through ``grid_row``."""
        out = {}
        for name in ("params", "invert", "grid_origin", "grid_inv_cell",
                     "grid_row"):
            t = getattr(self, name)
            if t is not None:
                out[name] = t[idx]
        return dataclasses.replace(self, **out)

    def _bc(self, t: Tensor, p: Tensor, tail: int) -> Tensor:
        """``t (*lead, *tail)`` viewed to broadcast against points ``p
        (*lead, *pts, 3)``."""
        lead = self.n_lead
        pts = p.dim() - 1 - lead
        if lead == 0:
            return t
        shape = tuple(t.shape[:lead]) + (1,) * pts + tuple(
            t.shape[t.dim() - tail:] if tail else ())
        return t.reshape(shape)

    def _s(self, p: Tensor, k: int) -> Tensor:
        """Scalar parameter ``k`` against ``p[..., 0]``."""
        return self._bc(self.params[..., k], p, 0)

    def _v(self, p: Tensor, lo: int, hi: int) -> Tensor:
        """Vector parameters ``lo:hi`` against ``p``."""
        return self._bc(self.params[..., lo:hi], p, 1)

    def _grid_args(self, p: Tensor):
        row = None if self.grid_row is None else self._bc(self.grid_row, p, 0)
        return (self._bc(self.grid_origin, p, 1),
                self._bc(self.grid_inv_cell, p, 1), row)

    # -- evaluation ---------------------------------------------------------

    def distance(self, p: Tensor) -> Tensor:
        """Signed distance of local-frame points ``(*lead, *pts, 3)``."""
        k = self.kind
        if k == SPHERE:
            d = sdf_sphere(p, self._s(p, 0))
        elif k == BOX:
            d = sdf_box(p, self._v(p, 0, 3))
        elif k == TORUS:
            d = sdf_torus(p, self._s(p, 0), self._s(p, 1))
        elif k == CYLINDER:
            d = sdf_cylinder(p, self._s(p, 0), self._s(p, 1))
        elif k == HOLLOW_SPHERE:
            d = sdf_hollow_sphere(p, self._s(p, 0), self._s(p, 1))
        elif k == HOLLOW_BOX:
            d = sdf_hollow_box(p, self._v(p, 0, 3), self._s(p, 3))
        elif k == PLANE:
            d = sdf_plane(p, self._v(p, 0, 3), self._s(p, 3))
        elif k == GRID:
            o, ic, row = self._grid_args(p)
            d = grid_trilinear(self.grid_values, o, ic, p, row=row)
        elif k == GRID_CUBIC:
            o, ic, row = self._grid_args(p)
            d = grid_cubic_lagrange(self.grid_values, o, ic, p, row=row)
        elif k == CSDF:
            o, ic, row = self._grid_args(p)
            xi = self._bc(self.params, p, 2)
            d = csdf_serendipity(self.grid_values, o, ic, xi, p, row=row)
        else:  # pragma: no cover
            raise ValueError(f"unknown SDF kind {k!r}")
        return self._bc(self.invert, p, 0) * d

    def normal(self, p: Tensor, eps: float = 1.0e-4) -> Tensor:
        """Outward normal (normalized SDF gradient), zero where
        degenerate: the exact gradients of the analytic shapes, the
        central difference of the field for grids (``sdf.py:275-313``)."""
        k = self.kind
        if k == SPHERE:
            g = _normalize_or_zero(p)
        elif k == BOX:
            g = _box_gradient(p, self._v(p, 0, 3))
        elif k == PLANE:
            g = self._v(p, 0, 3).expand(p.shape)
        elif k == CYLINDER:
            g = _cylinder_gradient(p, self._s(p, 0), self._s(p, 1))
        elif k == TORUS:
            g = _torus_gradient(p, self._s(p, 0), self._s(p, 1))
        elif k == HOLLOW_SPHERE:
            s = torch.sign(_norm(p) - self._s(p, 0))[..., None]
            g = s * _normalize_or_zero(p)
        elif k == HOLLOW_BOX:
            half = self._v(p, 0, 3)
            s = torch.sign(sdf_box(p, half))[..., None]
            g = s * _box_gradient(p, half)
        else:
            offs = _offsets(eps, p.device)
            q = p[..., None, :]
            dp = self.distance(q + offs)                  # (..., 3)
            dm = self.distance(q - offs)
            g = (dp - dm) / (2.0 * eps)
            n2 = dot3(g, g)[..., None]
            return torch.where(n2 < 1e-12, torch.zeros_like(g),
                               g / sqrt_rn(torch.clamp_min(n2, 1e-30)))
        return self._bc(self.invert, p, 0)[..., None] * g


@functools.lru_cache(maxsize=None)
def _offsets(eps: float, device: torch.device) -> Tensor:
    """``eye(3) · eps`` in float32, as ``jnp.eye(3, dtype) * eps``."""
    return torch.eye(3, dtype=torch.float32, device=device) * eps


def shape_bounding_radius(shape: SDFShape) -> float:
    """Conservative bounding-sphere radius of a shape about its local
    origin, the broad-phase reject radius (``sdf.py:315-352``); ``inf``
    for inverted shapes and planes, which are never pruned."""
    if float(shape.invert) < 0:
        return float("inf")
    p = shape.params.detach().cpu().numpy().astype(np.float64)
    k = shape.kind
    if k == SPHERE:
        return float(p[0])
    if k == BOX:
        return float(np.linalg.norm(p[:3]))
    if k == TORUS:
        return float(p[0] + p[1])
    if k == CYLINDER:
        return float(np.hypot(p[0], p[1]))
    if k == HOLLOW_SPHERE:
        return float(p[0] + p[1])
    if k == HOLLOW_BOX:
        return float(np.linalg.norm(p[:3]) + p[3])
    if k == PLANE:
        return float("inf")
    if k in GRID_KINDS:
        o = shape.grid_origin.detach().cpu().numpy().astype(np.float64)
        shp = np.asarray(shape.grid_values.shape[:3], np.float64)
        if k != CSDF:
            shp = shp - 1.0          # node grids: cells = nodes − 1
        ext = shp / shape.grid_inv_cell.detach().cpu().numpy().astype(
            np.float64)
        corners = o[None] + ext[None] * np.stack(
            np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
            -1).reshape(-1, 3)
        return float(np.linalg.norm(corners, axis=1).max())
    return float("inf")


def _shape(kind, params, invert) -> SDFShape:
    return SDFShape(
        kind=kind,
        params=torch.as_tensor(np.asarray(params, np.float32)),
        invert=torch.tensor(-1.0 if invert else 1.0))


# ---------------------------------------------------------------------------
# Dense-grid interpolation
# ---------------------------------------------------------------------------


def _dims(values: Tensor, row) -> tuple:
    """The grid's node (or cell) counts: a stack's trailing three axes."""
    return tuple(values.shape[-3:] if values.dim() == 3 or row is None
                 else values.shape[1:4])


def _upper(dims, minus: float, device) -> Tensor:
    """``float32(dims) − minus`` in float32, as JAX's clip bound."""
    return _const(tuple(float(v) for v in np.asarray(dims, np.float32)
                        - np.float32(minus)), device)


def _flat_index(dims, row, i, j, k) -> Tensor:
    """Index into the flattened values (of the stack when ``row``)."""
    nx, ny, nz = dims
    flat = (i * ny + j) * nz + k
    if row is not None:
        flat = flat + row * (nx * ny * nz)
    return flat


def _gather(values: Tensor, flat: Tensor, tail: int = 0) -> Tensor:
    """``values`` (flattened over its grid axes) at ``flat``; ``tail``
    trailing axes of ``values`` are kept."""
    if tail:
        v = values.reshape(-1, *values.shape[values.dim() - tail:])
    else:
        v = values.reshape(-1)
    return v[flat]


def grid_trilinear(values: Tensor, origin: Tensor, inv_cell: Tensor,
                   p: Tensor, row: Optional[Tensor] = None) -> Tensor:
    """Trilinear interpolation of a dense SDF grid at points ``(..., 3)``;
    points outside the grid clamp to its boundary (``sdf.py:367-398``).
    ``row`` selects the grid of a stack per point."""
    dims = _dims(values, row)
    u = (p - origin) * inv_cell
    u = torch.minimum(torch.clamp_min(u, 0.0),
                      _upper(dims, 1.000001, p.device))
    i0f = torch.floor(u)
    i0 = i0f.to(torch.int64)
    f = u - i0f
    i1 = torch.minimum(i0 + 1, _const(tuple(d - 1 for d in dims), p.device,
                                      torch.int64))

    def g(a, b, c):
        return _gather(values, _flat_index(dims, row, a[..., 0], b[..., 1],
                                           c[..., 2]))

    c000 = g(i0, i0, i0)
    c100 = g(i1, i0, i0)
    c010 = g(i0, i1, i0)
    c110 = g(i1, i1, i0)
    c001 = g(i0, i0, i1)
    c101 = g(i1, i0, i1)
    c011 = g(i0, i1, i1)
    c111 = g(i1, i1, i1)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _lagrange_weights_4(f: Tensor) -> Tensor:
    """Cubic Lagrange basis on nodes {-1, 0, 1, 2} at ``f`` in [0, 1]
    (``sdf.py:401-414``); ``(..., 4)`` weights that sum to 1."""
    fm1 = f + 1.0
    f1 = f - 1.0
    f2 = f - 2.0
    w0 = f * f1 * f2 * (-1.0 / 6.0)
    w1 = fm1 * f1 * f2 * 0.5
    w2 = fm1 * f * f2 * (-0.5)
    w3 = fm1 * f * f1 * (1.0 / 6.0)
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _sum_last(a: Tensor) -> Tensor:
    """Sum over the trailing axis, left to right."""
    out = a[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i]
    return out


def csdf_serendipity(cell_values: Tensor, origin: Tensor, inv_cell: Tensor,
                     node_xi: Tensor, p: Tensor,
                     row: Optional[Tensor] = None) -> Tensor:
    """A Discregrid cubic SDF at points ``(..., 3)`` by the file's own
    32-node serendipity cells (``sdf.py:417-438``); queries outside the
    domain clamp to the boundary cell."""
    from .csdf import serendipity_basis

    dims = _dims(cell_values[..., 0], row)
    u = (p - origin) * inv_cell
    u = torch.minimum(torch.clamp_min(u, 0.0), _upper(dims, 1e-6, p.device))
    ijkf = torch.floor(u)
    ijk = torch.minimum(ijkf.to(torch.int64),
                        _const(tuple(d - 1 for d in dims), p.device,
                               torch.int64))
    xi = 2.0 * (u - ijk) - 1.0
    vals = _gather(cell_values, _flat_index(dims, row, ijk[..., 0],
                                            ijk[..., 1], ijk[..., 2]), 1)
    n = serendipity_basis(xi, node_xi)
    return torch.sum(vals * n, dim=-1)


def grid_cubic_lagrange(values: Tensor, origin: Tensor, inv_cell: Tensor,
                        p: Tensor, row: Optional[Tensor] = None) -> Tensor:
    """Separable tricubic Lagrange interpolation of a dense SDF grid at
    points ``(..., 3)`` (``sdf.py:441-472``): the 4×4×4 stencil's indices
    clamp at the boundary; contracted z, then y, then x."""
    dims = _dims(values, row)
    u = (p - origin) * inv_cell
    u = torch.minimum(torch.clamp_min(u, 0.0),
                      _upper(dims, 1.000001, p.device))
    i0f = torch.floor(u)
    i0 = i0f.to(torch.int64)
    f = u - i0f
    wx = _lagrange_weights_4(f[..., 0])
    wy = _lagrange_weights_4(f[..., 1])
    wz = _lagrange_weights_4(f[..., 2])
    offs = _const((-1, 0, 1, 2), p.device, torch.int64)
    ix = torch.clamp(i0[..., 0, None] + offs, 0, dims[0] - 1)
    iy = torch.clamp(i0[..., 1, None] + offs, 0, dims[1] - 1)
    iz = torch.clamp(i0[..., 2, None] + offs, 0, dims[2] - 1)
    r = None if row is None else row[..., None, None, None]
    cube = _gather(values, _flat_index(
        dims, r, ix[..., :, None, None], iy[..., None, :, None],
        iz[..., None, None, :]))
    cz = _sum_last(cube * wz[..., None, None, :])
    cy = _sum_last(cz * wy[..., None, :])
    return _sum_last(cy * wx)
