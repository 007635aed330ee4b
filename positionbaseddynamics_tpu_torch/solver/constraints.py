"""Typed constraint batches and the set that holds them.

Port of ``positionbaseddynamics_tpu/solver/constraints.py``: one
struct-of-arrays batch per constraint family, holding ``idx (C, k)``
particle indices and per-constraint parameters, built on the host in
numpy (``create``) and frozen to tensors. The stepper projects a whole
family at once: gather, the batched op of ``ops/``, scatter-add with
``index_add_`` along the particle axis. In ``jacobi`` mode the summed
corrections are divided by the number of constraints at each particle
(``ConstraintSet.with_jacobi_counts``, computed at build time); in
``gauss_seidel`` mode the greedy colours (``solver/coloring.py``) are
solved one after another, each colour free of shared particles.

Ported: the nine particle batches (``:280-816``), ``scatter_add``,
``PARTICLE_BATCH_ORDER`` and ``ConstraintSet`` with the structured grid
cloths and tet grids. JAX's build-time scatter plan (``make_scatter_plan``)
was a workaround for the TPU's scatter and has no counterpart. The rigid
joints are ``solver/joints.py``'s ``JointBatch`` (slice 6a), held in
``ConstraintSet.joints``; the rod, ghost-rod and generic batches, the
stiff rods and ``GenericRigidBatch`` come with slice 7.

XPBD multipliers λ live in a per-batch tensor created at the start of
every projection, the reference's reset at iteration 0
(``Constraints.cpp:1240-1241``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops import pbd, xpbd
from ..ops.mathutils import EPS
from .coloring import greedy_color

Tensor = torch.Tensor


def scatter_add(n: int, idx: Tensor, corr: Tensor) -> Tensor:
    """Per-constraint corrections ``corr (..., C, k, d)`` added at the
    particle indices ``idx (C, k)`` into zeros ``(..., n, d)``, in row
    order on the CPU (``constraints.py:51-57``). As JAX's ``mode="drop"``
    after numpy's wrap: an index in ``[-n, 0)`` counts from the end, one
    outside ``[-n, n)`` is dropped."""
    flat = idx.reshape(-1).long()
    flat = torch.where(flat < 0, flat + n, flat)
    valid = (flat >= 0) & (flat < n)
    src = corr.reshape(*corr.shape[:-3], -1, corr.shape[-1])
    src = torch.where(valid[:, None], src, torch.zeros_like(src))
    return _index_add(n, torch.where(valid, flat, torch.zeros_like(flat)),
                      src)


def _index_add(n: int, flat: Tensor, src: Tensor) -> Tensor:
    """``src (..., R, d)`` added at the in-range indices ``flat (R,)`` into
    zeros ``(..., n, d)``."""
    out = torch.zeros(*src.shape[:-2], n, src.shape[-1], dtype=src.dtype,
                      device=src.device)
    return out.index_add_(-2, flat, src)


def _counts(n: int, idx: np.ndarray) -> np.ndarray:
    """Constraints touching each of ``n`` items, at least 1 (the Jacobi
    averaging denominator, ``constraints.py:134-138``)."""
    c = np.zeros((n,), np.float32)
    np.add.at(c, np.asarray(idx).reshape(-1), 1.0)
    return np.maximum(c, 1.0)


def _f32(x, shape, dev) -> Tensor:
    return torch.tensor(np.broadcast_to(np.asarray(x, np.float32), shape),
                        device=dev)


def _isometric_weights_np(p: np.ndarray):
    """The cotangent weights ``K (C, 4)`` of isometric bending in the
    internal (p2, p3, p0, p1) order and ``3/(2(A₀ + A₁))``, in float64
    (``XPBD.cpp:112-150``; ``constraints.py:148-197``). ``p (C, 4, 3)`` in
    (p0, p1, p2, p3) stencil order."""
    p = np.asarray(p, np.float64)
    x0, x1, x2, x3 = p[:, 2], p[:, 3], p[:, 0], p[:, 1]  # internal order
    e0, e1, e2 = x1 - x0, x2 - x0, x3 - x0
    e3, e4 = x2 - x1, x3 - x1

    def cot(v, w):
        cos_t = np.einsum("cd,cd->c", v, w)
        sin_t = np.linalg.norm(np.cross(v, w), axis=-1)
        return cos_t / np.maximum(sin_t, 1e-12)

    c01, c02 = cot(e0, e1), cot(e0, e2)
    c03, c04 = cot(-e0, e3), cot(-e0, e4)
    a0 = 0.5 * np.linalg.norm(np.cross(e0, e1), axis=-1)
    a1 = 0.5 * np.linalg.norm(np.cross(e0, e2), axis=-1)
    k = np.stack([c03 + c04, c01 + c02, -c01 - c03, -c02 - c04], axis=1)
    return k, 3.0 / (2.0 * (a0 + a1))


def _init_isometric_bending_np(p: np.ndarray) -> np.ndarray:
    """Batched Q matrices ``Q = −c·K Kᵀ`` of isometric bending, the math of
    ``ops.xpbd.init_isometric_bending``. Returns ``(C, 4, 4)``."""
    k, c = _isometric_weights_np(p)
    return ((-c)[:, None, None]
            * np.einsum("ci,cj->cij", k, k)).astype(np.float32)


def _init_isometric_bending_s_np(p: np.ndarray) -> np.ndarray:
    """Rank-1 factor of the isometric-bending Hessian: the reference's
    ``Q(j,k) = coef·K[j]·K[k]`` (``XPBD.cpp:136-148``) is exactly
    ``Q = −S Sᵀ`` with ``S = K·√(−coef)``. Returns ``S (C, 4)`` in the
    solver's internal (p2, p3, p0, p1) index order."""
    k, c = _isometric_weights_np(p)
    return (np.sqrt(c)[:, None] * k).astype(np.float32)


def _inv_rest(rest: np.ndarray, dim: int) -> np.ndarray:
    """Inverse rest matrices, 0 where ``|det| < 1e-12``."""
    det = np.linalg.det(rest)
    bad = np.abs(det) < 1e-12
    rest[bad] = np.eye(dim)
    inv = np.linalg.inv(rest)
    inv[bad] = 0.0
    return inv.astype(np.float32)


def _init_fem_triangle_np(p: np.ndarray):
    """Rest area and inverse 2×2 rest matrix in the triangle's in-plane
    basis (axis1 = normalised p1−p0, axis2 = n×axis1;
    ``PositionBasedDynamics.cpp:808-840``, ``constraints.py:200-225``).
    ``p (C, 3, 3)``. Returns ``(area (C,), inv_rest_mat (C, 2, 2))``."""
    p = np.asarray(p, np.float64)
    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
    normal = np.cross(p1 - p0, p2 - p0)
    area = 0.5 * np.linalg.norm(normal, axis=-1)
    a1 = p1 - p0
    a1 = a1 / np.maximum(np.linalg.norm(a1, axis=-1, keepdims=True), 1e-12)
    a2 = np.cross(normal, a1)
    a2 = a2 / np.maximum(np.linalg.norm(a2, axis=-1, keepdims=True), 1e-12)

    def proj(v):
        return np.stack([(v * a2).sum(-1), (v * a1).sum(-1)], axis=-1)

    rest = np.stack([proj(p0 - p2), proj(p1 - p2)], axis=-1)  # (C, 2, 2)
    return area.astype(np.float32), _inv_rest(rest, 2)


def _init_strain_triangle_np(p: np.ndarray) -> np.ndarray:
    """Inverse 2×2 rest matrix from the x/y components of (p1−p0, p2−p0),
    the reference's planar convention (``PositionBasedDynamics.cpp:
    562-588``, ``constraints.py:228-243``). ``p (C, 3, 3)`` → ``(C, 2,
    2)``."""
    p = np.asarray(p, np.float64)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    return _inv_rest(np.stack([e1[:, :2], e2[:, :2]], axis=-1), 2)


def _init_strain_tetra_np(p: np.ndarray) -> np.ndarray:
    """Inverse 3×3 rest matrix with columns (p1−p0, p2−p0, p3−p0)
    (``PositionBasedDynamics.cpp:691-708``, ``constraints.py:246-258``).
    ``p (C, 4, 3)`` → ``(C, 3, 3)``."""
    p = np.asarray(p, np.float64)
    rest = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0],
                     p[:, 3] - p[:, 0]], axis=-1)
    return _inv_rest(rest, 3)


def _static(default=dataclasses.MISSING):
    """A field that is not a tensor: copied as it is by ``to`` and by the
    colour subsets."""
    return field(default=default, metadata=dict(static=True))


class _ParticleBatch:
    """What the particle batches share: the index gather, the colour
    subsets, ``to(device)`` and λ. ``has_lambda`` says whether
    ``init_lambda`` gives one λ a row (as JAX's ``init_lambda``);
    ``self_averaged`` batches take no Jacobi count division."""

    has_lambda = True
    self_averaged = False

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def n_rows(self) -> int:
        return self.idx.shape[0]

    def _tensor_fields(self):
        return [f.name for f in dataclasses.fields(self)
                if not f.metadata.get("static")]

    def init_lambda(self) -> Tensor:
        return torch.zeros((self.n_rows if self.has_lambda else 0,),
                           dtype=torch.float32, device=self.device)

    def to(self, device):
        """The same batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in self._tensor_fields()})

    def take(self, rows: Tensor):
        """The batch of the constraint rows ``rows`` (a long tensor on the
        batch's device)."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).index_select(0, rows)
            for k in self._tensor_fields()})

    def color_subsets(self):
        """``[(rows, sub-batch)]`` of each colour in colour order, the
        rows as a long tensor on the batch's device: made once, on the
        host, when a step function is built (``step.py:79-111``)."""
        color = self.color.cpu().numpy()
        out = []
        for col in range(self.num_colors):
            rows = torch.tensor(np.nonzero(color == col)[0],
                                dtype=torch.int64, device=self.device)
            out.append((rows, self.take(rows)))
        return out

    def gather(self, x: Tensor, inv_mass: Tensor):
        """``(p (..., C, k, 3), w (..., C, k))``: positions and inverse
        masses at ``idx``, with the leading rollout axes of ``x`` and
        ``inv_mass``."""
        flat = self.idx.reshape(-1)
        p = x.index_select(-2, flat).unflatten(-2, tuple(self.idx.shape))
        w = inv_mass.index_select(-1, flat).unflatten(
            -1, tuple(self.idx.shape))
        return p, w

    def _columns(self, x, inv_mass):
        """``[p0, w0, p1, w1, ...]`` of the gathered rows."""
        p, w = self.gather(x, inv_mass)
        out = []
        for i in range(self.idx.shape[1]):
            out += [p[..., i, :], w[..., i]]
        return out


def _index(idx, width, dev) -> Tuple[np.ndarray, Tensor]:
    idx = np.asarray(idx, np.int32).reshape(-1, width)
    return idx, torch.tensor(idx, dtype=torch.int64, device=dev)


def _colors(idx: np.ndarray, dev):
    color, num_colors = greedy_color(idx)
    return torch.tensor(color, device=dev), num_colors


@dataclass(frozen=True)
class DistanceBatch(_ParticleBatch):
    """XPBD or classic distance constraints over particle pairs, the
    batched ``DistanceConstraint_XPBD`` (``Constraints.cpp:1227-1258``) or,
    with ``xpbd=False``, the [0, 1]-stiffness kernel
    (``PositionBasedDynamics.cpp:13``)."""

    idx: Tensor            # (C, 2) int64
    rest_length: Tensor    # (C,)
    stiffness: Tensor      # (C,)
    color: Tensor          # (C,) int32
    num_colors: int = _static()
    xpbd: bool = _static()

    k = 2

    @staticmethod
    def create(idx, rest_length, stiffness, xpbd_mode: bool = True,
               device=None) -> "DistanceBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 2, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        return DistanceBatch(idx=t_idx,
                             rest_length=_f32(rest_length, (c,), dev),
                             stiffness=_f32(stiffness, (c,), dev),
                             color=color, num_colors=num_colors,
                             xpbd=bool(xpbd_mode))

    def solve(self, x, inv_mass, lam, dt):
        """Returns ``(corr (..., C, 2, 3), new_lam)``."""
        cols = self._columns(x, inv_mass)
        if self.xpbd:
            return xpbd.solve_distance(*cols, self.rest_length,
                                       self.stiffness, dt, lam)
        return pbd.solve_distance(*cols, self.rest_length,
                                  self.stiffness), lam


@dataclass(frozen=True)
class IsometricBendingBatch(_ParticleBatch):
    """Isometric bending over interior-edge stencils, the batched
    ``IsometricBendingConstraint_XPBD`` (``XPBD.cpp:112-213``) or its
    classic form; ``idx`` is (p0, p1, p2, p3) with (p2, p3) the shared
    edge."""

    idx: Tensor        # (C, 4)
    q_mat: Tensor      # (C, 4, 4) precomputed Hessian Q
    stiffness: Tensor  # (C,)
    color: Tensor
    num_colors: int = _static()
    xpbd: bool = _static()

    k = 4

    @staticmethod
    def create(idx, x0, stiffness, xpbd_mode: bool = True,
               device=None) -> "IsometricBendingBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 4, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        q_mat = _init_isometric_bending_np(np.asarray(x0)[idx])
        return IsometricBendingBatch(
            idx=t_idx, q_mat=torch.tensor(q_mat, device=dev),
            stiffness=_f32(stiffness, (c,), dev), color=color,
            num_colors=num_colors, xpbd=bool(xpbd_mode))

    def solve(self, x, inv_mass, lam, dt):
        cols = self._columns(x, inv_mass)
        if self.xpbd:
            return xpbd.solve_isometric_bending(*cols, self.q_mat,
                                                self.stiffness, dt, lam)
        return pbd.solve_isometric_bending(*cols, self.q_mat,
                                           self.stiffness), lam


@dataclass(frozen=True)
class DihedralBatch(_ParticleBatch):
    """Classic dihedral-angle bending (``PositionBasedDynamics.cpp``);
    ``idx`` (p0, p1, p2, p3) with (p2, p3) the shared edge, the rest angle
    from the initial configuration."""

    idx: Tensor         # (C, 4)
    rest_angle: Tensor  # (C,)
    stiffness: Tensor   # (C,)
    color: Tensor
    num_colors: int = _static()

    k = 4

    @staticmethod
    def create(idx, x0, stiffness, device=None) -> "DihedralBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 4, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        # float32 numpy, as constraints.py:402-412
        x0 = np.asarray(x0, np.float32)
        p0, p1, p2, p3 = (x0[idx[:, i]] for i in range(4))
        n1 = np.cross(p2 - p0, p3 - p0)
        n1 /= np.maximum((n1 * n1).sum(-1, keepdims=True), 1e-24)
        n2 = np.cross(p3 - p1, p2 - p1)
        n2 /= np.maximum((n2 * n2).sum(-1, keepdims=True), 1e-24)
        n1u = n1 / np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True),
                              1e-12)
        n2u = n2 / np.maximum(np.linalg.norm(n2, axis=-1, keepdims=True),
                              1e-12)
        rest = np.arccos(np.clip((n1u * n2u).sum(-1), -1.0, 1.0))
        return DihedralBatch(idx=t_idx, rest_angle=_f32(rest, (c,), dev),
                             stiffness=_f32(stiffness, (c,), dev),
                             color=color, num_colors=num_colors)

    def solve(self, x, inv_mass, lam, dt):
        return pbd.solve_dihedral(*self._columns(x, inv_mass),
                                  self.rest_angle, self.stiffness), lam


@dataclass(frozen=True)
class VolumeBatch(_ParticleBatch):
    """Tetrahedral volume conservation, the batched
    ``VolumeConstraint_XPBD`` (``XPBD.cpp:63-109``) or its classic form."""

    idx: Tensor          # (C, 4)
    rest_volume: Tensor  # (C,)
    stiffness: Tensor    # (C,)
    color: Tensor
    num_colors: int = _static()
    xpbd: bool = _static()

    k = 4

    @staticmethod
    def create(idx, x0, stiffness, xpbd_mode: bool = True,
               device=None) -> "VolumeBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 4, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        x0 = np.asarray(x0, np.float64)
        p0, p1, p2, p3 = (x0[idx[:, i]] for i in range(4))
        rest = np.einsum("cd,cd->c", np.cross(p1 - p0, p2 - p0),
                         p3 - p0) / 6.0
        return VolumeBatch(idx=t_idx, rest_volume=_f32(rest, (c,), dev),
                           stiffness=_f32(stiffness, (c,), dev),
                           color=color, num_colors=num_colors,
                           xpbd=bool(xpbd_mode))

    def solve(self, x, inv_mass, lam, dt):
        cols = self._columns(x, inv_mass)
        if self.xpbd:
            return xpbd.solve_volume(*cols, self.rest_volume,
                                     self.stiffness, dt, lam)
        return pbd.solve_volume(*cols, self.rest_volume,
                                self.stiffness), lam


@dataclass(frozen=True)
class FEMTetraBatch(_ParticleBatch):
    """FEM tets (St. Venant–Kirchhoff, inversion-safe): the batched
    ``XPBD_FEMTetConstraint`` (``XPBD.cpp:217-294``) when ``xpbd``, else
    the classic ``FEMTetConstraint`` (``PositionBasedDynamics.cpp:
    1109-1170``). Both energies are computed and a tet of volume ≤ 0 takes
    the SVD one."""

    idx: Tensor            # (C, 4)
    rest_volume: Tensor    # (C,)
    inv_rest_mat: Tensor   # (C, 3, 3)
    youngs: Tensor         # (C,)
    poisson: Tensor        # (C,)
    color: Tensor
    num_colors: int = _static()
    xpbd: bool = _static(True)

    k = 4

    @staticmethod
    def create(idx, x0, youngs, poisson, xpbd_mode: bool = True,
               device=None) -> "FEMTetraBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 4, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        x0 = np.asarray(x0, np.float64)
        p0, p1, p2, p3 = (x0[idx[:, i]] for i in range(4))
        rest = np.abs(np.einsum("cd,cd->c", np.cross(p1 - p0, p2 - p0),
                                p3 - p0) / 6.0)
        # D_m columns are the edges pᵢ − p3 (XPBD::init_FEMTetraConstraint)
        inv_rest = np.linalg.inv(np.stack([p0 - p3, p1 - p3, p2 - p3],
                                          axis=-1))
        return FEMTetraBatch(
            idx=t_idx, rest_volume=_f32(rest, (c,), dev),
            inv_rest_mat=_f32(inv_rest, (c, 3, 3), dev),
            youngs=_f32(youngs, (c,), dev), poisson=_f32(poisson, (c,), dev),
            color=color, num_colors=num_colors, xpbd=bool(xpbd_mode))

    def solve(self, x, inv_mass, lam, dt):
        cols = self._columns(x, inv_mass)
        if not self.xpbd:
            return pbd.solve_fem_tetra_classic(
                *cols, self.rest_volume, self.inv_rest_mat, self.youngs,
                self.poisson), lam
        return xpbd.solve_fem_tetra(*cols, self.rest_volume,
                                    self.inv_rest_mat, self.youngs,
                                    self.poisson, dt, lam)


@dataclass(frozen=True)
class FEMTriangleBatch(_ParticleBatch):
    """Orthotropic St. Venant–Kirchhoff membrane triangles
    (``PositionBasedDynamics.cpp:843-931``), cloth method 2."""

    idx: Tensor           # (C, 3)
    area: Tensor          # (C,)
    inv_rest_mat: Tensor  # (C, 2, 2)
    youngs_x: Tensor      # (C,)
    youngs_y: Tensor
    youngs_shear: Tensor
    poisson_xy: Tensor
    poisson_yx: Tensor
    color: Tensor
    num_colors: int = _static()

    k = 3
    has_lambda = False

    @staticmethod
    def create(idx, x0, youngs_x, youngs_y, youngs_shear, poisson_xy,
               poisson_yx, device=None) -> "FEMTriangleBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 3, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        area, inv = _init_fem_triangle_np(np.asarray(x0)[idx])
        return FEMTriangleBatch(
            idx=t_idx, area=_f32(area, (c,), dev),
            inv_rest_mat=_f32(inv, (c, 2, 2), dev),
            youngs_x=_f32(youngs_x, (c,), dev),
            youngs_y=_f32(youngs_y, (c,), dev),
            youngs_shear=_f32(youngs_shear, (c,), dev),
            poisson_xy=_f32(poisson_xy, (c,), dev),
            poisson_yx=_f32(poisson_yx, (c,), dev),
            color=color, num_colors=num_colors)

    def solve(self, x, inv_mass, lam, dt):
        return pbd.solve_fem_triangle(
            *self._columns(x, inv_mass), self.area, self.inv_rest_mat,
            self.youngs_x, self.youngs_y, self.youngs_shear,
            self.poisson_xy, self.poisson_yx), lam


@dataclass(frozen=True)
class StrainTriangleBatch(_ParticleBatch):
    """Strain-based dynamics triangles (Müller 2014,
    ``PositionBasedDynamics.cpp:590-688``), cloth method 3."""

    idx: Tensor           # (C, 3)
    inv_rest_mat: Tensor  # (C, 2, 2)
    stretch_k: Tensor     # (C, 2) (xx, yy)
    shear_k: Tensor       # (C, 1) (xy,)
    color: Tensor
    num_colors: int = _static()
    normalize_stretch: bool = _static()
    normalize_shear: bool = _static()

    k = 3
    has_lambda = False

    @staticmethod
    def create(idx, x0, stretch_k, shear_k, normalize_stretch=False,
               normalize_shear=False, device=None) -> "StrainTriangleBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 3, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        inv = _init_strain_triangle_np(np.asarray(x0)[idx])
        shear = np.asarray(shear_k, np.float32)
        return StrainTriangleBatch(
            idx=t_idx, inv_rest_mat=_f32(inv, (c, 2, 2), dev),
            stretch_k=_f32(stretch_k, (c, 2), dev),
            shear_k=_f32(shear.reshape(-1) if shear.ndim == 0 else shear,
                         (c, 1), dev),
            color=color, num_colors=num_colors,
            normalize_stretch=bool(normalize_stretch),
            normalize_shear=bool(normalize_shear))

    def solve(self, x, inv_mass, lam, dt):
        return pbd.solve_strain_triangle(
            *self._columns(x, inv_mass), self.inv_rest_mat, self.stretch_k,
            self.shear_k, self.normalize_stretch, self.normalize_shear), lam


@dataclass(frozen=True)
class StrainTetraBatch(_ParticleBatch):
    """Strain-based dynamics tetrahedra (``PositionBasedDynamics.cpp:
    711-805``), solid method 4."""

    idx: Tensor           # (C, 4)
    inv_rest_mat: Tensor  # (C, 3, 3)
    stretch_k: Tensor     # (C, 3)
    shear_k: Tensor       # (C, 3)
    color: Tensor
    num_colors: int = _static()
    normalize_stretch: bool = _static()
    normalize_shear: bool = _static()

    k = 4
    has_lambda = False

    @staticmethod
    def create(idx, x0, stretch_k, shear_k, normalize_stretch=False,
               normalize_shear=False, device=None) -> "StrainTetraBatch":
        dev = resolve_device(device)
        idx, t_idx = _index(idx, 4, dev)
        c = idx.shape[0]
        color, num_colors = _colors(idx, dev)
        inv = _init_strain_tetra_np(np.asarray(x0)[idx])
        return StrainTetraBatch(
            idx=t_idx, inv_rest_mat=_f32(inv, (c, 3, 3), dev),
            stretch_k=_f32(stretch_k, (c, 3), dev),
            shear_k=_f32(shear_k, (c, 3), dev),
            color=color, num_colors=num_colors,
            normalize_stretch=bool(normalize_stretch),
            normalize_shear=bool(normalize_shear))

    def solve(self, x, inv_mass, lam, dt):
        return pbd.solve_strain_tetra(
            *self._columns(x, inv_mass), self.inv_rest_mat, self.stretch_k,
            self.shear_k, self.normalize_stretch, self.normalize_shear), lam


@dataclass(frozen=True)
class ShapeMatchingBatch(_ParticleBatch):
    """Cluster shape matching (``Constraints.h:459-491``,
    ``PositionBasedDynamics.cpp:481-558``). Clusters are padded to a width
    K with ``mask``; a member's corrections are scaled by 1/#clusters it
    belongs to, as solid method 5 passes ``numClusters``, so the batch is
    *self-averaged*: the stepper adds its corrections without the Jacobi
    count division."""

    idx: Tensor         # (C, K) int64, padded with 0
    mask: Tensor        # (C, K) float32
    inv_nc: Tensor      # (C, K) 1/#clusters per member (0 on pads)
    x0_members: Tensor  # (C, K, 3) rest positions
    rest_cm: Tensor     # (C, 3)
    stiffness: Tensor   # (C,)
    color: Tensor
    num_colors: int = _static()

    has_lambda = False
    self_averaged = True

    @staticmethod
    def create(clusters, x0, stiffness, num_clusters=None, inv_mass=None,
               device=None) -> "ShapeMatchingBatch":
        """``clusters``: a list of index lists or a ``(C, K)`` array;
        ``num_clusters`` the per-slot cluster counts (default: the
        membership counts over all clusters, the reference's ``vTets``
        sizes); ``inv_mass`` the final inverse masses for the rest centres
        of mass (default all 1; :meth:`finalize` weights them again)."""
        dev = resolve_device(device)
        if isinstance(clusters, np.ndarray) and clusters.ndim == 2:
            clusters = [list(r) for r in clusters]
        kmax = max(len(c) for c in clusters)
        cn = len(clusters)
        idx = np.zeros((cn, kmax), np.int32)
        mask = np.zeros((cn, kmax), np.float32)
        for r, mem in enumerate(clusters):
            idx[r, :len(mem)] = mem
            mask[r, :len(mem)] = 1.0
        x0 = np.asarray(x0, np.float64)
        if num_clusters is None:
            counts = np.zeros((x0.shape[0],), np.float64)
            for mem in clusters:
                counts[list(mem)] += 1.0
            nc = counts[idx]
        else:
            nc = np.broadcast_to(np.asarray(num_clusters, np.float64),
                                 idx.shape)
        inv_nc = np.where(mask > 0, 1.0 / np.maximum(nc, 1.0), 0.0)
        # colour over membership; each pad gets an id of its own
        conflict = idx.astype(np.int64).copy()
        pads = mask == 0.0
        conflict[pads] = x0.shape[0] + np.arange(pads.sum())
        color, num_colors = greedy_color(conflict)
        batch = ShapeMatchingBatch(
            idx=torch.tensor(idx, dtype=torch.int64, device=dev),
            mask=torch.tensor(mask, device=dev),
            inv_nc=_f32(inv_nc, idx.shape, dev),
            x0_members=_f32(x0[idx], idx.shape + (3,), dev),
            rest_cm=torch.zeros((cn, 3), dtype=torch.float32, device=dev),
            stiffness=_f32(stiffness, (cn,), dev),
            color=torch.tensor(color, device=dev), num_colors=num_colors)
        w = (np.ones((x0.shape[0],)) if inv_mass is None
             else np.asarray(inv_mass, np.float64))
        return batch.finalize(w)

    def finalize(self, inv_mass: np.ndarray) -> "ShapeMatchingBatch":
        """Rest centres of mass with the final inverse masses (after the
        pins are set, as the reference's ``initConstraint`` runs after
        ``setMass``; ``constraints.py:786-797``)."""
        w = np.asarray(inv_mass, np.float64)[self.idx.cpu().numpy()]
        m = self.mask.cpu().numpy().astype(np.float64) / (w + EPS)
        x0m = self.x0_members.cpu().numpy().astype(np.float64)
        cm = (m[..., None] * x0m).sum(1) / np.maximum(m.sum(1)[:, None],
                                                      1e-30)
        return dataclasses.replace(self, rest_cm=_f32(
            cm, cm.shape, self.device))

    def solve(self, x, inv_mass, lam, dt):
        xs, ws = self.gather(x, inv_mass)
        corr = pbd.solve_shape_matching_cluster(
            xs, self.x0_members, ws, self.rest_cm, self.stiffness, self.mask)
        # only dynamic members move: the reference's m_w[i] != 0 gate
        corr = corr * (ws > 0.0)[..., None]
        return corr * self.inv_nc[..., None], lam


#: The solve order of the particle families in each iteration
#: (``constraints.py:1134-1139``); the last three come with slice 7.
PARTICLE_BATCH_ORDER = (
    "distance", "fem_triangle", "strain_triangle", "fem_tetra",
    "strain_tetra", "volume", "shape_matching", "dihedral",
    "isometric_bending",
    "perpendicular_bisector", "ghost_edge", "darboux_vector",
)


@dataclass(frozen=True)
class ConstraintSet:
    """All constraint batches of a scene, solved in a fixed order each
    iteration: the structured grid cloths and tet grids
    (``solver/grid_cloth.py``, ``solver/grid_tet.py``), then the particle
    families in :data:`PARTICLE_BATCH_ORDER`, then ``extra_batches`` (the
    second batch of a family whose constraints mix XPBD and classic, or
    strain flags, named ``extra{i}``), then the rigid-body ``joints``
    (``solver/joints.py``, one ``JointBatch`` a kind; ``constraints.py:
    1174``). ``direct_rods`` and ``rigid_generics`` (the stiff rods and the
    user-defined rigid constraints) come with slice 7: a set that holds
    either raises. ``n_rigid`` is the scene's rigid-body count (set by the
    builder; a scene with rigid bodies takes the ``torch_rigid`` route
    even without joints). ``n_particles`` is the scene's
    particle count (set by the builder); ``jacobi_inv_counts`` holds the
    build-time 1/#constraints column of each family
    (:meth:`with_jacobi_counts`)."""

    grid_cloths: Tuple = ()
    n_particles: Optional[int] = None
    grid_tets: Tuple = ()
    n_rigid: Optional[int] = None
    distance: Optional[DistanceBatch] = None
    fem_triangle: Optional[FEMTriangleBatch] = None
    strain_triangle: Optional[StrainTriangleBatch] = None
    fem_tetra: Optional[FEMTetraBatch] = None
    strain_tetra: Optional[StrainTetraBatch] = None
    volume: Optional[VolumeBatch] = None
    shape_matching: Optional[ShapeMatchingBatch] = None
    dihedral: Optional[DihedralBatch] = None
    isometric_bending: Optional[IsometricBendingBatch] = None
    extra_batches: Tuple = ()
    jacobi_inv_counts: dict = field(default_factory=dict)
    joints: Tuple = ()
    direct_rods: Tuple = ()
    rigid_generics: Tuple = ()

    def __post_init__(self):
        for name in ("direct_rods", "rigid_generics"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"ConstraintSet.{name} comes with slice 7 (rods and "
                    "generic constraints) of the port")

    def particle_batches(self):
        """``[(name, batch)]`` in solve order (``constraints.py:
        1206-1214``)."""
        named = [(name, getattr(self, name, None))
                 for name in PARTICLE_BATCH_ORDER]
        named = [(name, b) for name, b in named if b is not None]
        named += [(f"extra{i}", b) for i, b in enumerate(self.extra_batches)]
        return named

    def with_jacobi_counts(self, n_particles: int) -> "ConstraintSet":
        """The averaged-Jacobi denominators 1/count of every family that
        is not self-averaged, computed once at build time
        (``constraints.py:1184-1204``); also checks that every index lies
        in ``[0, n_particles)``."""
        inv = {}
        for name, b in self.particle_batches():
            idx = b.idx.cpu().numpy()
            if idx.size and (idx.min() < 0 or idx.max() >= n_particles):
                raise ValueError(f"{name}: particle indices outside "
                                 f"[0, {n_particles})")
            if b.self_averaged:
                continue
            inv[name] = torch.tensor(
                (1.0 / _counts(n_particles, idx))[:, None], device=b.device)
        return dataclasses.replace(self, jacobi_inv_counts=inv)

    def init_lambdas(self):
        lams = {name: b.init_lambda() for name, b in self.particle_batches()}
        for i, gc in enumerate(self.grid_cloths):
            lams[f"grid_cloth{i}"] = gc.init_lambda()
        for i, gt in enumerate(self.grid_tets):
            lams[f"grid_tet{i}"] = gt.init_lambda()
        return lams

    @property
    def device(self) -> Optional[torch.device]:
        batches = (self.grid_cloths + self.grid_tets
                   + tuple(b for _, b in self.particle_batches())
                   + self.joints)
        return batches[0].device if batches else None

    def to(self, device) -> "ConstraintSet":
        """The same set with every tensor on ``device``."""
        moved = {name: getattr(self, name).to(device)
                 for name in PARTICLE_BATCH_ORDER
                 if getattr(self, name, None) is not None}
        return dataclasses.replace(
            self, grid_cloths=tuple(gc.to(device) for gc in self.grid_cloths),
            grid_tets=tuple(gt.to(device) for gt in self.grid_tets),
            extra_batches=tuple(b.to(device) for b in self.extra_batches),
            joints=tuple(j.to(device) for j in self.joints),
            jacobi_inv_counts={k: v.to(device) for k, v in
                               self.jacobi_inv_counts.items()},
            **moved)
