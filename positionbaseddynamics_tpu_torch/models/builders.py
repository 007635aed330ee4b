"""Scene building — port of the regular-grid cloth and tet-bar parts of
``positionbaseddynamics_tpu/models/builders.py`` (``SimulationModel``'s
``add*`` surface, ``Simulation/SimulationModel.h:186-249``).

A :class:`SceneBuilder` accumulates particles and constraint specs on the
host in numpy, then ``build(device=)`` freezes them into a
``(SimState, ConstraintSet)`` pair of tensors. Masses of 0 pin particles.
Branches that later slices port raise ``NotImplementedError`` naming the
slice, rather than dropping their input.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .._device import resolve_device
from ..solver.constraints import ConstraintSet
from ..solver.grid_cloth import GridClothBatch
from ..solver.grid_tet import GridTetBatch
from ..solver.state import ParticleState, SimState
from .mesh import TetMesh, TriangleMesh

_UNSTRUCTURED = ("the unstructured constraint batches come with slice 4 "
                 "of the port (solver/constraints.py)")


def regular_triangle_grid(width: int, height: int, translation=(0, 0, 0),
                          rotation: Optional[np.ndarray] = None,
                          scale=(1.0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Regular cloth grid: points + alternating-diagonal triangulation,
    vertex order ``i*width + j`` with local coords (x=j·dx, y=i·dy, 0)
    (``SimulationModel.cpp:831-903``). Returns ``(points (W·H, 3),
    faces (2(W−1)(H−1), 3))``."""
    dy = scale[1] / (height - 1)
    dx = scale[0] / (width - 1)
    jj, ii = np.meshgrid(np.arange(width), np.arange(height))
    pts = np.stack(
        [jj * dx, ii * dy, np.zeros_like(ii, np.float64)], axis=-1
    ).reshape(-1, 3)
    if rotation is not None:
        pts = pts @ np.asarray(rotation, np.float64).T
    pts = pts + np.asarray(translation, np.float64)

    # alternating-diagonal triangulation (helper parity pattern)
    i, j = np.meshgrid(np.arange(height - 1), np.arange(width - 1),
                       indexing="ij")
    i, j = i.ravel(), j.ravel()
    helper = (i % 2 == j % 2).astype(np.int32)
    t1 = np.stack([i * width + j, i * width + j + 1,
                   (i + 1) * width + j + helper], axis=1)
    t2 = np.stack([(i + 1) * width + j + 1, (i + 1) * width + j,
                   i * width + j + 1 - helper], axis=1)
    faces = np.stack([t1, t2], axis=1).reshape(-1, 3)
    return pts.astype(np.float32), faces.astype(np.int32)


def regular_tet_grid(width: int, height: int, depth: int, translation=(0, 0, 0),
                     rotation: Optional[np.ndarray] = None,
                     scale=(1.0, 1.0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Regular hex grid split into 5 tets per cell, mirrored in odd cells
    so that neighbouring cells share faces
    (``SimulationModel::addRegularTetModel``, ``SimulationModel.cpp:921-1005``).
    Vertex order ``i*H*D + j*D + k``; the grid is centred at
    ``translation``. Returns ``(points (W·H·D, 3), tets (5·cells, 4))``."""
    dx = scale[0] / (width - 1)
    dy = scale[1] / (height - 1)
    dz = scale[2] / (depth - 1)
    pts = np.zeros((width, height, depth, 3), np.float64)
    pts[..., 0] = np.arange(width)[:, None, None] * dx
    pts[..., 1] = np.arange(height)[None, :, None] * dy
    pts[..., 2] = np.arange(depth)[None, None, :] * dz
    pts = pts.reshape(-1, 3)
    if rotation is not None:
        pts = pts @ np.asarray(rotation, np.float64).T
    pts = (pts + np.asarray(translation, np.float64)
           - 0.5 * np.asarray(scale, np.float64))

    hd = height * depth
    i, j, k = np.meshgrid(np.arange(width - 1), np.arange(height - 1),
                          np.arange(depth - 1), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    p0 = i * hd + j * depth + k
    p1 = p0 + 1
    p3 = (i + 1) * hd + j * depth + k
    p2 = p3 + 1
    p7 = (i + 1) * hd + (j + 1) * depth + k
    p6 = p7 + 1
    p4 = i * hd + (j + 1) * depth + k
    p5 = p4 + 1
    odd = ((i + j + k) % 2 == 1)
    tets_odd = np.stack([
        np.stack([p2, p1, p6, p3], 1), np.stack([p6, p3, p4, p7], 1),
        np.stack([p4, p1, p6, p5], 1), np.stack([p3, p1, p4, p0], 1),
        np.stack([p6, p1, p4, p3], 1)], axis=1)          # (cells, 5, 4)
    tets_even = np.stack([
        np.stack([p0, p2, p5, p1], 1), np.stack([p7, p2, p0, p3], 1),
        np.stack([p5, p2, p7, p6], 1), np.stack([p7, p0, p5, p4], 1),
        np.stack([p0, p2, p7, p5], 1)], axis=1)
    tets = np.where(odd[:, None, None], tets_odd, tets_even).reshape(-1, 4)
    return pts.astype(np.float32), tets.astype(np.int32)


@dataclass
class TriModelHandle:
    offset: int
    mesh: TriangleMesh
    # (height, width) when the model is a regular grid — enables the
    # structured-stencil path (solver/grid_cloth.py)
    grid: Optional[Tuple[int, int]] = None


@dataclass
class TetModelHandle:
    offset: int
    mesh: TetMesh
    # (width, height, depth) when the model is a regular tet grid —
    # enables the structured-stencil path (solver/grid_tet.py)
    grid: Optional[Tuple[int, int, int]] = None


def _bc(v, n):
    return np.broadcast_to(np.asarray(v, np.float32), (n,)).copy()


@dataclass
class SceneBuilder:
    """Accumulates a scene, then freezes it to tensors:
    ``add_regular_triangle_model`` → ``set_mass(pin, 0)`` →
    ``add_cloth_constraints`` → ``add_bending_constraints`` →
    ``build(device=)``, or ``add_regular_tet_model`` → ``set_mass`` →
    ``add_solid_constraints`` → ``build(device=)``.

    ``use_structured_grid`` (default True) routes distance and isometric
    bending of regular-grid cloths, and XPBD FEM tets of regular tet
    grids, into the stencil solvers. False selects the unstructured
    batches, which come with slice 4 and raise here."""

    use_structured_grid: bool = True
    _x: List[np.ndarray] = field(default_factory=list)
    _mass: List[np.ndarray] = field(default_factory=list)
    _n: int = 0
    _mass_overrides: dict = field(default_factory=dict)
    # structured grid cloth specs: offset -> {hw, distance, bending}
    _grid_cloth_specs: dict = field(default_factory=dict)
    # structured tet grid specs: (whd, offset, stiffness, poisson,
    # inversion_handling)
    _grid_tet_specs: list = field(default_factory=list)

    # ---- particles -------------------------------------------------------

    @property
    def n_particles(self) -> int:
        return self._n

    def add_particles(self, x, mass=1.0) -> int:
        x = np.atleast_2d(np.asarray(x, np.float32))
        offset = self._n
        self._x.append(x)
        self._mass.append(_bc(mass, x.shape[0]))
        self._n += x.shape[0]
        return offset

    def set_mass(self, i: int, mass: float):
        self._mass_overrides[int(i)] = float(mass)

    # ---- models ----------------------------------------------------------

    def add_regular_triangle_model(self, width, height, translation=(0, 0, 0),
                                   rotation=None, scale=(1.0, 1.0)
                                   ) -> TriModelHandle:
        pts, faces = regular_triangle_grid(width, height, translation,
                                           rotation, scale)
        offset = self.add_particles(pts, 1.0)
        return TriModelHandle(offset, TriangleMesh(len(pts), faces),
                              grid=(height, width))

    def add_regular_tet_model(self, width, height, depth,
                              translation=(0, 0, 0), rotation=None,
                              scale=(1.0, 1.0, 1.0)) -> TetModelHandle:
        pts, tets = regular_tet_grid(width, height, depth, translation,
                                     rotation, scale)
        offset = self.add_particles(pts, 1.0)
        return TetModelHandle(offset, TetMesh(len(pts), tets),
                              grid=(width, height, depth))

    def add_tet_model(self, points, tets, mass=1.0) -> TetModelHandle:
        points = np.asarray(points, np.float32)
        offset = self.add_particles(points, mass)
        return TetModelHandle(offset, TetMesh(len(points), tets))

    # ---- high-level builders (SimulationModel.cpp:1125-1240) -------------

    def _grid_spec(self, tm: TriModelHandle) -> dict:
        if not (self.use_structured_grid and tm.grid is not None):
            raise NotImplementedError(
                "only regular-grid cloths on the structured path are "
                "ported; " + _UNSTRUCTURED)
        return self._grid_cloth_specs.setdefault(
            tm.offset, dict(hw=tm.grid, distance=None, bending=None))

    def add_cloth_constraints(self, tm: TriModelHandle, method: int = 4,
                              distance_stiffness: float = 1.0):
        """Cloth method 1 = classic distance per edge, 4 = XPBD distance
        per edge (``SimulationModel.cpp:1125-1184``). Methods 2 (FEM
        triangle) and 3 (strain triangle) come with slice 4."""
        if method in (1, 4):
            self._grid_spec(tm)["distance"] = (method, float(distance_stiffness))
        elif method in (2, 3):
            raise NotImplementedError(
                f"cloth method {method} (FEM/strain triangles): "
                + _UNSTRUCTURED)
        else:
            raise NotImplementedError(f"unknown cloth method {method}")

    def add_bending_constraints(self, tm: TriModelHandle, method: int = 2,
                                stiffness: float = 0.01):
        """2 = isometric, 3 = XPBD isometric (``SimulationModel.cpp:
        1186-1240``); 1 (dihedral) comes with slice 4; other values add
        nothing, as in the JAX package."""
        if method not in (1, 2, 3):
            return
        if method == 1:
            raise NotImplementedError("dihedral bending: " + _UNSTRUCTURED)
        self._grid_spec(tm)["bending"] = (method, float(stiffness))

    def add_solid_constraints(self, tm: TetModelHandle, method: int = 3,
                              stiffness: float = 1.0,
                              poisson_ratio: float = 0.3,
                              volume_stiffness: float = 1.0,
                              normalize_stretch: bool = False,
                              normalize_shear: bool = False,
                              inversion_handling: bool = False):
        """1 = distance + volume, 2 = classic FEM tet, 3 = XPBD FEM tet,
        4 = strain tet, 5 = shape matching, 6 = XPBD distance + XPBD volume
        (``addSolidConstraints``, ``SimulationModel.cpp:1242-1320``).

        Ported: method 3 on a regular tet grid with scalar stiffness and
        Poisson ratio, which goes to the structured solver
        (``solver/grid_tet.py``); ``inversion_handling`` applies there.
        Every other method, or an irregular mesh, needs the unstructured
        batches of slice 4 and raises."""
        if method not in (1, 2, 3, 4, 5, 6):
            raise NotImplementedError(f"solid method {method} not yet "
                                      "available")
        uniform = np.ndim(stiffness) == 0 and np.ndim(poisson_ratio) == 0
        if not (method == 3 and self.use_structured_grid
                and tm.grid is not None and uniform):
            raise NotImplementedError(
                f"solid method {method} is ported only as XPBD FEM tets "
                "(method 3) on a regular tet grid with scalar stiffness; "
                + _UNSTRUCTURED)
        self._grid_tet_specs.append(
            (tm.grid, tm.offset, float(stiffness), float(poisson_ratio),
             bool(inversion_handling)))

    # ---- freeze ----------------------------------------------------------

    def _masses(self) -> np.ndarray:
        m = (np.concatenate(self._mass) if self._mass
             else np.zeros((0,), np.float32))
        for i, v in self._mass_overrides.items():
            m[i] = v
        return m

    def build(self, device=None) -> Tuple[SimState, ConstraintSet]:
        dev = resolve_device(device)
        x = (np.concatenate(self._x, axis=0)
             if self._x else np.zeros((0, 3), np.float32))
        particles = ParticleState.create(x, self._masses(), device=dev)
        gcs = []
        for offset, spec in sorted(self._grid_cloth_specs.items()):
            h, w = spec["hw"]
            dist = spec["distance"]
            bend = spec["bending"]
            gcs.append(GridClothBatch.create(
                h, w, offset, x,
                distance_stiffness=None if dist is None else dist[1],
                bending_stiffness=None if bend is None else bend[1],
                xpbd_distance=dist is not None and dist[0] == 4,
                xpbd_bending=bend is not None and bend[0] == 3,
                device=dev))
        gts = []
        for (w_g, h_g, d_g), off, stiff, nu, inv in self._grid_tet_specs:
            try:
                gts.append(GridTetBatch.create(
                    w_g, h_g, d_g, off, x, stiff, nu,
                    inversion_handling=inv, device=dev))
            except NotImplementedError as e:
                # the JAX package falls back to FEMTetraBatch here
                raise NotImplementedError(
                    f"{e}; the unstructured FEM-tet fallback: "
                    + _UNSTRUCTURED) from e
        return (SimState.create(particles),
                ConstraintSet(grid_cloths=tuple(gcs), n_particles=len(x),
                              grid_tets=tuple(gts)))
