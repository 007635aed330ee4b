"""Scene building — port of ``positionbaseddynamics_tpu/models/
builders.py`` (``SimulationModel``'s ``add*`` surface,
``Simulation/SimulationModel.h:186-249``): triangle and tet models, the
per-constraint adders, cloth, bending and solid constraints on the
structured grid solvers or on the unstructured particle batches, rigid
bodies with the 14 joint adders, Cosserat rods (line models, on the rod
lattice when the rods are identical), ghost-point rods, direct stiff-rod
chains and trees, generic particle and rigid constraints, and the
collision objects frozen into a ``CollisionPipeline`` by
``build_collision_pipeline(device=)``.

A :class:`SceneBuilder` accumulates particles, orientations, bodies and
constraint specs on the host in numpy, then ``build(device=)`` freezes
them into a ``(SimState, ConstraintSet)`` pair of tensors. Masses of 0 pin
particles and orientations and make bodies static.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..solver.constraints import (
    BendTwistBatch, ConstraintSet, DarbouxVectorBatch, DihedralBatch,
    DistanceBatch, FEMTetraBatch, FEMTriangleBatch, GenericConstraintBatch,
    GenericRigidBatch, GhostEdgeDistanceBatch, IsometricBendingBatch,
    PerpendicularBisectorBatch, ShapeMatchingBatch, StrainTetraBatch,
    StrainTriangleBatch, StretchShearBatch, VolumeBatch)
from ..solver.direct_rods import DirectRodBatch, DirectRodTreeBatch
from ..solver.grid_cloth import GridClothBatch
from ..solver.grid_rods import RodLatticeBatch
from ..solver.grid_tet import GridTetBatch
from ..solver.joints import make_joint_batch
from ..solver.state import (OrientationState, ParticleState, RigidState,
                            SimState)
from ..utils import npquat
from ..utils.massprops import mass_properties, principal_frame
from .mesh import TetMesh, TriangleMesh

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


@dataclass
class LineModelHandle:
    offset: int          # particle offset
    offset_q: int        # orientation offset
    n_points: int
    n_quaternions: int


@dataclass
class GhostRodHandle:
    offset: int          # centreline particle offset
    ghost_offset: int    # ghost particle offset (in the same global array)
    n_points: int


def _bc(v, n):
    return np.broadcast_to(np.asarray(v, np.float32), (n,)).copy()


def _rod_material(nc, radius, seg_len, youngs, torsion) -> dict:
    """A stiff rod's per-constraint material parameters, float64."""
    def per(v):
        return np.broadcast_to(np.asarray(v, np.float64), (nc,)).copy()

    return dict(radius=per(radius), seg_len=per(seg_len),
                youngs=per(youngs), torsion=per(torsion))


def _chunk2(i, j):
    return np.stack([np.atleast_1d(np.asarray(i, np.int32)),
                     np.atleast_1d(np.asarray(j, np.int32))], axis=1)


def _by_flag(chunks, flag_of):
    """The chunks grouped by flag, in sorted flag order."""
    for flag in sorted({flag_of(c) for c in chunks}):
        yield flag, [c for c in chunks if flag_of(c) == flag]


@dataclass
class SceneBuilder:
    """Accumulates a scene, then freezes it to tensors:
    ``add_regular_triangle_model`` → ``set_mass(pin, 0)`` →
    ``add_cloth_constraints`` → ``add_bending_constraints`` →
    ``build(device=)``, or ``add_regular_tet_model`` → ``set_mass`` →
    ``add_solid_constraints`` → ``build(device=)``.

    ``use_structured_grid`` (default True) routes distance and isometric
    bending of regular-grid cloths, and XPBD FEM tets of regular tet
    grids, into the stencil solvers; False selects the unstructured
    particle batches (``solver/constraints.py``), which every other mesh
    and method takes anyway."""

    use_structured_grid: bool = True
    _x: List[np.ndarray] = field(default_factory=list)
    _mass: List[np.ndarray] = field(default_factory=list)
    _n: int = 0
    _mass_overrides: dict = field(default_factory=dict)
    # constraint chunk accumulators: lists of (idx array, params...)
    _distance: list = field(default_factory=list)       # (idx, k, xpbd)
    _dihedral: list = field(default_factory=list)       # (idx, k)
    _iso_bending: list = field(default_factory=list)    # (idx, k, xpbd)
    _volume: list = field(default_factory=list)         # (idx, k, xpbd)
    _fem_tet: list = field(default_factory=list)        # (idx, E, nu, xpbd)
    _fem_tri: list = field(default_factory=list)        # (idx, Ex, Ey, Es, nuxy, nuyx)
    _strain_tri: list = field(default_factory=list)     # (idx, kxx_yy, kxy, ns, nh)
    _strain_tet: list = field(default_factory=list)     # (idx, ks, ksh, ns, nh)
    _shape_matching: list = field(default_factory=list)  # (members, k, nc)
    # structured grid cloth specs: offset -> {hw, distance, bending}
    _grid_cloth_specs: dict = field(default_factory=dict)
    # structured tet grid specs: (whd, offset, stiffness, poisson, tets,
    # inversion_handling)
    _grid_tet_specs: list = field(default_factory=list)
    # rigid bodies (float64 rows) and joint specs (builders.py:185-200)
    _rb_x: list = field(default_factory=list)
    _rb_q: list = field(default_factory=list)
    _rb_v: list = field(default_factory=list)
    _rb_omega: list = field(default_factory=list)
    _rb_mass: list = field(default_factory=list)
    _rb_inertia: list = field(default_factory=list)
    _joints: list = field(default_factory=list)
    # body -> its mesh frame (add_rigid_body_from_mesh), for the collision
    # shapes attached to it
    _rb_mesh_frames: dict = field(default_factory=dict)
    # collision objects (frozen by build_collision_pipeline)
    _rb_colliders: list = field(default_factory=list)
    _pg_colliders: list = field(default_factory=list)
    _tet_colliders: list = field(default_factory=list)
    # orientations (the rods' quaternions) and the slice-7 families
    _q: List[np.ndarray] = field(default_factory=list)
    _mass_q: List[np.ndarray] = field(default_factory=list)
    _n_q: int = 0
    _mass_q_overrides: dict = field(default_factory=dict)
    _stretch_shear: list = field(default_factory=list)  # (idx_p, idx_q, ks3)
    _bend_twist: list = field(default_factory=list)     # (idx_q, ks3)
    _perp_bisector: list = field(default_factory=list)  # (idx3, k)
    _ghost_edge: list = field(default_factory=list)     # (idx3, k)
    _darboux: list = field(default_factory=list)        # (idx5, ks3, midlen)
    _generics: list = field(default_factory=list)       # (fn, idx, k, params)
    _rigid_generics: list = field(default_factory=list)  # (fn, bodies, k)
    _direct_rods: list = field(default_factory=list)    # chain specs
    _direct_rod_trees: list = field(default_factory=list)  # tree specs

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

    def add_quaternions(self, q, mass=1.0) -> int:
        q = np.atleast_2d(np.asarray(q, np.float32))
        offset = self._n_q
        self._q.append(q)
        self._mass_q.append(_bc(mass, q.shape[0]))
        self._n_q += q.shape[0]
        return offset

    def set_quaternion_mass(self, i: int, mass: float):
        self._mass_q_overrides[int(i)] = float(mass)

    # ---- models ----------------------------------------------------------

    def add_regular_triangle_model(self, width, height, translation=(0, 0, 0),
                                   rotation=None, scale=(1.0, 1.0)
                                   ) -> TriModelHandle:
        pts, faces = regular_triangle_grid(width, height, translation,
                                           rotation, scale)
        offset = self.add_particles(pts, 1.0)
        return TriModelHandle(offset, TriangleMesh(len(pts), faces),
                              grid=(height, width))

    def add_triangle_model(self, points, faces, mass=1.0, uvs=None,
                           uv_indices=None) -> TriModelHandle:
        """An irregular triangle mesh; ``uvs (T, 2)`` / ``uv_indices (F,
        3)`` are kept on the mesh (``builders.py:263-271``)."""
        points = np.asarray(points, np.float32)
        offset = self.add_particles(points, mass)
        return TriModelHandle(offset, TriangleMesh(len(points), faces,
                                                   uvs=uvs,
                                                   uv_indices=uv_indices))

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

    def add_ghost_rod_model(self, points, ghost_points=None, mass=1.0,
                            ghost_mass=1.0) -> GhostRodHandle:
        """Ghost-point elastic rod (Umetani 2014; ``builders.py:285-312``):
        ``n`` centreline particles and ``n − 1`` edge ghosts in the global
        particle array. Without ``ghost_points`` the ghosts sit at the edge
        midpoints offset by 0.25 perpendicular to the edge
        (``PositionBasedElasticRodsDemo.cpp:160-166``)."""
        pts = np.asarray(points, np.float64)
        n = len(pts)
        if ghost_points is None:
            mids = 0.5 * (pts[:-1] + pts[1:])
            d = pts[1:] - pts[:-1]
            d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True),
                               1e-12)
            up = np.broadcast_to(np.array([0.0, 1.0, 0.0]), d.shape)
            alt = np.broadcast_to(np.array([1.0, 0.0, 0.0]), d.shape)
            perp = np.cross(d, up)
            bad = np.linalg.norm(perp, axis=1) < 1e-6
            perp[bad] = np.cross(d[bad], alt[bad])
            perp = perp / np.maximum(
                np.linalg.norm(perp, axis=1, keepdims=True), 1e-12)
            ghost_points = mids + 0.25 * perp
        offset = self.add_particles(pts, mass)
        ghost_offset = self.add_particles(np.asarray(ghost_points,
                                                     np.float64), ghost_mass)
        return GhostRodHandle(offset, ghost_offset, n)

    def add_ghost_rod_constraints(self, h: GhostRodHandle,
                                  stretching_stiffness=1.0,
                                  bending_twisting=(0.5, 0.5, 0.5)):
        """The ghost-rod demo's constraints (``builders.py:314-333``): per
        edge a distance, a perpendicular bisector and a ghost-edge
        distance; per interior element a Darboux-vector bend/twist
        (mid-edge length 1.0, as the demo passes)."""
        o, g, n = h.offset, h.ghost_offset, h.n_points
        for i in range(n - 1):
            self.add_distance_constraint(o + i, o + i + 1,
                                         stretching_stiffness)
            self.add_perpendicular_bisector_constraint(o + i, o + i + 1,
                                                       g + i)
            self.add_ghost_point_edge_distance_constraint(o + i, o + i + 1,
                                                          g + i)
            if i < n - 2:
                self.add_darboux_vector_constraint(
                    o + i, o + i + 1, o + i + 2, g + i, g + i + 1,
                    bending_twisting=bending_twisting)

    def add_line_model(self, points, quaternions=None, mass=1.0,
                       mass_q=1.0) -> LineModelHandle:
        """Rod of ``n`` particles joined by ``n − 1`` orientation
        quaternions (``SimulationModel::addLineModel``,
        ``SimulationModel.cpp:1007-1031``; ``builders.py:335-362``). Without
        ``quaternions`` the frames put d3 along each segment."""
        points = np.asarray(points, np.float32)
        n = len(points)
        offset = self.add_particles(points, mass)
        if quaternions is None:
            d = points[1:] - points[:-1]
            d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True),
                               1e-12)
            e3 = np.array([0.0, 0.0, 1.0])
            v = np.cross(np.broadcast_to(e3, d.shape), d)
            c = d[:, 2]
            quaternions = np.concatenate([(1.0 + c)[:, None], v], axis=1)
            # antipodal segments (d ≈ −e3): rotate about x by π
            flip = c < -1.0 + 1e-9
            quaternions[flip] = np.array([0.0, 1.0, 0.0, 0.0])
            quaternions = quaternions / np.linalg.norm(
                quaternions, axis=-1, keepdims=True)
        quaternions = np.asarray(quaternions, np.float32).reshape(-1, 4)
        offset_q = self.add_quaternions(quaternions, mass_q)
        return LineModelHandle(offset, offset_q, n, len(quaternions))

    # ---- per-constraint adders (SimulationModel.h:186-249) ---------------
    # Scalar and bulk (array) forms share the same chunk accumulators.

    # ---- rigid bodies & joints (SimulationModel.h:186-249) ---------------

    @property
    def n_rigid_bodies(self) -> int:
        return len(self._rb_x)

    def add_rigid_body(self, x, q=(1.0, 0.0, 0.0, 0.0), mass=1.0,
                       inertia=(1.0, 1.0, 1.0), velocity=(0.0, 0.0, 0.0),
                       omega=(0.0, 0.0, 0.0)) -> int:
        """One rigid body with explicit mass and body-frame diagonal
        inertia (``RigidBody::initBody``, ``Simulation/RigidBody.h:87-151``);
        ``mass == 0`` makes it static. Returns the body index."""
        self._rb_x.append(np.asarray(x, np.float64))
        qn = np.asarray(q, np.float64)
        self._rb_q.append(qn / max(np.linalg.norm(qn), 1e-300))
        self._rb_v.append(np.asarray(velocity, np.float64))
        self._rb_omega.append(np.asarray(omega, np.float64))
        self._rb_mass.append(float(mass))
        self._rb_inertia.append(np.asarray(inertia, np.float64))
        return len(self._rb_x) - 1

    def add_rigid_body_from_mesh(self, vertices, faces, density=1.0,
                                 translation=(0.0, 0.0, 0.0),
                                 q=(1.0, 0.0, 0.0, 0.0),
                                 scale=(1.0, 1.0, 1.0),
                                 is_dynamic=True,
                                 velocity=(0.0, 0.0, 0.0),
                                 omega=(0.0, 0.0, 0.0)) -> int:
        """A rigid body whose mass, centre of mass and inertia come from its
        closed triangle mesh at ``density`` (``RigidBody::initBody(density,
        …)`` + ``determineMassProperties``, ``Simulation/RigidBody.h:122-151,
        211-260``), its state re-expressed in the principal frame about the
        centre of mass as the reference does. The scaled mesh frame is kept
        in ``_rb_mesh_frames`` for the collision shapes attached to it."""
        verts = np.asarray(vertices, np.float64) * np.asarray(scale,
                                                              np.float64)
        mass, com, inertia = mass_properties(verts, faces, density)
        eigs, rd = principal_frame(inertia)
        qn = np.asarray(q, np.float64)
        qn = qn / max(np.linalg.norm(qn), 1e-300)
        r0 = npquat.to_matrix(qn)
        world_com = r0 @ com + np.asarray(translation, np.float64)
        body = self.add_rigid_body(
            world_com, q=npquat.from_matrix(r0 @ rd),
            mass=(float(mass) if is_dynamic else 0.0),
            inertia=eigs, velocity=velocity, omega=omega)
        self._rb_mesh_frames[body] = dict(
            # body (principal, centre-of-mass) frame -> scaled mesh frame:
            # p_mesh = rd @ p_body + com
            frame_rot=rd.astype(np.float32), frame_t=com.astype(np.float32),
            verts=((verts - com) @ rd).astype(np.float32),
            faces=np.asarray(faces, np.int32))
        return body

    def _add_joint(self, kind, rb0, rb1, **params):
        self._joints.append(dict(kind=kind, bodies=(int(rb0), int(rb1)),
                                 **params))

    def add_ball_joint(self, rb0, rb1, pos):
        self._add_joint("ball", rb0, rb1,
                        positions=np.asarray(pos, np.float64))

    def add_ball_on_line_joint(self, rb0, rb1, pos, direction):
        self._add_joint("ball_on_line", rb0, rb1,
                        positions=np.asarray(pos, np.float64),
                        directions=np.asarray(direction, np.float64))

    def add_hinge_joint(self, rb0, rb1, pos, axis):
        self._add_joint("hinge", rb0, rb1,
                        positions=np.asarray(pos, np.float64),
                        directions=np.asarray(axis, np.float64))

    def add_universal_joint(self, rb0, rb1, pos, axis0, axis1):
        self._add_joint("universal", rb0, rb1,
                        positions=np.asarray(pos, np.float64),
                        directions=np.asarray(axis0, np.float64),
                        directions1=np.asarray(axis1, np.float64))

    def add_slider_joint(self, rb0, rb1, axis):
        self._add_joint("slider", rb0, rb1,
                        directions=np.asarray(axis, np.float64))

    def _add_motor(self, kind, rb0, rb1, axis, target, sequence, repeat,
                   pos=None):
        """A motor joint; ``sequence`` is the reference's flat [t0, v0, t1,
        v1, …] target sequence (``MotorJoint::setTargetSequence``)."""
        params = dict(directions=np.asarray(axis, np.float64),
                      target=float(target), sequence=sequence,
                      repeat=bool(repeat))
        if pos is not None:
            params["positions"] = np.asarray(pos, np.float64)
        self._add_joint(kind, rb0, rb1, **params)

    def add_target_position_motor_slider_joint(self, rb0, rb1, axis,
                                               target=0.0, sequence=None,
                                               repeat=False):
        self._add_motor("target_position_motor_slider", rb0, rb1, axis,
                        target, sequence, repeat)

    def add_target_velocity_motor_slider_joint(self, rb0, rb1, axis,
                                               target=0.0, sequence=None,
                                               repeat=False):
        self._add_motor("target_velocity_motor_slider", rb0, rb1, axis,
                        target, sequence, repeat)

    def add_target_angle_motor_hinge_joint(self, rb0, rb1, pos, axis,
                                           target=0.0, sequence=None,
                                           repeat=False):
        self._add_motor("target_angle_motor_hinge", rb0, rb1, axis, target,
                        sequence, repeat, pos=pos)

    def add_target_velocity_motor_hinge_joint(self, rb0, rb1, pos, axis,
                                              target=0.0, sequence=None,
                                              repeat=False):
        self._add_motor("target_velocity_motor_hinge", rb0, rb1, axis,
                        target, sequence, repeat, pos=pos)

    def add_damper_joint(self, rb0, rb1, axis, stiffness):
        self._add_joint("damper", rb0, rb1,
                        directions=np.asarray(axis, np.float64),
                        stiffness=float(stiffness))

    def add_rigid_distance_joint(self, rb0, rb1, pos0, pos1):
        self._add_joint("distance", rb0, rb1,
                        positions=np.asarray(pos0, np.float64),
                        positions1=np.asarray(pos1, np.float64),
                        stiffness=0.0)

    def add_rigid_body_spring(self, rb0, rb1, pos0, pos1, stiffness):
        """XPBD spring between two anchors (``RigidBodySpring``: the
        distance joint's solve with compliance)."""
        self._add_joint("distance", rb0, rb1,
                        positions=np.asarray(pos0, np.float64),
                        positions1=np.asarray(pos1, np.float64),
                        stiffness=float(stiffness))

    def add_rigid_body_particle_ball_joint(self, rb, particle):
        self._add_joint("rb_particle_ball", rb, particle)

    def add_stretch_bending_twisting_constraint(self, rb0, rb1, pos,
                                                average_radius,
                                                average_segment_length,
                                                youngs_modulus,
                                                torsion_modulus):
        """Iterative 6D-XPBD zero-stretch and bend/twist joint between two
        rod-segment bodies (``addStretchBendingTwistingConstraint``;
        ``PositionBasedElasticRods.cpp:1136-1363``)."""
        self._add_joint(
            "stretch_bending_twisting", rb0, rb1,
            positions=np.asarray(pos, np.float64),
            rest=float(average_segment_length),
            directions=np.asarray(
                [average_radius, youngs_modulus, torsion_modulus],
                np.float64))

    # ---- collision objects (DistanceFieldCollisionDetection add*) --------

    def add_collision_object(self, rb: int, shape, verts=None,
                             restitution=0.6, friction=0.2):
        """Attach an SDF collision geometry (``collision.SDFShape``) to a
        rigid body, with body-frame surface samples used when the body is
        the point side of an rb–rb test (``builders.py:533-573``). Without
        ``verts`` a mesh-built body takes its own mesh vertices, an
        analytic shape its default surface sampling."""
        from ..collision import sampling
        from ..collision.sdf import (BOX, CYLINDER, HOLLOW_BOX,
                                     HOLLOW_SPHERE, SPHERE, TORUS)

        mesh_frame = self._rb_mesh_frames.get(int(rb))
        if verts is None:
            if mesh_frame is not None:
                verts = mesh_frame["verts"]
            else:
                k = shape.kind
                p = shape.params.detach().cpu().numpy()
                if k == SPHERE:
                    verts = sampling.sample_sphere(float(p[0]))
                elif k in (BOX, HOLLOW_BOX):
                    verts = sampling.sample_box(p[:3])
                elif k == CYLINDER:
                    verts = sampling.sample_cylinder(float(p[0]),
                                                     2 * float(p[1]))
                elif k == TORUS:
                    verts = sampling.sample_torus(float(p[0]), float(p[1]))
                elif k == HOLLOW_SPHERE:
                    verts = sampling.sample_sphere(float(p[0]) + float(p[1]))
        self._rb_colliders.append(dict(
            body=int(rb), shape=shape,
            verts=None if verts is None else np.asarray(verts, np.float32),
            frame_rot=(None if mesh_frame is None
                       else mesh_frame["frame_rot"]),
            frame_t=None if mesh_frame is None else mesh_frame["frame_t"],
            restitution=float(restitution), friction=float(friction)))

    def add_collision_sphere(self, rb, radius, **kw):
        from ..collision.sdf import SDFShape
        self.add_collision_object(rb, SDFShape.sphere(radius), **kw)

    def add_collision_box(self, rb, half_extents, **kw):
        from ..collision.sdf import SDFShape
        self.add_collision_object(rb, SDFShape.box(half_extents), **kw)

    def add_collision_cylinder(self, rb, radius, height, **kw):
        from ..collision.sdf import SDFShape
        self.add_collision_object(rb, SDFShape.cylinder(radius, height),
                                  **kw)

    def add_collision_torus(self, rb, major_r, minor_r, **kw):
        from ..collision.sdf import SDFShape
        self.add_collision_object(rb, SDFShape.torus(major_r, minor_r), **kw)

    def add_collision_sdf(self, rb, values, origin, extent, verts=None, **kw):
        """Baked-grid SDF (``CubicSDFCollisionDetection`` analogue); bake a
        mesh with ``collision.bake_mesh_sdf``."""
        from ..collision.sdf import SDFShape
        self.add_collision_object(
            rb, SDFShape.grid(values, origin, extent), verts=verts, **kw)

    def set_particle_collider(self, handle, restitution=0.1, friction=0.2):
        """Let a triangle/tet model's particles collide with rigid SDFs
        (the ``collisionDetectionRBSolid`` path)."""
        self._pg_colliders.append(dict(
            offset=handle.offset, count=int(handle.mesh.n_vertices),
            restitution=float(restitution), friction=float(friction)))

    def set_tet_collider(self, handle: TetModelHandle, restitution=0.1,
                         friction=0.2, sdf_resolution=24,
                         grid_resolution=24, cache_dir=None):
        """Register a tet model as a solid collision target: other
        deformables' particles collide with its rest-pose surface through
        the barycentric ref-tet map (``collisionDetectionSolidSolid``,
        ``DistanceFieldCollisionDetection.cpp:361-470``).
        ``sdf_resolution``/``cache_dir`` are kept as JAX's, which queries
        the exact rest surface instead of a baked grid; ``grid_resolution``
        sizes the ref-tet lookup grid."""
        self._tet_colliders.append(dict(
            offset=handle.offset, count=int(handle.mesh.n_vertices),
            tets_local=handle.mesh.tets,
            surface_faces=handle.mesh.surface_faces,
            restitution=float(restitution), friction=float(friction),
            sdf_resolution=sdf_resolution, grid_resolution=grid_resolution,
            cache_dir=cache_dir))

    def build_collision_pipeline(self, tolerance=0.01,
                                 max_collider_verts=512,
                                 broad_phase="auto", pair_capacity=None,
                                 device=None):
        """Freeze the colliders into a ``CollisionPipeline`` on ``device``
        (None means CUDA), to pass to ``make_step_fn`` / ``step`` /
        ``rollout`` or the planner (``builders.py:620-752``).
        ``broad_phase``: "auto" (the batched pipeline once more than 24
        gates would unroll), "unrolled" or "batched"; ``pair_capacity``
        bounds the batched active-pair list per shape kind. Pairs of two
        static bodies are dropped, and point clouds larger than
        ``max_collider_verts`` are subsampled evenly (None keeps them)."""
        from ..collision.bvh import build_block_spheres, morton_order
        from ..collision.detection import (CollisionPipeline,
                                           ParticleGroupCollider,
                                           RigidCollider)
        from ..collision.sdf import shape_bounding_radius
        from ..collision.solid import TetCollider

        dev = resolve_device(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def _sub(v):
            if (v is None or max_collider_verts is None
                    or len(v) <= max_collider_verts):
                return v
            sel = np.linspace(0, len(v) - 1, max_collider_verts).astype(int)
            return v[sel]

        def _radii(c):
            vr = (float(np.linalg.norm(c["verts"], axis=1).max())
                  if c["verts"] is not None and len(c["verts"])
                  else float("inf"))
            sr = shape_bounding_radius(c["shape"])
            if c.get("frame_t") is not None and np.isfinite(sr):
                sr += float(np.linalg.norm(c["frame_t"]))
            return vr, sr

        rcs = []
        for c in self._rb_colliders:
            vr, sr = _radii(c)
            verts_np = None if c["verts"] is None else _sub(c["verts"])
            bc = br_ = None
            if verts_np is not None and len(verts_np) >= 16:
                # Morton-sorted vertices and their block spheres (bvh.py)
                verts_np, centers, radii = build_block_spheres(
                    verts_np, block_size=16)
                bc, br_ = f32(centers), f32(radii)
            rcs.append(RigidCollider(
                body=c["body"], shape=c["shape"].to(dev),
                verts=None if verts_np is None else f32(verts_np),
                block_centers=bc, block_radii=br_,
                frame_rot=(None if c.get("frame_rot") is None
                           else f32(c["frame_rot"])),
                frame_t=(None if c.get("frame_t") is None
                         else f32(c["frame_t"])),
                restitution=f32(c["restitution"]),
                friction=f32(c["friction"]),
                verts_radius=vr, shape_radius=sr))
        dyn = [self._rb_mass[c["body"]] != 0.0 for c in self._rb_colliders]
        rb_pairs = tuple(
            (i, j) for i in range(len(rcs)) for j in range(len(rcs))
            if i != j and rcs[i].verts is not None and (dyn[i] or dyn[j]))
        x_all = (np.concatenate(self._x, axis=0)
                 if self._x else np.zeros((0, 3), np.float32))
        pgs = tuple(
            ParticleGroupCollider(
                offset=c["offset"], count=c["count"],
                restitution=f32(c["restitution"]),
                friction=f32(c["friction"]),
                morton_perm=(torch.as_tensor(morton_order(
                    x_all[c["offset"]:c["offset"] + c["count"]]),
                    dtype=torch.int64, device=dev)
                    if c["count"] >= 64 else None))
            for c in self._pg_colliders)
        # solid-solid: every particle group with every other tet collider
        tcs = [TetCollider.create(
            s["offset"], s["count"], s["tets_local"],
            x_all[s["offset"]:s["offset"] + s["count"]], s["surface_faces"],
            restitution=s["restitution"], friction=s["friction"],
            sdf_resolution=s["sdf_resolution"],
            grid_resolution=s["grid_resolution"], cache_dir=s["cache_dir"],
            device=dev) for s in self._tet_colliders]
        point_groups = [(c["offset"], c["count"], np.float32(c["friction"]))
                        for c in self._pg_colliders]
        solid_pairs = tuple((pg, tc) for pg in point_groups for tc in tcs
                            if pg[0] != tc.offset)
        return CollisionPipeline.create(rcs, pgs, tolerance=tolerance,
                                        rb_pairs=rb_pairs,
                                        solid_pairs=solid_pairs,
                                        broad_phase=broad_phase,
                                        pair_capacity=pair_capacity)

    # ---- per-constraint adders -------------------------------------------

    def add_distance_constraint(self, i, j, stiffness=1.0, xpbd=False):
        idx = _chunk2(i, j)
        self._distance.append((idx, _bc(stiffness, len(idx)), bool(xpbd)))

    def add_dihedral_constraint(self, p0, p1, p2, p3, stiffness=1.0):
        idx = np.atleast_2d(np.asarray([p0, p1, p2, p3], np.int32).T
                            if np.ndim(p0) else
                            np.asarray([[p0, p1, p2, p3]], np.int32))
        self._dihedral.append((idx, _bc(stiffness, len(idx))))

    def add_isometric_bending_constraint(self, p0, p1, p2, p3, stiffness=1.0,
                                         xpbd=False):
        idx = np.asarray([[p0, p1, p2, p3]], np.int32)
        self._iso_bending.append((idx, _bc(stiffness, 1), bool(xpbd)))

    def add_volume_constraint(self, p0, p1, p2, p3, stiffness=1.0,
                              xpbd=False):
        idx = np.asarray([[p0, p1, p2, p3]], np.int32)
        self._volume.append((idx, _bc(stiffness, 1), bool(xpbd)))

    def add_fem_tet_constraint(self, p0, p1, p2, p3, youngs=1.0, poisson=0.3,
                               xpbd=False):
        """``addFEMTetConstraint`` / ``addFEMTetConstraint_XPBD``."""
        idx = np.asarray([[p0, p1, p2, p3]], np.int32)
        self._fem_tet.append((idx, _bc(youngs, 1), _bc(poisson, 1),
                              bool(xpbd)))

    def add_fem_triangle_constraint(self, p0, p1, p2, xx_stiffness=1.0,
                                    yy_stiffness=1.0, xy_stiffness=1.0,
                                    xy_poisson=0.3, yx_poisson=0.3):
        """``addFEMTriangleConstraint`` (``SimulationModel.h``)."""
        idx = np.asarray([[p0, p1, p2]], np.int32)
        self._fem_tri.append((idx, _bc(xx_stiffness, 1),
                              _bc(yy_stiffness, 1), _bc(xy_stiffness, 1),
                              _bc(xy_poisson, 1), _bc(yx_poisson, 1)))

    def add_strain_triangle_constraint(self, p0, p1, p2, xx_stiffness=1.0,
                                       yy_stiffness=1.0, xy_stiffness=1.0,
                                       normalize_stretch=False,
                                       normalize_shear=False):
        idx = np.asarray([[p0, p1, p2]], np.int32)
        sk = np.stack([_bc(xx_stiffness, 1), _bc(yy_stiffness, 1)], axis=1)
        self._strain_tri.append((idx, sk, _bc(xy_stiffness, 1)[:, None],
                                 bool(normalize_stretch),
                                 bool(normalize_shear)))

    def add_strain_tet_constraint(self, p0, p1, p2, p3, stretch_stiffness=1.0,
                                  shear_stiffness=1.0, normalize_stretch=False,
                                  normalize_shear=False):
        idx = np.asarray([[p0, p1, p2, p3]], np.int32)
        sk = np.broadcast_to(np.asarray(stretch_stiffness, np.float32),
                             (1, 3)).copy()
        sh = np.broadcast_to(np.asarray(shear_stiffness, np.float32),
                             (1, 3)).copy()
        self._strain_tet.append((idx, sk, sh, bool(normalize_stretch),
                                 bool(normalize_shear)))

    def add_shape_matching_constraint(self, particle_indices, stiffness=1.0,
                                      num_clusters=None):
        """One cluster (``addShapeMatchingConstraint``,
        ``SimulationModel.h:228``); ``num_clusters`` optionally gives the
        per-member cluster counts that average overlapping clusters."""
        self._shape_matching.append(
            (list(map(int, particle_indices)), float(stiffness),
             None if num_clusters is None else list(num_clusters)))

    def add_stretch_shear_constraint(self, i, j, qi,
                                     stiffness=(1.0, 1.0, 1.0)):
        ks = np.broadcast_to(np.asarray(stiffness, np.float32), (1, 3)).copy()
        self._stretch_shear.append(
            (_chunk2(i, j), np.atleast_1d(np.asarray(qi, np.int32)), ks))

    def add_bend_twist_constraint(self, qi, qj, stiffness=(0.5, 0.5, 0.5)):
        ks = np.broadcast_to(np.asarray(stiffness, np.float32), (1, 3)).copy()
        self._bend_twist.append((_chunk2(qi, qj), ks))

    def add_direct_rod_chain(self, bodies, positions, average_radius,
                             average_segment_length, youngs_modulus,
                             torsion_modulus):
        """One stiff-rod chain for the direct solver
        (``DirectPositionBasedSolverForStiffRods``; ``builders.py:
        827-847``): ``bodies (S,)`` segment bodies in chain order,
        ``positions (S-1, 3)`` world constraint positions."""
        bodies = np.asarray(bodies, np.int32)
        nc = len(bodies) - 1
        self._direct_rods.append(dict(
            bodies=bodies, positions=np.asarray(positions, np.float64),
            **_rod_material(nc, average_radius, average_segment_length,
                            youngs_modulus, torsion_modulus)))

    def add_direct_rod_tree(self, bodies, edges, positions, average_radius,
                            average_segment_length, youngs_modulus,
                            torsion_modulus):
        """One branched stiff-rod segment tree for the direct solver
        (``builders.py:849-875``): ``bodies (S,)``, ``edges (C, 2)`` local
        segment pairs, ``positions (C, 3)`` world constraint positions."""
        bodies = np.asarray(bodies, np.int32).reshape(-1)
        edges = np.asarray(edges, np.int32).reshape(-1, 2)
        nc = len(edges)
        self._direct_rod_trees.append(dict(
            bodies=bodies, edges=edges,
            positions=np.asarray(positions, np.float64).reshape(nc, 3),
            **_rod_material(nc, average_radius, average_segment_length,
                            youngs_modulus, torsion_modulus)))

    def add_generic_constraints(self, fn, indices, stiffness=1.0,
                                params=None):
        """User-defined particle constraints (``builders.py:877-885``):
        ``fn(pts (k, 3)[, params (p,)]) -> (dim,)``, a torch function,
        applied to every row of ``indices (C, k)``."""
        self._generics.append((fn, np.asarray(indices, np.int32),
                               stiffness, params))

    def add_generic_rigid_constraints(self, fn, bodies, stiffness=1.0):
        """User-defined rigid-body constraints (``builders.py:887-894``):
        ``fn(x (k, 3), q (k, 4)) -> (dim,)``, a torch function, per row of
        ``bodies (C, k)``."""
        self._rigid_generics.append((fn, np.asarray(bodies, np.int32),
                                     stiffness))

    def add_perpendicular_bisector_constraint(self, p0, p1, ghost,
                                              stiffness=1.0):
        idx = np.array([[p0, p1, ghost]], np.int32)
        self._perp_bisector.append((idx, _bc(stiffness, 1)))

    def add_ghost_point_edge_distance_constraint(self, p0, p1, ghost,
                                                 stiffness=1.0):
        idx = np.array([[p0, p1, ghost]], np.int32)
        self._ghost_edge.append((idx, _bc(stiffness, 1)))

    def add_darboux_vector_constraint(self, p0, p1, p2, ghost0, ghost1,
                                      bending_twisting=(0.5, 0.5, 0.5),
                                      mid_edge_length=1.0):
        idx = np.array([[p0, p1, p2, ghost0, ghost1]], np.int32)
        ks = np.broadcast_to(np.asarray(bending_twisting, np.float32),
                             (1, 3)).copy()
        self._darboux.append((idx, ks, _bc(mid_edge_length, 1)))

    # ---- high-level builders (SimulationModel.cpp:1125-1320) -------------

    def _grid_spec(self, tm: TriModelHandle) -> Optional[dict]:
        """The model's structured grid-cloth spec, or None when it takes
        the unstructured batches."""
        if not (self.use_structured_grid and tm.grid is not None):
            return None
        return self._grid_cloth_specs.setdefault(
            tm.offset, dict(hw=tm.grid, distance=None, bending=None))

    def add_cloth_constraints(self, tm: TriModelHandle, method: int = 4,
                              distance_stiffness: float = 1.0,
                              xx_stiffness: float = 1.0,
                              yy_stiffness: float = 1.0,
                              xy_stiffness: float = 1.0,
                              xy_poisson: float = 0.3,
                              yx_poisson: float = 0.3,
                              normalize_stretch: bool = False,
                              normalize_shear: bool = False):
        """Cloth method 1 = classic distance per edge, 2 = FEM triangle,
        3 = strain triangle, 4 = XPBD distance per edge
        (``addClothConstraints``, ``SimulationModel.cpp:1125-1184``)."""
        if method in (1, 4):
            spec = self._grid_spec(tm)
            if spec is not None:
                spec["distance"] = (method, float(distance_stiffness))
                return
            idx = (tm.mesh.edges + tm.offset).astype(np.int32)
            self._distance.append(
                (idx, _bc(distance_stiffness, len(idx)), method == 4))
        elif method == 2:
            idx = (tm.mesh.faces + tm.offset).astype(np.int32)
            n = len(idx)
            self._fem_tri.append(
                (idx, _bc(xx_stiffness, n), _bc(yy_stiffness, n),
                 _bc(xy_stiffness, n), _bc(xy_poisson, n),
                 _bc(yx_poisson, n)))
        elif method == 3:
            idx = (tm.mesh.faces + tm.offset).astype(np.int32)
            n = len(idx)
            sk = np.stack([_bc(xx_stiffness, n), _bc(yy_stiffness, n)],
                          axis=1)
            self._strain_tri.append(
                (idx, sk, _bc(xy_stiffness, n)[:, None],
                 bool(normalize_stretch), bool(normalize_shear)))
        else:
            raise NotImplementedError(f"unknown cloth method {method}")

    def add_bending_constraints(self, tm: TriModelHandle, method: int = 2,
                                stiffness: float = 0.01):
        """1 = dihedral, 2 = isometric, 3 = XPBD isometric
        (``addBendingConstraints``, ``SimulationModel.cpp:1186-1240``);
        other values add nothing, as in the JAX package."""
        if method not in (1, 2, 3):
            return
        if method in (2, 3):
            spec = self._grid_spec(tm)
            if spec is not None:
                spec["bending"] = (method, float(stiffness))
                return
        idx = (tm.mesh.bending_stencils() + tm.offset).astype(np.int32)
        if method == 1:
            self._dihedral.append((idx, _bc(stiffness, len(idx))))
        else:
            self._iso_bending.append(
                (idx, _bc(stiffness, len(idx)), method == 3))

    def add_solid_constraints(self, tm: TetModelHandle, method: int = 3,
                              stiffness: float = 1.0,
                              poisson_ratio: float = 0.3,
                              volume_stiffness: float = 1.0,
                              normalize_stretch: bool = False,
                              normalize_shear: bool = False,
                              inversion_handling: bool = False):
        """1 = distance + volume, 2 = classic FEM tet, 3 = XPBD FEM tet,
        4 = strain tet, 5 = shape matching (one cluster a tet, corrections
        averaged by each vertex's cluster count), 6 = XPBD distance + XPBD
        volume (``addSolidConstraints``, ``SimulationModel.cpp:1242-1320``).

        Method 3 on a regular tet grid with scalar stiffness and Poisson
        ratio goes to the structured solver (``solver/grid_tet.py``),
        where ``inversion_handling`` applies; ``build`` falls back to the
        FEM-tet batch when the grid's cells are not congruent. The batches
        always handle inversion, as the reference does."""
        tets = (tm.mesh.tets + tm.offset).astype(np.int32)
        n = len(tets)
        if method in (1, 6):
            xpbd = method == 6
            edges = (tm.mesh.edges + tm.offset).astype(np.int32)
            self._distance.append((edges, _bc(stiffness, len(edges)), xpbd))
            self._volume.append((tets, _bc(volume_stiffness, n), xpbd))
        elif method in (2, 3):
            uniform = np.ndim(stiffness) == 0 and np.ndim(poisson_ratio) == 0
            if (method == 3 and self.use_structured_grid
                    and tm.grid is not None and uniform):
                self._grid_tet_specs.append(
                    (tm.grid, tm.offset, float(stiffness),
                     float(poisson_ratio), tets, bool(inversion_handling)))
                return
            self._fem_tet.append((tets, _bc(stiffness, n),
                                  _bc(poisson_ratio, n), method == 3))
        elif method == 4:
            sk = np.broadcast_to(np.float32(stiffness), (n, 3)).copy()
            self._strain_tet.append((tets, sk, sk.copy(),
                                     bool(normalize_stretch),
                                     bool(normalize_shear)))
        elif method == 5:
            for row in tets:
                self._shape_matching.append(
                    (list(map(int, row)), float(stiffness), None))
        else:
            raise NotImplementedError(f"solid method {method} not yet "
                                      "available")

    def add_rod_constraints(self, lm: LineModelHandle,
                            stretch_stiffness=(1.0, 1.0, 1.0),
                            bend_twist_stiffness=(0.5, 0.5, 0.5)):
        """Stretch-shear per segment and bend-twist per frame pair, as
        ``CosseratRodsDemo/main.cpp:225-273`` (``builders.py:1022-1040``)."""
        n_seg = lm.n_points - 1
        seg = np.arange(n_seg, dtype=np.int32)
        idx_p = np.stack([lm.offset + seg, lm.offset + seg + 1], axis=1)
        idx_q = lm.offset_q + seg
        ks = np.broadcast_to(np.asarray(stretch_stiffness, np.float32),
                             (n_seg, 3)).copy()
        self._stretch_shear.append((idx_p, idx_q, ks))
        n_bt = lm.n_quaternions - 1
        if n_bt > 0:
            bt = np.arange(n_bt, dtype=np.int32)
            idx_bt = np.stack([lm.offset_q + bt, lm.offset_q + bt + 1],
                              axis=1)
            ksb = np.broadcast_to(np.asarray(bend_twist_stiffness,
                                             np.float32), (n_bt, 3)).copy()
            self._bend_twist.append((idx_bt, ksb))

    def _try_rod_lattice(self, x, q0, dev):
        """The rod lattice (``solver/grid_rods.py``) of identical rods
        added one after another — same segment count, uniform rest length,
        isotropic uniform stretch stiffness, uniform bend-twist stiffness,
        consecutive particles and quaternions — else None, and the rods
        take the unstructured batches (``builders.py:1042-1087``)."""
        ss = self._stretch_shear
        bt = self._bend_twist
        n_seg = len(ss[0][0])
        n_p = n_seg + 1
        if any(len(c[0]) != n_seg for c in ss):
            return None
        if len(bt) != len(ss) or any(len(c[0]) != n_seg - 1 for c in bt):
            return None
        ks = ss[0][2]
        if not (np.all(ks == ks[0, 0]) and
                all(np.array_equal(c[2], ks) for c in ss)):
            return None
        ksb = bt[0][1]
        if not all(np.array_equal(c[1], ksb) for c in bt):
            return None
        op = int(ss[0][0][0, 0])
        oq = int(ss[0][1][0])
        for r, (ip, iq, _) in enumerate(ss):
            want_p = op + r * n_p + np.arange(n_seg)
            if not (np.array_equal(ip[:, 0], want_p)
                    and np.array_equal(ip[:, 1], want_p + 1)
                    and np.array_equal(iq, oq + r * n_seg
                                       + np.arange(n_seg))):
                return None
        for r, (ib, _) in enumerate(bt):
            want_q = oq + r * n_seg + np.arange(n_seg - 1)
            if not (np.array_equal(ib[:, 0], want_q)
                    and np.array_equal(ib[:, 1], want_q + 1)):
                return None
        idx_p = np.concatenate([c[0] for c in ss])
        rest = np.linalg.norm(x[idx_p[:, 0]] - x[idx_p[:, 1]], axis=-1)
        if not np.allclose(rest, rest[0], rtol=1e-5):
            return None
        return RodLatticeBatch.create(
            len(ss), n_p, op, oq, q0, float(rest[0]), float(ks[0, 0]),
            np.asarray(ksb[0], np.float32), device=dev)

    # ---- freeze ----------------------------------------------------------

    def _masses(self) -> np.ndarray:
        m = (np.concatenate(self._mass) if self._mass
             else np.zeros((0,), np.float32))
        for i, v in self._mass_overrides.items():
            m[i] = v
        return m

    def _particle_batches(self, x: np.ndarray, dev) -> dict:
        """The particle batches as ``ConstraintSet`` fields
        (``builders.py:1200-1316``): a family whose chunks mix XPBD and
        classic, or strain flags, puts its first flag's batch in its own
        field and the others in ``extra_batches``."""
        kw, extras = {}, []

        def place(name, batch):
            if name not in kw:
                kw[name] = batch
            else:
                extras.append(batch)

        def cat(chunks, i):
            return np.concatenate([c[i] for c in chunks])

        for flag, cs in _by_flag(self._distance, lambda c: c[2]):
            idx = cat(cs, 0)
            rest = np.linalg.norm(x[idx[:, 0]] - x[idx[:, 1]], axis=-1)
            place("distance", DistanceBatch.create(
                idx, rest, cat(cs, 1), xpbd_mode=flag, device=dev))
        if self._dihedral:
            kw["dihedral"] = DihedralBatch.create(
                cat(self._dihedral, 0), x, cat(self._dihedral, 1),
                device=dev)
        for flag, cs in _by_flag(self._iso_bending, lambda c: c[2]):
            place("isometric_bending", IsometricBendingBatch.create(
                cat(cs, 0), x, cat(cs, 1), xpbd_mode=flag, device=dev))
        for flag, cs in _by_flag(self._volume, lambda c: c[2]):
            place("volume", VolumeBatch.create(
                cat(cs, 0), x, cat(cs, 1), xpbd_mode=flag, device=dev))
        for flag, cs in _by_flag(self._fem_tet, lambda c: c[3]):
            place("fem_tetra", FEMTetraBatch.create(
                cat(cs, 0), x, cat(cs, 1), cat(cs, 2), xpbd_mode=flag,
                device=dev))
        if self._fem_tri:
            kw["fem_triangle"] = FEMTriangleBatch.create(
                cat(self._fem_tri, 0), x,
                *(cat(self._fem_tri, i) for i in range(1, 6)), device=dev)
        for (ns, nh), cs in _by_flag(self._strain_tri,
                                     lambda c: (c[3], c[4])):
            place("strain_triangle", StrainTriangleBatch.create(
                cat(cs, 0), x, cat(cs, 1), cat(cs, 2),
                normalize_stretch=ns, normalize_shear=nh, device=dev))
        if self._strain_tet:
            flags = {(c[3], c[4]) for c in self._strain_tet}
            if len(flags) > 1:
                raise ValueError("mixed strain normalization flags")
            ns, nh = flags.pop()
            kw["strain_tetra"] = StrainTetraBatch.create(
                cat(self._strain_tet, 0), x, cat(self._strain_tet, 1),
                cat(self._strain_tet, 2), normalize_stretch=ns,
                normalize_shear=nh, device=dev)
        if self._shape_matching:
            kw["shape_matching"] = self._shape_matching_batch(x, dev)
        kw["extra_batches"] = tuple(extras)
        return kw

    def _shape_matching_batch(self, x: np.ndarray, dev):
        """One batch of every cluster, its rest centres of mass weighted
        by the final masses (``builders.py:1291-1311``)."""
        clusters = [c[0] for c in self._shape_matching]
        stiff = np.array([c[1] for c in self._shape_matching], np.float32)
        explicit_nc = [c[2] for c in self._shape_matching]
        nc = None
        if any(e is not None for e in explicit_nc):
            kmax = max(len(cl) for cl in clusters)
            nc = np.ones((len(clusters), kmax), np.float64)
            counts = np.zeros((x.shape[0],), np.float64)
            for cl in clusters:
                counts[list(cl)] += 1.0
            for r, (cl, e) in enumerate(zip(clusters, explicit_nc)):
                nc[r, :len(cl)] = e if e is not None else counts[list(cl)]
        batch = ShapeMatchingBatch.create(clusters, x, stiff,
                                          num_clusters=nc, device=dev)
        m = self._masses()
        return batch.finalize(np.where(m > 0.0, 1.0 / np.maximum(m, 1e-30),
                                       0.0))

    def _build_rigid(self, dev) -> Optional[RigidState]:
        """The rigid bodies' state (``builders.py:1095-1112``)."""
        if not self._rb_x:
            return None
        state = RigidState.create(np.stack(self._rb_x), np.stack(self._rb_q),
                                  np.asarray(self._rb_mass),
                                  np.stack(self._rb_inertia), device=dev)
        v, om = np.stack(self._rb_v), np.stack(self._rb_omega)
        if np.any(v) or np.any(om):
            state = dataclasses.replace(
                state, v=torch.tensor(v, dtype=torch.float32, device=dev),
                omega=torch.tensor(om, dtype=torch.float32, device=dev))
        return state

    def _build_joints(self, x, dev) -> Tuple:
        """The joints grouped by kind into ``JointBatch``-es, in first-use
        order (``builders.py:1114-1183``). The colouring's conflict ids give
        each static body's use an id of its own (a static body is never
        written, so two joints on it do not conflict) and shift particle
        ids past the bodies'."""
        if not self._joints:
            return ()
        rx, rq = np.stack(self._rb_x), np.stack(self._rb_q)
        masses = np.asarray(self._rb_mass)
        n_rb = len(masses)
        uid = n_rb + max(self._n, 1)
        kinds: List[str] = []
        for j in self._joints:
            if j["kind"] not in kinds:
                kinds.append(j["kind"])
        batches = []
        for kind in kinds:
            js = [j for j in self._joints if j["kind"] == kind]
            bodies = np.array([j["bodies"] for j in js], np.int32)
            conflict = bodies.astype(np.int64).copy()
            for r in range(len(js)):
                if kind == "rb_particle_ball":
                    conflict[r, 1] += n_rb
                    cols = (0,)
                else:
                    cols = (0, 1)
                for col in cols:
                    if masses[bodies[r, col]] == 0.0:
                        conflict[r, col] = uid
                        uid += 1
            kwargs = {}
            for name in ("positions", "positions1", "directions",
                         "directions1"):
                if name in js[0]:
                    kwargs[name] = np.stack([j[name] for j in js])
            for name in ("stiffness", "rest", "target"):
                if name in js[0]:
                    kwargs[name] = np.array([j[name] for j in js],
                                            np.float64)
            if "target" in js[0]:
                kwargs.update(_sequences(js))
            if kind == "rb_particle_ball":
                kwargs["particle_x"] = x
            batches.append(make_joint_batch(kind, bodies, conflict, rx, rq,
                                            device=dev, **kwargs))
        return tuple(batches)

    def build(self, device=None) -> Tuple[SimState, ConstraintSet]:
        dev = resolve_device(device)
        x = (np.concatenate(self._x, axis=0)
             if self._x else np.zeros((0, 3), np.float32))
        particles = ParticleState.create(x, self._masses(), device=dev)
        gts = []
        fallback = []
        for (w_g, h_g, d_g), off, stiff, nu, tets, inv in \
                self._grid_tet_specs:
            try:
                gts.append(GridTetBatch.create(
                    w_g, h_g, d_g, off, x, stiff, nu,
                    inversion_handling=inv, device=dev))
            except NotImplementedError:
                # cells not congruent: the FEM-tet batch, as JAX's
                # builders.py:1239-1253
                fallback.append((tets, _bc(stiff, len(tets)),
                                 _bc(nu, len(tets)), True))
        fem_tet = self._fem_tet
        self._fem_tet = fem_tet + fallback
        try:
            kw = self._particle_batches(x, dev)
        finally:
            self._fem_tet = fem_tet
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
        rigid = self._build_rigid(dev)
        orientations, q0 = self._build_orientations(dev)
        kw.update(self._rod_batches(x, q0, dev))
        kw.update(self._rigid_rod_batches(dev))
        cset = ConstraintSet(grid_cloths=tuple(gcs), n_particles=len(x),
                             grid_tets=tuple(gts),
                             n_rigid=None if rigid is None else rigid.n,
                             joints=self._build_joints(x, dev), **kw)
        return (SimState.create(particles, orientations=orientations,
                                rigid=rigid),
                cset.with_jacobi_counts(len(x), self._n_q))

    def _build_orientations(self, dev):
        """The orientation state and its initial quaternions (numpy), or
        ``(None, None)`` (``builders.py:1188-1197``)."""
        if not self._q:
            return None, None
        q0 = np.concatenate(self._q, axis=0)
        mq = np.concatenate(self._mass_q)
        for i, v in self._mass_q_overrides.items():
            mq[i] = v
        return OrientationState.create(q0, mq, device=dev), q0

    def _rod_batches(self, x, q0, dev) -> dict:
        """The ghost-rod, generic and Cosserat batches as ``ConstraintSet``
        fields (``builders.py:1317-1385``): identical rods, when there are
        two or more and the structured path is on, take the rod lattice."""
        kw = {}

        def cat(chunks, i):
            return np.concatenate([c[i] for c in chunks])

        if self._generics:
            kw["generics"] = tuple(
                GenericConstraintBatch.create(fn, idx, k, params=pr,
                                              device=dev)
                for fn, idx, k, pr in self._generics)
        if self._perp_bisector:
            kw["perpendicular_bisector"] = PerpendicularBisectorBatch.create(
                cat(self._perp_bisector, 0), cat(self._perp_bisector, 1),
                device=dev)
        if self._ghost_edge:
            kw["ghost_edge"] = GhostEdgeDistanceBatch.create(
                cat(self._ghost_edge, 0), x, cat(self._ghost_edge, 1),
                device=dev)
        if self._darboux:
            kw["darboux_vector"] = DarbouxVectorBatch.create(
                cat(self._darboux, 0), x, cat(self._darboux, 1),
                cat(self._darboux, 2), device=dev)
        lattice = None
        if self.use_structured_grid and len(self._stretch_shear) > 1:
            lattice = self._try_rod_lattice(x, q0, dev)
        if lattice is not None:
            kw["rod_lattices"] = (lattice,)
            return kw
        if self._stretch_shear:
            idx_p = cat(self._stretch_shear, 0)
            rest = np.linalg.norm(x[idx_p[:, 0]] - x[idx_p[:, 1]], axis=-1)
            kw["stretch_shear"] = StretchShearBatch.create(
                idx_p, cat(self._stretch_shear, 1), rest,
                cat(self._stretch_shear, 2), device=dev)
        if self._bend_twist:
            kw["bend_twist"] = BendTwistBatch.create(
                cat(self._bend_twist, 0), q0, cat(self._bend_twist, 1),
                device=dev)
        return kw

    def _rigid_rod_batches(self, dev) -> dict:
        """The stiff rods — chains of equal segment count in one batch,
        each tree in its own (``builders.py:1315-1344``) — and the
        generic rigid batches."""
        kw = {}
        rods_ = []
        if self._direct_rods or self._direct_rod_trees:
            rx, rq = np.stack(self._rb_x), np.stack(self._rb_q)
        by_len: dict = {}
        for spec in self._direct_rods:
            by_len.setdefault(len(spec["bodies"]), []).append(spec)
        for _, specs in sorted(by_len.items()):
            rods_.append(DirectRodBatch.create(
                *(np.stack([sp[k] for sp in specs])
                  for k in ("bodies", "positions")), rx, rq,
                *(np.stack([sp[k] for sp in specs])
                  for k in ("radius", "seg_len", "youngs", "torsion")),
                device=dev))
        for sp in self._direct_rod_trees:
            rods_.append(DirectRodTreeBatch.create(
                sp["bodies"], sp["edges"], sp["positions"], rx, rq,
                sp["radius"], sp["seg_len"], sp["youngs"], sp["torsion"],
                device=dev))
        if rods_:
            kw["direct_rods"] = tuple(rods_)
        if self._rigid_generics:
            kw["rigid_generics"] = tuple(
                GenericRigidBatch.create(fn, bodies, k, device=dev)
                for fn, bodies, k in self._rigid_generics)
        return kw


def _sequences(js) -> dict:
    """The motor joints' target sequences as ``seq_times``,
    ``seq_values`` ``(C, S)`` and ``seq_repeat``, each padded to the
    longest with its last knot repeated; a joint without a sequence holds
    its static target (``builders.py:1151-1177``). Empty when no joint has
    a sequence."""
    seqs = [j.get("sequence") for j in js]
    if all(s is None for s in seqs):
        return {}
    ts, vs = [], []
    for s, j in zip(seqs, js):
        if s is None:
            ts.append(np.zeros((1,)))
            vs.append(np.full((1,), j["target"]))
        else:
            arr = np.asarray(s, np.float64).reshape(-1, 2)
            ts.append(arr[:, 0])
            vs.append(arr[:, 1])
    smax = max(len(t) for t in ts)
    return dict(
        seq_times=np.stack([np.pad(t, (0, smax - len(t)), mode="edge")
                            for t in ts]),
        seq_values=np.stack([np.pad(v, (0, smax - len(v)), mode="edge")
                             for v in vs]),
        seq_repeat=np.array([bool(j.get("repeat", False)) for j in js]))
