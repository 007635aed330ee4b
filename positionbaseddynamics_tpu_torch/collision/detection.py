"""Collision detection pipeline — fixed capacity, masked, no host sync.

Port of ``positionbaseddynamics_tpu/collision/detection.py``, the
reference's ``DistanceFieldCollisionDetection`` (``Simulation/
DistanceFieldCollisionDetection.cpp:26-199``): every candidate
(point source, SDF target) pair is enumerated at build time and evaluated
as one dense masked block, so the contact arrays have a fixed capacity and
a validity mask.

Contact semantics follow the reference: a point ``x`` collides when
``sdf(x) − tolerance < 0`` (``:713-728``); the contact point on the SDF
body is ``x − dist·n``; restitution is the product and friction the sum of
the two bodies' coefficients (``:118-119``).

JAX gates each unrolled pair's narrow phase with ``lax.cond``; here every
pair's narrow phase is computed and ``torch.where`` keeps it where the gate
holds and the pair's ``empty`` rows elsewhere, so a gated-off pair gives
exactly JAX's empty rows and nothing of the unselected branch leaks.

States may carry leading rollout axes (``(K, R, 3)`` bodies, ``(K, N, 3)``
particles); detection flattens them to one batch axis, computes every
rollout's contacts with one set of launches, and returns contact fields
with the state's leading axes: ``(*lead, rows, ...)``.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import quaternion as quat
from ..ops.mathutils import cross3, dot3, sqrt_rn
from .batched import _compact, _tensors, take
from .sdf import SDFShape

Tensor = torch.Tensor


@dataclass(frozen=True)
class RigidCollider:
    """One rigid body's collision geometry: an SDF in the body frame plus a
    surface point cloud used when this body is the point side of an rb–rb
    test. ``frame_rot``/``frame_t`` map a mesh-built body's principal frame
    to its shape's mesh frame (``p_shape = frame_rot @ p_body + frame_t``);
    ``block_centers``/``block_radii`` are the fixed-depth bounding-sphere
    hierarchy over ``verts`` (``collision/bvh.py``)."""

    body: int
    shape: SDFShape = None
    verts: Tensor = None          # (V, 3) body-frame surface samples
    restitution: Tensor = None    # scalar
    friction: Tensor = None       # scalar
    frame_rot: Tensor = None      # (3, 3)
    frame_t: Tensor = None        # (3,)
    verts_radius: float = float("inf")
    shape_radius: float = float("inf")
    block_centers: Tensor = None  # (B, 3)
    block_radii: Tensor = None    # (B,)

    def to(self, device) -> "RigidCollider":
        return _tensors(self, device)


@dataclass(frozen=True)
class ParticleGroupCollider:
    """A particle range (triangle/tet model) tested against rigid SDFs —
    the ``collisionDetectionRBSolid`` path. ``morton_perm`` orders the
    group's rest positions along the Morton curve, so that each step's
    positions fall into compact blocks whose spheres gate the pair."""

    offset: int
    count: int
    restitution: Tensor = None
    friction: Tensor = None
    morton_perm: Tensor = None
    block_size: int = 32

    def to(self, device) -> "ParticleGroupCollider":
        return _tensors(self, device)


def _lead_fields(cls, rows: dict, lead) -> object:
    """``cls`` from batched ``(B, K, ...)`` row tensors, reshaped to the
    state's leading axes."""
    return cls(**{k: None if v is None
                  else v.reshape(tuple(lead) + tuple(v.shape[1:]))
                  for k, v in rows.items()})


@dataclass(frozen=True)
class RigidContacts:
    """Fixed-capacity rb–rb contact buffer, one row per candidate vertex
    (the 3×5 ``constraintInfo`` of ``init_RigidBodyContactConstraint``,
    ``PositionBasedRigidBodyDynamics.cpp:2221-2287``, as arrays). Fields
    are ``(*lead, K, ...)``; ``overflow`` (``*lead``) counts the active
    pairs the batched broad phase dropped, None on the unrolled path."""

    body0: Tensor       # (K,) int64 — the point-side body
    body1: Tensor       # (K,) int64 — the SDF-side body
    cp0: Tensor         # (K, 3) contact point on body 0 (world)
    cp1: Tensor         # (K, 3) contact point on body 1 (world)
    normal: Tensor      # (K, 3)
    tangent: Tensor     # (K, 3)
    nkn_inv: Tensor     # (K,) 1 / nᵀKn
    p_max: Tensor       # (K,) max tangent impulse
    goal_u_n: Tensor    # (K,) target normal velocity
    restitution: Tensor
    friction: Tensor
    mask: Tensor        # (K,) float 0/1
    overflow: Tensor = None


@dataclass(frozen=True)
class ParticleRigidContacts:
    """Fixed-capacity particle–rigid contact buffer
    (``init_ParticleRigidBodyContactConstraint``,
    ``PositionBasedRigidBodyDynamics.cpp:2386-2451``)."""

    particle: Tensor    # (K,) int64
    body1: Tensor       # (K,) int64
    cp0: Tensor         # (K, 3)
    cp1: Tensor         # (K, 3)
    normal: Tensor
    tangent: Tensor
    nkn_inv: Tensor
    p_max: Tensor
    goal_u_n: Tensor
    friction: Tensor
    mask: Tensor
    overflow: Tensor = None


@functools.lru_cache(maxsize=None)
def _eye3(device: torch.device) -> Tensor:
    return torch.eye(3, dtype=torch.float32, device=device)


def _skew(v: Tensor) -> Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


def _compute_matrix_k(r: Tensor, inv_mass: Tensor, inv_iw: Tensor) -> Tensor:
    """``K = 1/m·I + r̃ᵀ J⁻¹ r̃`` for lever arms ``r (..., 3)``
    (``computeMatrixK``, ``PositionBasedRigidBodyDynamics.h:13``)."""
    rx = _skew(r)
    k = torch.matmul(torch.matmul(rx, inv_iw), -rx)
    return k + inv_mass[..., None, None] * _eye3(r.device)


def _quad(a: Tensor, m: Tensor, b: Tensor) -> Tensor:
    """``aᵀ M b`` over the leading axes."""
    return dot3(a, torch.matmul(m, b[..., None])[..., 0])


def _tangent(u_rel: Tensor, n: Tensor):
    """``(u_rel·n, t)``: the normal velocity and the unit tangent of the
    relative velocity (left as it is when shorter than 1e-3)."""
    u_rel_n = dot3(n, u_rel)
    t = u_rel - u_rel_n[..., None] * n
    tl2 = dot3(t, t)
    t = torch.where((tl2 > 1e-6)[..., None],
                    t / sqrt_rn(torch.clamp_min(tl2, 1e-30))[..., None], t)
    return u_rel_n, t


def _k_terms(u_rel, u_rel_n, n, t, kk, rest):
    """``(nkn, nkn_inv, p_max, goal)`` of rows with the summed K."""
    nkn = _quad(n, kk, n)
    tkt = _quad(t, kk, t)
    zero = torch.zeros_like(nkn)
    nkn_inv = torch.where(nkn > 1e-9, 1.0 / torch.clamp_min(nkn, 1e-30),
                          zero)
    p_max = torch.where(tkt > 1e-9,
                        dot3(u_rel, t) / torch.clamp_min(tkt, 1e-30), zero)
    goal = torch.where(u_rel_n < 0.0, -rest * u_rel_n, zero)
    return nkn, nkn_inv, p_max, goal


def init_rb_contact_rows(b0, b1, cp0, cp1, n, mask, rest, fric,
                         rx, rv, rom, inv_mass, inv_iw) -> dict:
    """Row-wise rb–rb contact-info init (``detection.py:159-197``) on
    batched rows: ``b0``/``b1 (B, K)`` body indices, ``cp*``/``n (B, K,
    3)``, ``mask (B, K)`` bool, ``rest``/``fric`` per row or scalar;
    bodies ``(B, R, ...)``, ``inv_mass (R,)`` shared. Returns the
    :class:`RigidContacts` fields as a dict."""
    r0 = cp0 - take(rx, b0, 2)
    r1 = cp1 - take(rx, b1, 2)
    u_rel = (take(rv, b0, 2) + cross3(take(rom, b0, 2), r0)
             - take(rv, b1, 2) - cross3(take(rom, b1, 2), r1))
    u_rel_n, t = _tangent(u_rel, n)
    kk = (_compute_matrix_k(r0, inv_mass[b0], take(inv_iw, b0, 3))
          + _compute_matrix_k(r1, inv_mass[b1], take(inv_iw, b1, 3)))
    nkn, nkn_inv, p_max, goal = _k_terms(u_rel, u_rel_n, n, t, kk, rest)
    shape = mask.shape
    return dict(
        body0=b0, body1=b1, cp0=cp0, cp1=cp1, normal=n, tangent=t,
        nkn_inv=nkn_inv, p_max=p_max, goal_u_n=goal,
        restitution=torch.as_tensor(rest, device=n.device).expand(shape),
        friction=torch.as_tensor(fric, device=n.device).expand(shape),
        mask=mask.to(torch.float32) * (nkn > 1e-9))


def init_particle_rb_contact_rows(idx, b1, x, cp1, n, mask, rest, fric,
                                  v, w, rx, rv, rom, inv_mass, inv_iw
                                  ) -> dict:
    """Row-wise particle–rigid contact-info init (``detection.py:
    200-229``) on batched rows, as :func:`init_rb_contact_rows`; ``w (B,
    K)`` the particles' inverse masses. Returns the
    :class:`ParticleRigidContacts` fields as a dict."""
    r1 = cp1 - take(rx, b1, 2)
    u_rel = v - (take(rv, b1, 2) + cross3(take(rom, b1, 2), r1))
    u_rel_n, t = _tangent(u_rel, n)
    kmat = _compute_matrix_k(r1, inv_mass[b1], take(inv_iw, b1, 3))
    kmat = kmat + w[..., None, None] * _eye3(n.device)
    nkn, nkn_inv, p_max, goal = _k_terms(u_rel, u_rel_n, n, t, kmat, rest)
    return dict(
        particle=idx, body1=b1, cp0=x, cp1=cp1, normal=n, tangent=t,
        nkn_inv=nkn_inv, p_max=p_max, goal_u_n=goal,
        friction=torch.as_tensor(fric, device=n.device).expand(mask.shape),
        mask=mask.to(torch.float32) * (nkn > 1e-9))


def _cat_rows(rows):
    """Row dicts concatenated along the row axis."""
    return {k: torch.cat([r[k] for r in rows], dim=1) for k in rows[0]}


def contacts_overflow(*contact_buffers) -> Optional[Tensor]:
    """Sum of the overflow counters of the buffers carrying one, None
    when none does — the loud-capacity contract surfaced to
    ``SimState.overflow``."""
    total = None
    for c in contact_buffers:
        if c is not None and getattr(c, "overflow", None) is not None:
            total = c.overflow if total is None else total + c.overflow
    return total


def _flat_bodies(rigid):
    """The bodies of ``rigid`` flattened to one batch axis: ``(lead, rx,
    rq, rv, rom, inv_mass, inv_iw)``, ``inv_iw`` zero for static bodies."""
    lead = tuple(rigid.x.shape[:-2])
    nr = rigid.x.shape[-2]
    _, inv_iw = rigid.inertia_world()
    inv_iw = inv_iw * (rigid.inv_mass > 0.0)[..., None, None]

    def f(a, tail):
        return a.reshape(-1, nr, *tail)

    return (lead, f(rigid.x, (3,)), f(rigid.q, (4,)), f(rigid.v, (3,)),
            f(rigid.omega, (3,)), rigid.inv_mass, f(inv_iw, (3, 3)))


@dataclass(frozen=True)
class CollisionPipeline:
    """All collision objects of a scene and the static candidate pair list
    (``detection.py:244-546``): ``rb_pairs`` the ordered (point collider,
    SDF collider) pairs; ``solid_pairs`` ``((point_offset, point_count,
    point_friction), TetCollider)``; ``broad_phase`` ``"unrolled"`` (one
    gated block a pair, the reference's pair order for Gauss-Seidel
    parity) or ``"batched"`` (compacted active pairs, one narrow phase a
    shape kind)."""

    rigid_colliders: Tuple = ()
    particle_groups: Tuple = ()
    tolerance: float = 0.01
    rb_pairs: Tuple = ()
    solid_pairs: Tuple = ()
    broad_phase: str = "unrolled"
    rb_batched: object = None
    pg_batched: Tuple = ()

    @staticmethod
    def create(rigid_colliders=(), particle_groups=(), tolerance=0.01,
               rb_pairs=None, solid_pairs=(), broad_phase="auto",
               pair_capacity=None):
        """``broad_phase``: "unrolled" | "batched" | "auto" (batched once
        the unrolled gates would number more than 24). ``pair_capacity``
        caps the batched active-pair list per shape-kind group (default
        ``max(64, 8·M)``)."""
        from .batched import build_batched_particles, build_batched_rigid

        rigid_colliders = tuple(rigid_colliders)
        if rb_pairs is None:
            n = len(rigid_colliders)
            rb_pairs = tuple(
                (i, j) for i in range(n) for j in range(n)
                if i != j and rigid_colliders[i].verts is not None)
        rb_pairs = tuple(rb_pairs)
        particle_groups = tuple(particle_groups)
        if broad_phase == "auto":
            n_unrolled = (len(rb_pairs)
                          + len(particle_groups) * len(rigid_colliders))
            broad_phase = "batched" if n_unrolled > 24 else "unrolled"
        rb_batched = None
        pg_batched = ()
        if broad_phase == "batched":
            rb_batched = build_batched_rigid(
                rigid_colliders, rb_pairs, tolerance,
                pair_capacity=pair_capacity)
            pg_batched = build_batched_particles(
                particle_groups, rigid_colliders, tolerance)
        return CollisionPipeline(
            rigid_colliders=rigid_colliders,
            particle_groups=particle_groups, tolerance=tolerance,
            rb_pairs=rb_pairs, solid_pairs=tuple(solid_pairs),
            broad_phase=broad_phase, rb_batched=rb_batched,
            pg_batched=pg_batched)

    def to(self, device) -> "CollisionPipeline":
        """The same pipeline with every tensor on ``device``."""
        return dataclasses.replace(
            self,
            rigid_colliders=tuple(c.to(device)
                                  for c in self.rigid_colliders),
            particle_groups=tuple(g.to(device)
                                  for g in self.particle_groups),
            solid_pairs=tuple((pg, tc.to(device))
                              for pg, tc in self.solid_pairs),
            rb_batched=(None if self.rb_batched is None
                        else self.rb_batched.to(device)),
            pg_batched=tuple(g.to(device) for g in self.pg_batched))

    @property
    def device(self) -> Optional[torch.device]:
        for c in self.rigid_colliders:
            return c.shape.params.device
        for _, tc in self.solid_pairs:
            return tc.tets.device
        return None

    @property
    def active(self) -> bool:
        return bool(self.rb_pairs) or bool(self.solid_pairs) or (
            bool(self.particle_groups) and bool(self.rigid_colliders))

    def detect_solids(self, x, v, inv_mass):
        """Particle–tet narrow phase (``collisionDetectionSolidSolid``),
        once a step before the substeps (``solid.py``)."""
        from .solid import detect_solid_contacts
        return detect_solid_contacts(self.solid_pairs, x, v, inv_mass)

    # -- narrow phase -------------------------------------------------------

    @staticmethod
    def _world_to_local(co: RigidCollider, rx, rq, pts_w):
        """World points ``(B, ..., 3)`` into ``co``'s shape frame."""
        r = quat.to_matrix(rq[:, co.body])                   # (B, 3, 3)
        extra = pts_w.dim() - 2
        r = r.reshape(r.shape[0], *([1] * (extra - 1)), 3, 3)
        xb = rx[:, co.body].reshape(rx.shape[0], *([1] * extra), 3)
        xl = torch.matmul(pts_w - xb, r)
        if co.frame_rot is not None:
            xl = torch.matmul(xl, co.frame_rot.T) + co.frame_t
        return xl

    @staticmethod
    def _local_to_world_dir(co: RigidCollider, rq, d):
        if co.frame_rot is not None:
            d = torch.matmul(d, co.frame_rot)
        r = quat.to_matrix(rq[:, co.body])
        r = r.reshape(r.shape[0], *([1] * (d.dim() - 3)), 3, 3)
        return torch.matmul(d, r.transpose(-1, -2))

    def detect_rigid(self, rigid) -> Optional[RigidContacts]:
        """rb–rb narrow phase and contact-info init, once a step after the
        substeps (``TimeStepController.cpp:189-196``)."""
        if not self.rb_pairs:
            return None
        lead, rx, rq, rv, rom, inv_mass, inv_iw = _flat_bodies(rigid)
        if self.broad_phase == "batched" and self.rb_batched is not None:
            from .batched import detect_rigid_batched
            rows, of = detect_rigid_batched(
                self.rb_batched, self.tolerance, rx, rq, rv, rom, inv_mass,
                inv_iw, init_rb_contact_rows)
            rows = _cat_rows(rows)
            rows["overflow"] = of
            return _lead_fields(RigidContacts, rows, lead)
        b = rx.shape[0]
        rows = []
        for (ia, ib) in self.rb_pairs:
            ca = self.rigid_colliders[ia]
            cb = self.rigid_colliders[ib]
            k = ca.verts.shape[0]
            ra = quat.to_matrix(rq[:, ca.body])
            verts_w = torch.matmul(ca.verts, ra.transpose(-1, -2)) \
                + rx[:, ca.body, None]
            xl = self._world_to_local(cb, rx, rq, verts_w)
            dist = cb.shape.distance(xl) - self.tolerance
            n = self._local_to_world_dir(cb, rq, cb.shape.normal(xl))
            mask = (dist < 0.0) & (dot3(n, n) > 0.5)
            full = functools.partial(torch.full, (b, k), device=rx.device,
                                     dtype=torch.int64)
            row = init_rb_contact_rows(
                full(ca.body), full(cb.body), verts_w,
                verts_w - dist[..., None] * n, n, mask,
                ca.restitution * cb.restitution, ca.friction + cb.friction,
                rx, rv, rom, inv_mass, inv_iw)
            reach = ca.verts_radius + cb.shape_radius + self.tolerance
            if np.isfinite(reach):
                # bounding-sphere reject (CollisionDetection.h:32-44), then
                # the reference's kd-sphere predicate over the vertex
                # blocks (DistanceFieldCollisionDetection.cpp:226-247)
                gate = sqrt_rn(dot3(rx[:, ca.body] - rx[:, cb.body],
                                    rx[:, ca.body] - rx[:, cb.body])) < reach
                if ca.block_centers is not None and cb.shape is not None:
                    cw = torch.matmul(ca.block_centers, ra.transpose(-1, -2)) \
                        + rx[:, ca.body, None]
                    cl = self._world_to_local(cb, rx, rq, cw)
                    db = cb.shape.distance(cl) - self.tolerance
                    gate = gate & torch.any(db < ca.block_radii, dim=-1)
                row = _gate(row, gate, keep=("body0", "body1"))
            rows.append(row)
        return _lead_fields(RigidContacts, _cat_rows(rows), lead)

    def detect_particles(self, px, pv, p_inv_mass, rigid
                         ) -> Optional[ParticleRigidContacts]:
        """particle–rigid narrow phase and contact init
        (``collisionDetectionRBSolid`` →
        ``init_ParticleRigidBodyContactConstraint``)."""
        if not (self.particle_groups and self.rigid_colliders):
            return None
        lead, rx, rq, rv, rom, inv_mass, inv_iw = _flat_bodies(rigid)
        n_p = px.shape[-2]
        px = px.reshape(-1, n_p, 3)
        pv = pv.reshape(-1, n_p, 3)
        b = px.shape[0]
        if self.broad_phase == "batched":
            from .batched import detect_particles_batched
            rows, of = detect_particles_batched(
                self.pg_batched, self.tolerance, px, pv, p_inv_mass, rx, rq,
                rv, rom, inv_mass, inv_iw, init_particle_rb_contact_rows)
            if not rows:
                return None
            rows = _cat_rows(rows)
            rows["overflow"] = of
            return _lead_fields(ParticleRigidContacts, rows, lead)
        rows = []
        for pg in self.particle_groups:
            sl = slice(pg.offset, pg.offset + pg.count)
            x, v = px[:, sl], pv[:, sl]
            w = p_inv_mass[..., sl].reshape(-1, pg.count).expand(b, pg.count)
            k = pg.count
            idx = torch.arange(pg.offset, pg.offset + k,
                               device=px.device).expand(b, k)
            center = torch.mean(x, dim=1)
            dx = x - center[:, None]
            group_r = sqrt_rn(torch.amax(dot3(dx, dx), dim=1))
            for cb in self.rigid_colliders:
                b1 = cb.body
                xl = self._world_to_local(cb, rx, rq, x)
                dist = cb.shape.distance(xl) - self.tolerance
                n = self._local_to_world_dir(cb, rq, cb.shape.normal(xl))
                mask = ((dist < 0.0) & (dot3(n, n) > 0.5)
                        & ((w > 0.0) | (inv_mass[b1] > 0.0)))
                row = init_particle_rb_contact_rows(
                    idx, torch.full((b, k), b1, dtype=torch.int64,
                                    device=px.device),
                    x, x - dist[..., None] * n, n, mask,
                    pg.restitution * cb.restitution,
                    pg.friction + cb.friction, v, w, rx, rv, rom, inv_mass,
                    inv_iw)
                reach = cb.shape_radius + self.tolerance
                if np.isfinite(reach):
                    dc = center - rx[:, b1]
                    gate = sqrt_rn(dot3(dc, dc)) < group_r + reach
                    if pg.morton_perm is not None and cb.shape is not None:
                        gate = gate & self._block_hit(pg, cb, x, rx, rq)
                    row = _gate(row, gate, keep=("particle", "body1"))
                rows.append(row)
        if not rows:
            return None
        c = _cat_rows(rows)
        # active-first compaction (stable: the Gauss-Seidel sweep order
        # over active rows is kept); dropped actives count in overflow
        k = c["mask"].shape[1]
        cap = int(max(512, k // 4))
        if cap < k:
            n_active = torch.sum(c["mask"], dim=1)
            sel, act, _ = _compact(c["mask"] > 0.5, cap, k)
            c = {name: take(a, sel, None) for name, a in c.items()}
            c["mask"] = c["mask"] * act.to(torch.float32)
            c["overflow"] = torch.clamp_min(n_active - cap, 0.0)
        return _lead_fields(ParticleRigidContacts, c, lead)

    def _block_hit(self, pg, cb, x, rx, rq):
        """The per-step block-sphere gate of a particle group against one
        collider (``detection.py:481-510``): Morton-sorted positions in
        blocks of ``block_size``, their spheres against the SDF, the tail
        vertices tested alone."""
        bs = pg.block_size
        xs = x[:, pg.morton_perm]
        nb = xs.shape[1] // bs
        blocks = xs[:, :nb * bs].reshape(xs.shape[0], nb, bs, 3)
        bc = torch.mean(blocks, dim=2)
        d = blocks - bc[:, :, None]
        br = sqrt_rn(torch.amax(dot3(d, d), dim=-1))
        dist = cb.shape.distance(self._world_to_local(cb, rx, rq, bc)) \
            - self.tolerance
        hit = torch.any(dist < br, dim=-1)
        if xs.shape[1] % bs:
            tl = self._world_to_local(cb, rx, rq, xs[:, nb * bs:])
            hit = hit | torch.any(cb.shape.distance(tl) - self.tolerance
                                  < 0.0, dim=-1)
        return hit


def _gate(row: dict, gate: Tensor, keep) -> dict:
    """JAX's ``lax.cond(gate, narrow, empty)`` on batched rows: the narrow
    rows where ``gate (B,)`` holds, the pair's empty rows (zeros; the index
    fields ``keep`` as they are) elsewhere."""
    out = {}
    for name, a in row.items():
        if name in keep:
            out[name] = a
            continue
        g = gate.reshape(-1, *([1] * (a.dim() - 1)))
        out[name] = torch.where(g, a, torch.zeros((), dtype=a.dtype,
                                                  device=a.device))
    return out
