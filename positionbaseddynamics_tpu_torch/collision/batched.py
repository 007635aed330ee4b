"""Batched broad + narrow collision phase — scalable in body count.

Port of ``positionbaseddynamics_tpu/collision/batched.py``. All candidate
pairs of a shape-kind group are tested at once against their bounding
spheres (the reference's AABB/BVH reject, ``CollisionDetection.h:32-44``),
the active pairs are compacted into a fixed capacity with the drops
counted in an overflow scalar, and one batched narrow phase per shape kind
evaluates every (active pair, vertex) candidate. Contact semantics are
``detection.py``'s; only the scheduling differs.

Every function here works on states flattened to one leading batch axis
``B`` (one scene is ``B = 1``; K planner rollouts are ``B = K``), so each
rollout compacts its own active pairs, as JAX's ``vmap`` of the same code
does. The row helpers :func:`take` and :func:`scatter_add` gather and add
rows of such batched arrays, or of arrays shared by the batch.

:func:`_compact` scatters each active row to its slot in a ``capacity +
1`` buffer and slices the spill slot off: no host sync, the stable
active-first order of JAX's ``mode="drop"`` scatter.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import quaternion as quat
from ..ops.mathutils import dot3, sqrt_rn
from .sdf import SDFShape

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Rows of batched arrays
# ---------------------------------------------------------------------------


def take(a: Tensor, idx: Tensor, shared_dims: Optional[int]) -> Tensor:
    """Rows ``idx (B, *I)`` of ``a``: ``a`` is shared, ``(R, *T)`` with
    ``a.dim() == shared_dims``, or batched, ``(B or 1, R, *T)`` (always
    when ``shared_dims`` is None). Returns ``(B, *I, *T)``."""
    if shared_dims is not None and a.dim() == shared_dims:
        return a[idx]
    b = idx.shape[0]
    if a.shape[0] != b:
        a = a.expand(b, *a.shape[1:])
    tail = a.shape[2:]
    a2 = a.reshape(b, a.shape[1], -1)
    flat = idx.reshape(b, -1, 1).expand(-1, -1, a2.shape[2])
    return torch.gather(a2, 1, flat).reshape(*idx.shape, *tail)


def scatter_add(a: Tensor, idx: Tensor, src: Tensor) -> Tensor:
    """``a (B, R, *T)`` with ``src (B, K, *T)`` added at rows ``idx (B,
    K)``, row after row as JAX's ``a.at[idx].add(src)``."""
    b, r = a.shape[:2]
    a2 = a.reshape(b, r, -1)
    s2 = src.reshape(b, src.shape[1], -1)
    flat = idx[..., None].expand(-1, -1, a2.shape[2])
    return a2.scatter_add(1, flat, s2).reshape(a.shape)


def flat_contacts(c, nd: int):
    """Contact buffer ``c`` (a dataclass of ``(*lead, K, ...)`` fields)
    with its fields flattened to one batch axis, given ``nd``, the number
    of the state's leading axes (0 for one scene); ``overflow`` kept."""
    def f(a):
        if a is None:
            return None
        return a[None] if nd == 0 else a.reshape(-1, *a.shape[nd:])

    return dataclasses.replace(c, **{
        k.name: f(getattr(c, k.name)) for k in dataclasses.fields(c)
        if k.name != "overflow"})


def _compact(active: Tensor, capacity: int, n: int):
    """Stable compaction of the active mask ``(B, n)`` to ``capacity``
    slots, original order kept (``batched.py:198-215``). Returns ``(sel
    (B, cap), act (B, cap), n_dropped (B,))``; a slot past the active rows
    points at row ``n − 1`` with ``act`` False."""
    b = active.shape[0]
    if capacity >= n:
        return (torch.arange(n, device=active.device).expand(b, n), active,
                torch.zeros((b,), dtype=torch.float32, device=active.device))
    pos = torch.cumsum(active.to(torch.int64), dim=1) - 1
    tgt = torch.where(active & (pos < capacity), pos,
                      torch.full_like(pos, capacity))
    sel = torch.full((b, capacity + 1), n, dtype=torch.int64,
                     device=active.device)
    sel = sel.scatter(1, tgt, torch.arange(n, device=active.device
                                           ).expand(b, n))[:, :capacity]
    act = sel < n
    sel = torch.clamp_max(sel, n - 1)
    n_active = torch.sum(active.to(torch.float32), dim=1)
    dropped = torch.clamp_min(n_active - capacity, 0.0)
    return sel, act, dropped


def _norm(v: Tensor) -> Tensor:
    return sqrt_rn(dot3(v, v))


def _t(m: Tensor) -> Tensor:
    return m.transpose(-1, -2)


def _group_key(shape: SDFShape):
    """Shapes that can share one batched narrow phase: same kind and, for
    the grid kinds, the same resolution."""
    gv = shape.grid_values
    return (shape.kind,
            None if gv is None else tuple(gv.shape),
            None if shape.params is None else int(shape.params.numel()))


def _frames(colliders, idxs):
    """Body→shape frames ``(M, 3, 3)`` and ``(M, 3)`` of the colliders,
    the identity where a collider has none."""
    fr = np.stack([
        np.asarray(colliders[c].frame_rot.cpu(), np.float32)
        if colliders[c].frame_rot is not None
        else np.eye(3, dtype=np.float32) for c in idxs])
    ft = np.stack([
        np.asarray(colliders[c].frame_t.cpu(), np.float32)
        if colliders[c].frame_t is not None
        else np.zeros(3, np.float32) for c in idxs])
    return fr, ft


def _tensors(obj, device):
    """``obj`` (a frozen dataclass) with its tensors on ``device``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (Tensor, SDFShape)):
            out[f.name] = v.to(device)
        elif isinstance(v, tuple) and v and hasattr(v[0], "to"):
            out[f.name] = tuple(e.to(device) for e in v)
    return dataclasses.replace(obj, **out)


@dataclass(frozen=True)
class RigidPairGroup:
    """All ordered (point side, SDF side) candidate pairs whose SDF side
    shares one shape kind — one batched narrow phase."""

    n_pairs: int
    capacity: int
    pair_i: Tensor = None      # (P,) collider index of the point side
    pair_jj: Tensor = None     # (P,) within-group index of the SDF side
    pair_bi: Tensor = None     # (P,) rigid body of the point side
    pair_bj: Tensor = None     # (P,) rigid body of the SDF side
    reach: Tensor = None       # (P,) broad-phase radius sum (+tolerance)
    rest: Tensor = None        # (P,) restitution product
    fric: Tensor = None        # (P,) friction sum
    shapes: SDFShape = None    # stacked, leading axis Mg
    frame_rot: Tensor = None   # (Mg, 3, 3) body->shape frame rotation
    frame_t: Tensor = None     # (Mg, 3)

    def to(self, device) -> "RigidPairGroup":
        return _tensors(self, device)


@dataclass(frozen=True)
class BatchedRigidColliders:
    """Stacked point-side data shared by all groups, and the per-kind pair
    groups (``batched.py:96-115``): Morton-sorted vertices in 16-vertex
    blocks with their body-frame bounding spheres."""

    vmax: int
    block_size: int = 16
    bmax: int = 0
    verts: Tensor = None       # (M, Vmax, 3) padded body-frame samples
    vmask: Tensor = None       # (M, Vmax) 1 for real vertices
    block_c: Tensor = None     # (M, Bmax, 3) block sphere centres
    block_r: Tensor = None     # (M, Bmax) block radii (-inf padding)
    groups: Tuple = ()

    def to(self, device) -> "BatchedRigidColliders":
        return _tensors(self, device)


def build_batched_rigid(rigid_colliders, rb_pairs, tolerance,
                        pair_capacity=None):
    """Freeze the collider list and the ordered pair list into the batched
    broad-phase structures, in numpy at build time (``batched.py:
    118-196``), on the colliders' device."""
    from .bvh import build_block_spheres

    if not rb_pairs:
        return None
    dev = rigid_colliders[0].shape.params.device
    bs = 16
    m = len(rigid_colliders)
    vmax = max(int(rigid_colliders[i].verts.shape[0])
               for (i, _) in rb_pairs)
    vmax = bs * (-(-vmax // bs))          # round up to whole blocks
    bmax = vmax // bs
    verts = np.zeros((m, vmax, 3), np.float32)
    vmask = np.zeros((m, vmax), np.float32)
    block_c = np.zeros((m, bmax, 3), np.float32)
    block_r = np.full((m, bmax), -np.inf, np.float32)
    for ci, co in enumerate(rigid_colliders):
        if co.verts is not None and co.verts.shape[0]:
            vs, centers, radii = build_block_spheres(
                co.verts.cpu().numpy().astype(np.float32), block_size=bs)
            verts[ci, :len(vs)] = vs
            vmask[ci, :len(vs)] = 1.0
            block_c[ci, :len(centers)] = centers
            block_r[ci, :len(radii)] = radii

    by_key = {}
    for (i, j) in rb_pairs:
        by_key.setdefault(_group_key(rigid_colliders[j].shape),
                          []).append((i, j))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    groups = []
    for key, pairs in sorted(by_key.items(), key=lambda kv: repr(kv[0])):
        js = sorted({j for (_, j) in pairs})
        j_to_jj = {j: k for k, j in enumerate(js)}
        shapes = SDFShape.stack([rigid_colliders[j].shape for j in js])
        fr, ft = _frames(rigid_colliders, js)
        p = len(pairs)
        reach = np.array(
            [rigid_colliders[i].verts_radius
             + rigid_colliders[j].shape_radius + tolerance
             for (i, j) in pairs], np.float32)
        rest = np.array(
            [float(rigid_colliders[i].restitution)
             * float(rigid_colliders[j].restitution)
             for (i, j) in pairs], np.float32)
        fric = np.array(
            [float(rigid_colliders[i].friction)
             + float(rigid_colliders[j].friction)
             for (i, j) in pairs], np.float32)
        cap = pair_capacity if pair_capacity is not None \
            else max(64, 8 * m)
        groups.append(RigidPairGroup(
            n_pairs=p, capacity=int(min(p, cap)),
            pair_i=t([i for (i, _) in pairs], torch.int64),
            pair_jj=t([j_to_jj[j] for (_, j) in pairs], torch.int64),
            pair_bi=t([rigid_colliders[i].body for (i, _) in pairs],
                      torch.int64),
            pair_bj=t([rigid_colliders[j].body for (_, j) in pairs],
                      torch.int64),
            reach=t(reach), rest=t(rest), fric=t(fric), shapes=shapes,
            frame_rot=t(fr), frame_t=t(ft)))
    return BatchedRigidColliders(vmax=vmax, block_size=bs, bmax=bmax,
                                 verts=t(verts), vmask=t(vmask),
                                 block_c=t(block_c), block_r=t(block_r),
                                 groups=tuple(groups))


def _narrow(tolerance, rx, rq, shapes, fr, ft, bi, bj, verts, vm, act):
    """The vertex-level narrow phase of compacted pairs: rows ``(B, C)``
    of pair data, vertices ``(B, C, V, 3)``. Returns ``(verts_w, dist, n,
    mask)`` over ``(B, C, V)`` (``batched.py:227-256``)."""
    ra = quat.to_matrix(take(rq, bi, 2))               # (B, C, 3, 3)
    verts_w = (torch.matmul(verts, _t(ra))
               + take(rx, bi, 2)[..., None, :])
    rb = quat.to_matrix(take(rq, bj, 2))
    xl = torch.matmul(verts_w - take(rx, bj, 2)[..., None, :], rb)
    xl = torch.matmul(xl, _t(fr)) + ft[..., None, :]
    dist = shapes.distance(xl) - tolerance
    nl = shapes.normal(xl)
    n = torch.matmul(torch.matmul(nl, fr), _t(rb))
    mask = ((dist < 0.0) & (dot3(n, n) > 0.5) & vm & act[..., None])
    return verts_w, dist, n, mask


def _flat_rows(a: Tensor, c: int, nv: int) -> Tensor:
    """Per-pair ``(B, C)`` values repeated over ``nv`` vertices, ``(B,
    C·nv)``."""
    return a[..., None].expand(a.shape[0], c, nv).reshape(a.shape[0],
                                                          c * nv)


def detect_rigid_batched(bc: BatchedRigidColliders, tolerance, rx, rq, rv,
                         rom, inv_mass, inv_iw, init_rows):
    """Batched rb–rb detection over ``(B, R, ...)`` body arrays: returns
    ``(contact rows (B, K), overflow (B,))`` (``batched.py:218-316``).
    ``init_rows`` is ``detection.init_rb_contact_rows``."""
    b = rx.shape[0]
    rows = []
    overflow = torch.zeros((b,), dtype=torch.float32, device=rx.device)
    for g in bc.groups:
        d = _norm(rx[:, g.pair_bi] - rx[:, g.pair_bj])   # (B, P)
        active = d < g.reach
        sel, act, dropped = _compact(active, g.capacity, g.n_pairs)
        overflow = overflow + dropped
        i_sel, jj = g.pair_i[sel], g.pair_jj[sel]
        bi, bj = g.pair_bi[sel], g.pair_bj[sel]
        c = sel.shape[1]
        if bc.bmax <= 2:
            # small point clouds: every vertex of each compacted pair
            nv = bc.vmax
            vw, dist, n, mask = _narrow(
                tolerance, rx, rq, g.shapes.take(jj), g.frame_rot[jj],
                g.frame_t[jj], bi, bj, bc.verts[i_sel],
                bc.vmask[i_sel] > 0.5, act)
            rest, fric = g.rest[sel], g.fric[sel]
        else:
            # the reference's kd-sphere predicate over all (pair, block)
            # candidates, then only surviving blocks' vertices
            fr, ft = g.frame_rot[jj], g.frame_t[jj]
            ra = quat.to_matrix(take(rq, bi, 2))
            cw = (torch.matmul(bc.block_c[i_sel], _t(ra))
                  + take(rx, bi, 2)[..., None, :])
            rb = quat.to_matrix(take(rq, bj, 2))
            cl = torch.matmul(cw - take(rx, bj, 2)[..., None, :], rb)
            cl = torch.matmul(cl, _t(fr)) + ft[..., None, :]
            dist_b = g.shapes.take(jj).distance(cl) - tolerance
            hit = (dist_b < bc.block_r[i_sel]) & act[..., None]
            n_cand = c * bc.bmax
            cap2 = int(min(n_cand, max(128, 2 * g.capacity)))
            sel2, act2, dropped2 = _compact(hit.reshape(b, n_cand), cap2,
                                            n_cand)
            overflow = overflow + dropped2
            pb = torch.div(sel2, bc.bmax, rounding_mode="floor")
            blk = sel2 - pb * bc.bmax
            nv = bc.block_size
            vidx = (blk[..., None] * nv
                    + torch.arange(nv, device=rx.device))
            i2 = torch.gather(i_sel, 1, pb)
            jj2 = torch.gather(jj, 1, pb)
            s2 = torch.gather(sel, 1, pb)
            bi, bj = torch.gather(bi, 1, pb), torch.gather(bj, 1, pb)
            vw, dist, n, mask = _narrow(
                tolerance, rx, rq, g.shapes.take(jj2), g.frame_rot[jj2],
                g.frame_t[jj2], bi, bj, bc.verts[i2[..., None], vidx],
                bc.vmask[i2[..., None], vidx] > 0.5, act2)
            rest, fric = g.rest[s2], g.fric[s2]
            c = cap2
        k = c * nv
        rows.append(init_rows(
            _flat_rows(bi, c, nv), _flat_rows(bj, c, nv),
            vw.reshape(b, k, 3), (vw - dist[..., None] * n).reshape(b, k, 3),
            n.reshape(b, k, 3), mask.reshape(b, k), _flat_rows(rest, c, nv),
            _flat_rows(fric, c, nv), rx, rv, rom, inv_mass, inv_iw))
    return rows, overflow


# ---------------------------------------------------------------------------
# particle group vs rigid colliders
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParticlePairGroup:
    """One particle group × all same-kind rigid SDF colliders."""

    offset: int
    count: int
    n_col: int
    capacity: int
    bodies: Tensor = None      # (Mg,) rigid body index per collider
    reach: Tensor = None       # (Mg,) shape radius + tolerance
    rest: Tensor = None        # (Mg,) restitution product
    fric: Tensor = None        # (Mg,) friction sum
    shapes: SDFShape = None    # stacked
    frame_rot: Tensor = None   # (Mg, 3, 3)
    frame_t: Tensor = None     # (Mg, 3)

    def to(self, device) -> "ParticlePairGroup":
        return _tensors(self, device)


def build_batched_particles(particle_groups, rigid_colliders, tolerance,
                            col_capacity=None):
    """Per particle group and shape kind, one :class:`ParticlePairGroup`
    over all colliders of that kind (``batched.py:343-389``)."""
    if not (particle_groups and rigid_colliders):
        return ()
    dev = rigid_colliders[0].shape.params.device
    out = []
    by_key = {}
    for ci, co in enumerate(rigid_colliders):
        by_key.setdefault(_group_key(co.shape), []).append(ci)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    for pg in particle_groups:
        for key, cols in sorted(by_key.items(), key=lambda kv: repr(kv[0])):
            fr, ft = _frames(rigid_colliders, cols)
            mg = len(cols)
            cap = col_capacity if col_capacity is not None \
                else max(8, mg // 4)
            out.append(ParticlePairGroup(
                offset=pg.offset, count=pg.count, n_col=mg,
                capacity=int(min(mg, cap)),
                bodies=t([rigid_colliders[c].body for c in cols],
                         torch.int64),
                reach=t(np.array([rigid_colliders[c].shape_radius
                                  + tolerance for c in cols], np.float32)),
                rest=t(np.array([float(pg.restitution)
                                 * float(rigid_colliders[c].restitution)
                                 for c in cols], np.float32)),
                fric=t(np.array([float(pg.friction)
                                 + float(rigid_colliders[c].friction)
                                 for c in cols], np.float32)),
                shapes=SDFShape.stack([rigid_colliders[c].shape
                                       for c in cols]),
                frame_rot=t(fr), frame_t=t(ft)))
    return tuple(out)


def detect_particles_batched(pg_groups, tolerance, px, pv, p_inv_mass, rx,
                             rq, rv, rom, inv_mass, inv_iw, init_rows):
    """Batched particle–rigid detection over ``(B, N, 3)`` particles and
    ``(B, R, ...)`` bodies: returns ``(contact rows, overflow (B,))``
    (``batched.py:392-457``)."""
    b = px.shape[0]
    rows = []
    overflow = torch.zeros((b,), dtype=torch.float32, device=px.device)
    for g in pg_groups:
        sl = slice(g.offset, g.offset + g.count)
        x, v = px[:, sl], pv[:, sl]
        w = p_inv_mass[..., sl]
        center = torch.mean(x, dim=1)                         # (B, 3)
        dx = x - center[:, None]
        group_r = sqrt_rn(torch.amax(dot3(dx, dx), dim=1))
        d = _norm(center[:, None] - rx[:, g.bodies])
        active = d < group_r[:, None] + g.reach
        sel, act, dropped = _compact(active, g.capacity, g.n_col)
        overflow = overflow + dropped

        bj = g.bodies[sel]                                    # (B, C)
        c = sel.shape[1]
        rb = quat.to_matrix(take(rq, bj, 2))
        xl = torch.matmul(x[:, None] - take(rx, bj, 2)[..., None, :], rb)
        fr, ft = g.frame_rot[sel], g.frame_t[sel]
        xl = torch.matmul(xl, _t(fr)) + ft[..., None, :]
        shapes = g.shapes.take(sel)
        dist = shapes.distance(xl) - tolerance
        nl = shapes.normal(xl)
        n = torch.matmul(torch.matmul(nl, fr), _t(rb))
        wb = w.expand(b, g.count) if w.dim() == 2 else w[None].expand(
            b, g.count)
        mask = ((dist < 0.0) & (dot3(n, n) > 0.5) & act[..., None]
                & ((wb[:, None] > 0.0)
                   | (inv_mass[bj][..., None] > 0.0)))
        cp1 = x[:, None] - dist[..., None] * n

        k = c * g.count
        idx = torch.arange(g.offset, g.offset + g.count,
                           device=px.device).expand(b, c, g.count)
        rows.append(init_rows(
            idx.reshape(b, k), _flat_rows(bj, c, g.count),
            x[:, None].expand(b, c, g.count, 3).reshape(b, k, 3),
            cp1.reshape(b, k, 3), n.reshape(b, k, 3), mask.reshape(b, k),
            _flat_rows(g.rest[sel], c, g.count),
            _flat_rows(g.fric[sel], c, g.count),
            v[:, None].expand(b, c, g.count, 3).reshape(b, k, 3),
            wb[:, None].expand(b, c, g.count).reshape(b, k),
            rx, rv, rom, inv_mass, inv_iw))
    return rows, overflow
