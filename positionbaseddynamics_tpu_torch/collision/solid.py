"""Solid–solid (particle vs. deformable tet model) collision.

Port of ``positionbaseddynamics_tpu/collision/solid.py``, the reference's
``collisionDetectionSolidSolid`` (``DistanceFieldCollisionDetection.cpp:
361-470``), ``findRefTetAt`` (``:744-814``) and the
``ParticleTetContactConstraint`` solves (``PositionBasedDynamics.cpp:
1172-1340``): a dense masked barycentric point-in-tet test, a rest-space
grid that stores the containing tet of each cell centre (the
``findRefTetAt`` lookup as one gather), the exact closest point on the
rest surface's triangles, and a fixed-capacity masked contact buffer.

Every query works on states flattened to one batch axis ``B``, so K
planner rollouts compact their own candidates, as JAX's ``vmap`` does.
The trace-time thresholds that choose which compaction runs, and so which
candidates a capacity can drop, are JAX's (``_GATE_MIN_PAIRS``,
``_SURF_GATE_MIN_PAIRS``, ``_PRE_GATE_MIN_PTS``); JAX's matrix-product
pre-gate is off (``_PRE_GATE_MXU = False``), so only the component-plane
pre-gate is ported. ``lax.top_k``'s lower-index-first order among equal
keys is kept by a stable sort; ``argmin``/``argmax`` take the first
extreme, as JAX's.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.mathutils import dot3, inv3, sqrt_rn
from .batched import _compact, _tensors, flat_contacts, take
from .sdf import _const

Tensor = torch.Tensor

# the compaction thresholds of solid.py:425-433
_GATE_MIN_PAIRS = 32_000_000
_SURF_GATE_MIN_PAIRS = 16_000_000
_PRE_GATE_MIN_PTS = 512


def _sum3(a, b, c):
    return (a + b) + c


def _mv(m: Tensor, v: Tensor) -> Tensor:
    return torch.matmul(m, v[..., None])[..., 0]


def _weighted4(w: Tensor, pts: Tensor) -> Tensor:
    """``Σ_k w_k · pts_k`` over 4 corners, ``w (..., 4)``, ``pts (..., 4,
    3)``, added in corner order."""
    out = w[..., 0, None] * pts[..., 0, :]
    for k in range(1, 4):
        out = out + w[..., k, None] * pts[..., k, :]
    return out


@dataclass(frozen=True)
class TetCollider:
    """One tet model's solid collision data: its tets, their rest edge
    matrices, the rest-pose surface triangles (queried by exact closest
    point), the rest-space tet-lookup grid, and the Morton blocks of tets
    and surface faces that gate large queries (``solid.py:48-85``)."""

    offset: int                  # particle offset
    count: int                   # particle count
    tets: Tensor = None          # (T, 4) global particle indices
    rest_x0: Tensor = None       # (T, 3) rest position of tet vertex 0
    rest_a: Tensor = None        # (T, 3, 3) rest edge matrix (columns)
    rest_inv_a: Tensor = None    # (T, 3, 3)
    surf_a: Tensor = None        # (F, 3) rest surface triangle corners
    surf_b: Tensor = None        # (F, 3)
    surf_c: Tensor = None        # (F, 3)
    grid_tet: Tensor = None      # (gx, gy, gz) int64
    grid_origin: Tensor = None   # (3,)
    grid_inv_cell: Tensor = None  # (3,)
    restitution: Tensor = None
    friction: Tensor = None
    tet_blocks: Tensor = None    # (Bt, bs) local tet indices
    surf_blocks: Tensor = None   # (Bf, bs) local face indices
    surf_block_c: Tensor = None  # (Bf, 3)
    surf_block_r: Tensor = None  # (Bf,)
    k_surf_blocks: int = 8

    def to(self, device) -> "TetCollider":
        return _tensors(self, device)

    @staticmethod
    def create(offset, count, tets_local, rest_positions, surface_faces,
               restitution=0.1, friction=0.2, sdf_resolution=24,
               grid_resolution=24, cache_dir=None,
               device="cpu") -> "TetCollider":
        """``rest_positions``: the model's build-time (world) rest
        positions (count, 3); ``tets_local``/``surface_faces`` local
        indices. ``sdf_resolution``/``cache_dir`` are accepted as JAX's
        (``solid.py:87-94``) and unused: exact surface queries replace a
        baked grid. Built in float64 numpy as JAX's, then float32 on
        ``device``."""
        from .bvh import morton_order

        rest = np.asarray(rest_positions, np.float64)
        tets = np.asarray(tets_local, np.int64).reshape(-1, 4)
        sf = np.asarray(surface_faces, np.int64).reshape(-1, 3)
        a = np.stack([rest[tets[:, 1]] - rest[tets[:, 0]],
                      rest[tets[:, 2]] - rest[tets[:, 0]],
                      rest[tets[:, 3]] - rest[tets[:, 0]]], axis=-1)
        inv_a = np.linalg.inv(a)

        # rest-space tet lookup grid: min-barycentric-error tet per cell
        # centre (findRefTetAt's error metric, cpp:793-806)
        lo = rest.min(0) - 0.05 * (rest.max(0) - rest.min(0))
        hi = rest.max(0) + 0.05 * (rest.max(0) - rest.min(0))
        res = np.full(3, int(grid_resolution))
        axes = [np.linspace(lo[i], hi[i], res[i]) for i in range(3)]
        gx, gy, gz = np.meshgrid(*axes, indexing="ij")
        cells = np.stack([gx, gy, gz], -1).reshape(-1, 3)
        best = np.zeros(cells.shape[0], np.int32)
        best_err = np.full(cells.shape[0], np.inf)
        chunk = 256

        def chunk_best(s):
            ia = inv_a[s:s + chunk]
            x0 = rest[tets[s:s + chunk, 0]]
            bary = np.einsum("tij,gtj->gti", ia,
                             cells[:, None, :] - x0[None])
            err = (np.maximum(0.0, -bary).sum(-1)
                   + np.maximum(0.0, bary.sum(-1) - 1.0))
            am = err.argmin(1)
            return s, am, err[np.arange(len(cells)), am]

        # numpy releases the GIL in these loops: the chunks run on threads,
        # and their minima merge in chunk order, as one loop would
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for s, am, e in pool.map(chunk_best, range(0, len(tets), chunk)):
                upd = e < best_err
                best[upd] = (s + am[upd]).astype(np.int32)
                best_err[upd] = e[upd]

        bs = 16
        t_cent = rest[tets].mean(axis=1)
        t_order = morton_order(t_cent)
        n_tb = -(-len(tets) // bs)
        t_pad = np.concatenate(
            [t_order, np.repeat(t_order[-1:], n_tb * bs - len(t_order))])
        tet_blocks = t_pad.reshape(n_tb, bs)

        f_cent = (rest[sf[:, 0]] + rest[sf[:, 1]] + rest[sf[:, 2]]) / 3.0
        f_order = morton_order(f_cent)
        n_fb = -(-len(sf) // bs)
        f_pad = np.concatenate(
            [f_order, np.repeat(f_order[-1:], n_fb * bs - len(f_order))])
        surf_blocks = f_pad.reshape(n_fb, bs)
        corners = np.stack([rest[sf[f_pad, 0]], rest[sf[f_pad, 1]],
                            rest[sf[f_pad, 2]]], 1).reshape(n_fb, bs * 3, 3)
        sb_c = corners.mean(axis=1)
        sb_r = np.linalg.norm(corners - sb_c[:, None, :], axis=-1).max(1)

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        def i64(v):
            return torch.as_tensor(np.asarray(v, np.int64), device=device)

        return TetCollider(
            offset=int(offset), count=int(count),
            tets=i64(tets + offset),
            rest_x0=f32(rest[tets[:, 0]]), rest_a=f32(a),
            rest_inv_a=f32(inv_a),
            surf_a=f32(rest[sf[:, 0]]), surf_b=f32(rest[sf[:, 1]]),
            surf_c=f32(rest[sf[:, 2]]),
            tet_blocks=i64(tet_blocks), surf_blocks=i64(surf_blocks),
            surf_block_c=f32(sb_c), surf_block_r=f32(sb_r),
            grid_tet=i64(best.reshape(tuple(res))),
            grid_origin=f32(lo),
            grid_inv_cell=f32((res - 1) / np.maximum(hi - lo, 1e-12)),
            restitution=f32(restitution), friction=f32(friction))

    def closest_surface_point_gated(self, pts: Tensor, need=None,
                                    refine_capacity=None):
        """Exact closest rest-surface point of ``pts (B, P, 3)`` through the
        static face-block gate (``solid.py:173-228``): the
        ``k_surf_blocks`` blocks of smallest lower bound first, then every
        (point, block) pair that could still hold a closer face, compacted
        to a capacity whose drops are returned. ``need (B, P)`` masks the
        points that take part in the refinement."""
        b, p = pts.shape[:2]
        if (self.surf_blocks is None
                or self.surf_blocks.shape[0] <= self.k_surf_blocks
                or p * self.surf_a.shape[0] < _SURF_GATE_MIN_PAIRS):
            return (self.closest_surface_point(pts),
                    torch.zeros((b,), dtype=torch.float32,
                                device=pts.device))
        sb_c, sb_r = self.surf_block_c, self.surf_block_r
        bf = sb_c.shape[0]
        d_b = sqrt_rn(torch.clamp_min(_sum3(*[
            (pts[..., :, None, i] - sb_c[:, i]) ** 2 for i in range(3)]),
            1e-30))                                      # (B, P, Bf)
        lb = d_b - sb_r
        k = self.k_surf_blocks
        topi = torch.sort(lb, dim=-1, stable=True).indices[..., :k]
        cand = self.surf_blocks[topi].reshape(b, p, -1)
        cp, d2min = _closest_on_faces_pairs(
            pts, self.surf_a[cand], self.surf_b[cand], self.surf_c[cand])
        d1 = sqrt_rn(torch.clamp_min(d2min, 0.0))
        chosen = torch.zeros(lb.shape, dtype=torch.bool,
                             device=pts.device).scatter(-1, topi, True)
        rest = (lb < d1[..., None]) & ~chosen
        if need is not None:
            rest = rest & need[..., None]
        cap = int(refine_capacity if refine_capacity is not None
                  else min(p * bf, max(1024, p)))
        sel, act, dropped = _compact(rest.reshape(b, p * bf), cap, p * bf)
        p_id = torch.div(sel, bf, rounding_mode="floor")
        cand2 = self.surf_blocks[sel - p_id * bf]        # (B, C, bs)
        cp2, d22 = _closest_on_faces_pairs(
            take(pts, p_id, None), self.surf_a[cand2], self.surf_b[cand2],
            self.surf_c[cand2])
        d22 = torch.where(act, d22, torch.full_like(d22, float("inf")))
        d2_best = d2min.scatter_reduce(1, p_id, d22, "amin")
        winners = d22 <= torch.gather(d2_best, 1, p_id)
        tgt = torch.where(winners, p_id, torch.full_like(p_id, p))
        cp = torch.cat([cp, torch.zeros_like(cp[:, :1])], dim=1).scatter(
            1, tgt[..., None].expand(-1, -1, 3), cp2)[:, :p]
        return cp, dropped

    def closest_surface_point(self, pts: Tensor) -> Tensor:
        """Exact closest point on the rest surface for ``pts (B, P, 3)``: a
        dense masked (P, F) point–triangle test in component planes
        (Ericson §5.1.5, ``solid.py:230-289``)."""
        a, b, c = self.surf_a, self.surf_b, self.surf_c          # (F, 3)
        abv = [b[:, i] - a[:, i] for i in range(3)]
        acv = [c[:, i] - a[:, i] for i in range(3)]

        def _dot(ev, corner):
            return _sum3(*[ev[i] * (pts[..., :, None, i] - corner[:, i])
                           for i in range(3)])

        d1 = _dot(abv, a)
        d2 = _dot(acv, a)
        d3 = _dot(abv, b)
        d4 = _dot(acv, b)
        d5 = _dot(abv, c)
        d6 = _dot(acv, c)
        reg, v, w, t_ab, t_ac, t_bc = _regions(d1, d2, d3, d4, d5, d6)
        reg_a, reg_b, reg_c, reg_ab, reg_ac, reg_bc = reg
        cand = []
        for i in range(3):
            ai, bi, ci = a[:, i], b[:, i], c[:, i]
            ci_p = ai + v * abv[i] + w * acv[i]
            ci_p = torch.where(reg_bc, bi + t_bc * (ci - bi), ci_p)
            ci_p = torch.where(reg_ac, ai + t_ac * acv[i], ci_p)
            ci_p = torch.where(reg_ab, ai + t_ab * abv[i], ci_p)
            ci_p = torch.where(reg_c, ci.expand_as(ci_p), ci_p)
            ci_p = torch.where(reg_b, bi.expand_as(ci_p), ci_p)
            ci_p = torch.where(reg_a, ai.expand_as(ci_p), ci_p)
            cand.append(ci_p)                                  # (B, P, F)
        d2all = _sum3(*[(pts[..., :, None, i] - cand[i]) ** 2
                        for i in range(3)])
        best = torch.argmin(d2all, dim=-1, keepdim=True)
        return torch.stack([torch.gather(ci, -1, best)[..., 0]
                            for ci in cand], dim=-1)

    def lookup_tet(self, pts: Tensor) -> Tensor:
        """Rest-space points → containing tet index (grid gather,
        ``solid.py:291-297``; ``round`` is half-to-even in both)."""
        u = (pts - self.grid_origin) * self.grid_inv_cell
        dims = tuple(self.grid_tet.shape)
        hi = _const(tuple(float(d) - 1.0 for d in dims), u.device)
        u = torch.minimum(torch.clamp_min(u, 0.0), hi)
        i = torch.round(u).to(torch.int64)
        flat = (i[..., 0] * dims[1] + i[..., 1]) * dims[2] + i[..., 2]
        return self.grid_tet.reshape(-1)[flat]


def _regions(d1, d2, d3, d4, d5, d6):
    """Ericson's region tests, barycentrics and edge parameters."""
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp_min(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    tiny = torch.full_like(d1, 1e-30)
    t_ab = torch.clamp(d1 / torch.where(d1 != d3, d1 - d3, tiny), 0.0, 1.0)
    t_ac = torch.clamp(d2 / torch.where(d2 != d6, d2 - d6, tiny), 0.0, 1.0)
    dbc = d4 - d3
    t_bc = torch.clamp(dbc / torch.clamp_min(dbc + (d5 - d6), 1e-30),
                       0.0, 1.0)
    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    reg_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    reg_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    reg_bc = (va <= 0) & (dbc >= 0) & (d5 - d6 >= 0)
    return ((reg_a, reg_b, reg_c, reg_ab, reg_ac, reg_bc), v, w, t_ab, t_ac,
            t_bc)


def _closest_on_faces_pairs(pts: Tensor, a: Tensor, b: Tensor, c: Tensor):
    """Closest point on per-point candidate triangles: ``pts (B, P, 3)``,
    corners ``(B, P, K, 3)`` → ``(cp (B, P, 3), d2min (B, P))``
    (``solid.py:300-345``)."""
    q = pts[..., None, :]
    ap, bp, cp_ = q - a, q - b, q - c
    ab, ac = b - a, c - a
    d1, d2 = dot3(ab, ap), dot3(ac, ap)
    d3, d4 = dot3(ab, bp), dot3(ac, bp)
    d5, d6 = dot3(ab, cp_), dot3(ac, cp_)
    reg, v, w, t_ab, t_ac, t_bc = _regions(d1, d2, d3, d4, d5, d6)
    reg_a, reg_b, reg_c, reg_ab, reg_ac, reg_bc = [r[..., None] for r in reg]
    closest = a + v[..., None] * ab + w[..., None] * ac
    closest = torch.where(reg_bc, b + t_bc[..., None] * (c - b), closest)
    closest = torch.where(reg_ac, a + t_ac[..., None] * ac, closest)
    closest = torch.where(reg_ab, a + t_ab[..., None] * ab, closest)
    closest = torch.where(reg_c, c, closest)
    closest = torch.where(reg_b, b, closest)
    closest = torch.where(reg_a, a, closest)
    diff = q - closest
    d2all = dot3(diff, diff)
    best = torch.argmin(d2all, dim=-1, keepdim=True)
    cp = torch.gather(closest, -2, best[..., None].expand(
        *best.shape, 3))[..., 0, :]
    return cp, torch.gather(d2all, -1, best)[..., 0]


@dataclass(frozen=True)
class SolidContacts:
    """Fixed-capacity masked particle–tet contact buffer (the 3×3
    ``constraintInfo`` of ``init_ParticleTetContactConstraint``,
    ``PositionBasedDynamics.cpp:1172-1217``), fields ``(*lead, K, ...)``.
    ``cp1_frozen`` is the detection-time tet contact point, ``inv_cnt``
    the per-particle Jacobi average over active contacts, ``overflow``
    the active contacts the capacities dropped."""

    particle: Tensor          # (K,) point-side particle index
    tet_verts: Tensor         # (K, 4) tet-side particle indices (ref tet)
    bary: Tensor              # (K, 4) barycentric weights of the contact
    cp1_frozen: Tensor = None  # (K, 3)
    normal: Tensor = None      # (K, 3)
    tangent: Tensor = None     # (K, 3)
    nkn_inv: Tensor = None     # (K,)
    p_max: Tensor = None       # (K,)
    friction: Tensor = None    # (K,)
    mask: Tensor = None        # (K,)
    inv_cnt: Tensor = None     # (N,)
    overflow: Tensor = None    # ()


def _gated_containing_tet(tc: TetCollider, x, px, xt0, inv_a,
                          capacity=None):
    """Containing-tet search through the per-step tet-block sphere gate
    (``solid.py:378-418``): (point, block) candidates whose current block
    sphere holds the point, compacted, then only those blocks' tets get
    the barycentric test. Returns ``(tet_idx (B, P), has, dropped)``;
    the lowest containing tet index wins, as the dense path's
    ``argmax``."""
    bs = tc.tet_blocks.shape[1]
    bt = tc.tet_blocks.shape[0]
    b, p = px.shape[:2]
    bverts = x[:, tc.tets[tc.tet_blocks]]              # (B, Bt, bs, 4, 3)
    bc3 = torch.mean(bverts, dim=(2, 3))
    dv = bverts - bc3[:, :, None, None]
    br2 = torch.amax(dot3(dv, dv), dim=(2, 3))
    d2 = _sum3(*[(px[..., :, None, c] - bc3[:, None, :, c]) ** 2
                 for c in range(3)])                   # (B, P, Bt)
    ok = d2 < br2[:, None]
    cap = int(capacity if capacity is not None
              else min(p * bt, max(2048, p)))
    sel, act, dropped = _compact(ok.reshape(b, p * bt), cap, p * bt)
    p_id = torch.div(sel, bt, rounding_mode="floor")
    cand = tc.tet_blocks[sel - p_id * bt]              # (B, C, bs)
    rel = take(px, p_id, None)[..., None, :] - take(xt0, cand, None)
    b3 = _mv(take(inv_a, cand, None), rel)
    inside = ((b3 >= 0.0).all(-1) & (_sum3(*b3.unbind(-1)) <= 1.0)
              & act[..., None])
    big = 2 ** 30
    row_best = torch.amin(torch.where(inside, cand, torch.full_like(cand,
                                                                    big)),
                          dim=-1)
    tet_sel = torch.full((b, p), big, dtype=torch.int64,
                         device=px.device).scatter_reduce(
        1, p_id, row_best, "amin")
    has = tet_sel < big
    return torch.where(has, tet_sel, torch.zeros_like(tet_sel)), has, dropped


def detect_solid_contacts(pairs, x: Tensor, v: Tensor, inv_mass: Tensor,
                          capacity: int = 1024) -> Optional[SolidContacts]:
    """Narrow phase of all (point group, tet collider) pairs
    (``solid.py:443-653``): per point, the inside-tet test in the current
    configuration, the rest-space position projected to the rest surface,
    the ref-tet lookup and the contact-info init; the rows compacted to
    ``capacity``, active first. ``x``/``v`` are ``(*lead, N, 3)``."""
    if not pairs:
        return None
    lead = tuple(x.shape[:-2])
    n = x.shape[-2]
    x = x.reshape(-1, n, 3)
    v = v.reshape(-1, n, 3)
    b = x.shape[0]
    w_all = inv_mass if inv_mass.dim() == 1 else inv_mass.reshape(-1, n)
    dev = x.device
    tgt_cache, sph_cache = {}, {}

    def _target(tc):
        if id(tc) not in tgt_cache:
            xt0 = x[:, tc.tets[:, 0]]                          # (B, T, 3)
            a = torch.stack([x[:, tc.tets[:, 1]] - xt0,
                             x[:, tc.tets[:, 2]] - xt0,
                             x[:, tc.tets[:, 3]] - xt0], dim=-1)
            tgt_cache[id(tc)] = (xt0, inv3(a))
        return tgt_cache[id(tc)]

    def _tet_spheres(tc):
        if id(tc) not in sph_cache:
            verts = x[:, tc.tets]                              # (B, T, 4, 3)
            c3 = torch.mean(verts, dim=2)
            dv = verts - c3[:, :, None]
            sph_cache[id(tc)] = (c3, torch.amax(dot3(dv, dv), dim=2))
        return sph_cache[id(tc)]

    rows = []
    gate_overflow = torch.zeros((b,), dtype=torch.float32, device=dev)
    for (off, cnt, fric_pg), tc in pairs:
        px = x[:, off:off + cnt]
        pvel = v[:, off:off + cnt]
        pw = w_all[..., off:off + cnt].expand(b, cnt)
        idx = torch.arange(off, off + cnt, device=dev).expand(b, cnt)
        n_tets = tc.tets.shape[0]
        xt0, inv_a = _target(tc)
        pre_act = None
        if cnt >= _PRE_GATE_MIN_PTS and cnt * n_tets <= _GATE_MIN_PAIRS:
            # point pre-compaction by the per-tet bounding spheres (exact:
            # a point inside a tet lies inside its sphere)
            tc3, tr2 = _tet_spheres(tc)
            d2 = _sum3(*[(px[..., :, None, c] - tc3[:, None, :, c]) ** 2
                         for c in range(3)])                   # (B, P, T)
            ok_p = (d2 < tr2[:, None]).any(-1)
            cap_pre = int(min(cnt, max(256, cnt // 4)))
            sel0, act0, drop0 = _compact(ok_p, cap_pre, cnt)
            gate_overflow = gate_overflow + drop0
            px, pvel = take(px, sel0, None), take(pvel, sel0, None)
            pw, idx = torch.gather(pw, 1, sel0), torch.gather(idx, 1, sel0)
            pre_act = act0
            cnt = cap_pre
        if tc.tet_blocks is not None and cnt * n_tets > _GATE_MIN_PAIRS:
            tet_idx, has, dropped = _gated_containing_tet(tc, x, px, xt0,
                                                          inv_a)
            gate_overflow = gate_overflow + dropped
            bary = _mv(take(inv_a, tet_idx, None),
                       px - take(xt0, tet_idx, None))
        else:
            rel = [px[..., :, None, c] - xt0[:, None, :, c]
                   for c in range(3)]
            b3 = [_sum3(*[inv_a[:, None, :, i, c] * rel[c]
                          for c in range(3)]) for i in range(3)]
            inside = ((b3[0] >= 0.0) & (b3[1] >= 0.0) & (b3[2] >= 0.0)
                      & (_sum3(*b3) <= 1.0))                   # (B, P, T)
            has = inside.any(-1)
            if pre_act is not None:
                has = has & pre_act
            tet_idx = torch.argmax(inside.to(torch.uint8), dim=-1)
            bary = torch.stack([torch.gather(bb, -1, tet_idx[..., None])[
                ..., 0] for bb in b3], dim=-1)                 # (B, P, 3)

        # early compaction: only the inside points go on
        cap_pts = int(min(cnt, max(192, capacity // max(len(pairs), 1))))
        sel, act, dropped_pts = _compact(has, cap_pts, cnt)
        gate_overflow = gate_overflow + dropped_pts
        px, pvel = take(px, sel, None), take(pvel, sel, None)
        pw, idx = torch.gather(pw, 1, sel), torch.gather(idx, 1, sel)
        tet_idx = torch.gather(tet_idx, 1, sel)
        bary = take(bary, sel, None)
        has = torch.gather(has, 1, sel) & act
        cnt = cap_pts

        # rest-space position (cpp:409-420) projected to the rest surface
        rxp = tc.rest_x0[tet_idx] + _mv(tc.rest_a[tet_idx], bary)
        cp0, cp_dropped = tc.closest_surface_point_gated(rxp, need=has)
        gate_overflow = gate_overflow + cp_dropped

        ref_tet = tc.lookup_tet(cp0)
        cp_bary = _mv(tc.rest_inv_a[ref_tet], cp0 - tc.rest_x0[ref_tet])
        ref_verts = tc.tets[ref_tet]                           # (B, P, 4)
        b_full = torch.cat([1.0 - _sum3(*cp_bary.unbind(-1))[..., None],
                            cp_bary], dim=-1)
        cp_w = _weighted4(b_full, take(x, ref_verts, None))

        d_w = cp_w - px
        dist_w = sqrt_rn(dot3(d_w, d_w))
        n_w = d_w / torch.clamp_min(dist_w, 1e-12)[..., None]
        mask = has & (dist_w > 1e-6)

        wr = take(w_all, ref_verts, 1)                         # (B, P, 4)
        v1 = _weighted4(b_full, take(v, ref_verts, None))
        u_rel = pvel - v1
        u_rel_n = dot3(n_w, u_rel)
        t = u_rel - u_rel_n[..., None] * n_w
        tl2 = dot3(t, t)
        t = torch.where((tl2 > 1e-6)[..., None],
                        t / sqrt_rn(torch.clamp_min(tl2, 1e-30))[..., None],
                        t)
        bbw = b_full * b_full * wr
        jmj = pw + (((bbw[..., 0] + bbw[..., 1]) + bbw[..., 2])
                    + bbw[..., 3])
        nkn_inv = torch.where(jmj > 1e-12, 1.0 / torch.clamp_min(jmj, 1e-30),
                              torch.zeros_like(jmj))
        p_max = nkn_inv * dot3(u_rel, t)
        fric = _const((float(np.float32(fric_pg)),), dev)[0]
        rows.append(dict(
            particle=idx, tet_verts=ref_verts, bary=b_full, cp1_frozen=cp_w,
            normal=n_w, tangent=t, nkn_inv=nkn_inv, p_max=p_max,
            friction=(fric + tc.friction).expand(b, cnt),
            mask=(mask & (jmj > 1e-12)).to(torch.float32)))
    c = {k: torch.cat([r[k] for r in rows], dim=1) for k in rows[0]}
    # compact the per-candidate rows to ``capacity``, active first
    k = c["mask"].shape[1]
    n_active = torch.sum(c["mask"], dim=1)
    if capacity is not None and capacity < k:
        sel, act, _ = _compact(c["mask"] > 0.5, capacity, k)
        c = {name: take(a, sel, None) for name, a in c.items()}
        c["mask"] = c["mask"] * act.to(torch.float32)
        overflow = torch.clamp_min(n_active - capacity, 0.0)
    else:
        overflow = torch.zeros((b,), dtype=torch.float32, device=dev)
    overflow = overflow + gate_overflow
    idx5 = torch.cat([c["particle"][..., None], c["tet_verts"]], dim=-1)
    kk = idx5.shape[1]
    cnt = torch.zeros((b, n), dtype=torch.float32, device=dev).scatter_add(
        1, idx5.reshape(b, kk * 5),
        c["mask"][..., None].expand(b, kk, 5).reshape(b, kk * 5))
    c["inv_cnt"] = 1.0 / torch.clamp_min(cnt, 1.0)
    c["overflow"] = overflow
    return SolidContacts(**{name: a.reshape(tuple(lead) + tuple(a.shape[1:]))
                            for name, a in c.items()})


def _solid_corr(c: SolidContacts, inv_mass: Tensor, p: Tensor, n: int):
    """The five corrections of each row (the particle's and the ref tet's
    four) added into ``(B, n, 3)`` and averaged by ``inv_cnt``."""
    b, k = c.particle.shape
    w0 = take(inv_mass, c.particle, 1)
    wr = take(inv_mass, c.tet_verts, 1)
    corr = torch.cat([(w0[..., None] * p)[..., None, :],
                      -(wr * c.bary)[..., None] * p[..., None, :]], dim=2)
    idx = torch.cat([c.particle[..., None], c.tet_verts], dim=-1)
    out = torch.zeros((b, n, 3), dtype=p.dtype, device=p.device).scatter_add(
        1, idx.reshape(b, k * 5, 1).expand(b, k * 5, 3),
        corr.reshape(b, k * 5, 3))
    return out * c.inv_cnt[..., None]


def solve_solid_contacts_position(c: SolidContacts, x: Tensor,
                                  inv_mass: Tensor):
    """One batched pass of ``solve_ParticleTetContactConstraint``
    (``PositionBasedDynamics.cpp:1219-1272``; ``solid.py:655-679``): C =
    n·(x₀ − cp1) with the detection-time cp1. Returns ``(corrections
    (*lead, N, 3), λ (*lead, K))``."""
    nd = x.dim() - 2
    lead, n = x.shape[:nd], x.shape[-2]
    cf = flat_contacts(c, nd)
    xf = x.reshape(-1, n, 3)
    w = inv_mass if inv_mass.dim() == 1 else inv_mass.reshape(-1, n)
    cval = dot3(cf.normal, take(xf, cf.particle, None) - cf.cp1_frozen)
    lam = -cf.nkn_inv * cval * cf.mask
    dx = _solid_corr(cf, w, lam[..., None] * cf.normal, n)
    return dx.reshape(*lead, n, 3), lam.reshape(*lead, lam.shape[-1])


def solve_solid_contacts_velocity(c: SolidContacts, x: Tensor, v: Tensor,
                                  inv_mass: Tensor, lam=None) -> Tensor:
    """Friction pass (``velocitySolve_ParticleTetContactConstraint``,
    ``PositionBasedDynamics.cpp:1274-1340``; ``solid.py:682-705``); ``lam``
    is the last position pass's λ, recomputed from ``x`` when None.
    Returns velocity corrections ``(*lead, N, 3)``."""
    nd = x.dim() - 2
    lead, n = x.shape[:nd], x.shape[-2]
    cf = flat_contacts(c, nd)
    w = inv_mass if inv_mass.dim() == 1 else inv_mass.reshape(-1, n)
    if lam is None:
        xf = x.reshape(-1, n, 3)
        cval = dot3(cf.normal, take(xf, cf.particle, None) - cf.cp1_frozen)
        lam = -cf.nkn_inv * cval
    else:
        lam = lam.reshape(-1, lam.shape[-1])
    fl = cf.friction * lam
    pv = (torch.where(fl > cf.p_max, -cf.p_max,
                      torch.where(fl < -cf.p_max, cf.p_max, -fl))[..., None]
          * cf.tangent * cf.mask[..., None])
    return _solid_corr(cf, w, pv, n).reshape(*lead, n, 3)
