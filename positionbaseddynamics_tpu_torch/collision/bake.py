"""Offline SDF baking: triangle mesh → dense signed-distance grid.

The port's own copy of ``positionbaseddynamics_tpu/collision/bake.py``
(numpy and ``scipy.spatial.cKDTree`` on the host at build time; its grids
equal the JAX package's bit for bit).


Replaces the reference's runtime Discregrid dependency
(``Demos/SceneLoaderDemo/SceneLoaderDemo.cpp:212-260``: Discregrid
``TriangleMeshDistance`` → ``CubicLagrangeDiscreteGrid``, MD5-keyed
``.csdf`` cache) with a self-contained numpy baker producing a dense
``(nx, ny, nz)`` float32 array that :class:`..collision.sdf.SDFShape.grid`
interpolates on device. Baking happens once at scene-build time on the
host; the grid is then a read-only replicated array shared by every
rollout scenario (SURVEY §7 "SDF memory").

Unsigned distance = exact point–triangle distance (vectorized, chunked);
sign = ray-crossing parity along +z per grid column (robust for closed
meshes, the same class of meshes Discregrid requires).

Scaling: instead of all-nodes × all-faces brute force, candidate
triangles per grid node come from a KD-tree over triangle centroids with
a PROVEN cutoff — a triangle can only beat the current best distance
``d`` if its centroid lies within ``d + r_max`` (``r_max`` = largest
triangle circumradius), so once the k-th nearest centroid is beyond that
bound the answer is exact. ``k`` doubles adaptively for the (rare) nodes
that fail the bound, degrading to brute force only in the worst case.
This is the same work-bounding idea as Discregrid's triangle BVH
(reference build: ``CMakeLists.txt:44-66``,
``SceneLoaderDemo.cpp:212-260``) in vectorized-batch form: bunny_10k at
scene resolution bakes in seconds instead of minutes, bit-identical to
the brute force.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np


def _point_triangle_distance(p: np.ndarray, a, b, c) -> np.ndarray:
    """Min distance from points ``p (P, 3)`` to triangles ``a/b/c (T, 3)``
    — broadcast to ``(P, T)`` (Ericson, *Real-Time Collision Detection*
    §5.1.5 closed-form region classification, fully vectorized)."""
    ab = b - a
    ac = c - a
    ap = p[:, None, :] - a[None, :, :]

    d1 = np.einsum("tj,ptj->pt", ab, ap)
    d2 = np.einsum("tj,ptj->pt", ac, ap)

    bp = p[:, None, :] - b[None, :, :]
    d3 = np.einsum("tj,ptj->pt", ab, bp)
    d4 = np.einsum("tj,ptj->pt", ac, bp)

    cp = p[:, None, :] - c[None, :, :]
    d5 = np.einsum("tj,ptj->pt", ab, cp)
    d6 = np.einsum("tj,ptj->pt", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = np.maximum(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    # interior closest point
    closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]

    # vertex regions
    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    # edge regions
    t_ab = np.clip(d1 / np.where(d1 - d3 != 0, d1 - d3, 1e-30), 0, 1)
    reg_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ac = np.clip(d2 / np.where(d2 - d6 != 0, d2 - d6, 1e-30), 0, 1)
    reg_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_bc = np.clip((d4 - d3) / np.where((d4 - d3) + (d5 - d6) != 0,
                                        (d4 - d3) + (d5 - d6), 1e-30), 0, 1)
    reg_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    closest = np.where(reg_bc[..., None],
                       b[None] + t_bc[..., None] * (c - b)[None], closest)
    closest = np.where(reg_ac[..., None],
                       a[None] + t_ac[..., None] * ac[None], closest)
    closest = np.where(reg_ab[..., None],
                       a[None] + t_ab[..., None] * ab[None], closest)
    closest = np.where(reg_c[..., None], np.broadcast_to(c[None], closest.shape), closest)
    closest = np.where(reg_b[..., None], np.broadcast_to(b[None], closest.shape), closest)
    closest = np.where(reg_a[..., None], np.broadcast_to(a[None], closest.shape), closest)

    d = p[:, None, :] - closest
    return np.sqrt(np.einsum("ptj,ptj->pt", d, d))


def _point_triangle_distance_pairs(p: np.ndarray, a, b, c) -> np.ndarray:
    """Min distance from points ``p (P, 3)`` to *per-point* candidate
    triangles ``a/b/c (P, K, 3)`` — returns ``(P, K)``. Same region
    classification as :func:`_point_triangle_distance`, but each point
    carries its own triangle set (the KD-pruned candidates)."""
    ap = p[:, None, :] - a
    bp = p[:, None, :] - b
    cp = p[:, None, :] - c
    ab = b - a
    ac = c - a

    d1 = np.einsum("pkj,pkj->pk", ab, ap)
    d2 = np.einsum("pkj,pkj->pk", ac, ap)
    d3 = np.einsum("pkj,pkj->pk", ab, bp)
    d4 = np.einsum("pkj,pkj->pk", ac, bp)
    d5 = np.einsum("pkj,pkj->pk", ab, cp)
    d6 = np.einsum("pkj,pkj->pk", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = np.maximum(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    closest = a + v[..., None] * ab + w[..., None] * ac

    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    t_ab = np.clip(d1 / np.where(d1 - d3 != 0, d1 - d3, 1e-30), 0, 1)
    reg_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ac = np.clip(d2 / np.where(d2 - d6 != 0, d2 - d6, 1e-30), 0, 1)
    reg_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_bc = np.clip((d4 - d3) / np.where((d4 - d3) + (d5 - d6) != 0,
                                        (d4 - d3) + (d5 - d6), 1e-30), 0, 1)
    reg_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    closest = np.where(reg_bc[..., None], b + t_bc[..., None] * (c - b),
                       closest)
    closest = np.where(reg_ac[..., None], a + t_ac[..., None] * ac, closest)
    closest = np.where(reg_ab[..., None], a + t_ab[..., None] * ab, closest)
    closest = np.where(reg_c[..., None], c, closest)
    closest = np.where(reg_b[..., None], b, closest)
    closest = np.where(reg_a[..., None], a, closest)

    d = p[:, None, :] - closest
    return np.sqrt(np.einsum("pkj,pkj->pk", d, d))


def _min_dist_kdtree(pts: np.ndarray, a, b, c, chunk=8192) -> np.ndarray:
    """Exact min point–triangle distance via centroid-KD-tree candidate
    pruning. Exactness bound: a triangle at true distance < d has its
    centroid within d + r_max of the point, so if the farthest queried
    centroid is beyond best_d + r_max nothing was missed; k doubles for
    nodes failing the bound."""
    from scipy.spatial import cKDTree

    t = a.shape[0]
    cent = (a + b + c) / 3.0
    r_max = float(np.sqrt(np.maximum(
        ((a - cent) ** 2).sum(-1),
        np.maximum(((b - cent) ** 2).sum(-1),
                   ((c - cent) ** 2).sum(-1))).max()))
    tree = cKDTree(cent)

    out = np.empty(pts.shape[0])
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]
        k = min(16, t)
        d_c, idx = tree.query(p, k=k, workers=-1)
        if k == 1:
            d_c, idx = d_c[:, None], idx[:, None]
        best = _point_triangle_distance_pairs(
            p, a[idx], b[idx], c[idx]).min(axis=1)
        open_ = (d_c[:, -1] < best + r_max) & (k < t)
        while open_.any():
            k = min(4 * k, t)
            d_c_u, idx_u = tree.query(p[open_], k=k, workers=-1)
            best[open_] = np.minimum(
                best[open_], _point_triangle_distance_pairs(
                    p[open_], a[idx_u], b[idx_u], c[idx_u]).min(axis=1))
            still = (d_c_u[:, -1] < best[open_] + r_max) & (k < t)
            open_[open_] = still
        out[s:s + chunk] = best
    return out


def _parity_eps(verts) -> float:
    """Tiny xy offset applied to parity rays so they cannot pass exactly
    through a mesh vertex or along an edge (the classic ray-casting
    degeneracy: a ray through a shared vertex counts every incident
    triangle once with the inclusive barycentric test). The offset is
    mesh-relative and far below any distance value's significance."""
    ext = float(np.ptp(np.asarray(verts)[:, :2]))
    e = 1e-6 * max(ext, 1e-12)
    # incommensurate x/y offsets: an equal offset would keep a ray on
    # any mesh line aligned with the x=y diagonal (UV-sphere meridians)
    return np.array([e, 0.6180339887 * e])


def _ray_parity_z(points: np.ndarray, verts, tris) -> np.ndarray:
    """Inside test by +z ray-crossing parity for points ``(P, 3)``."""
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    inside = np.zeros(points.shape[0], bool)
    eps = _parity_eps(verts)
    # 2D barycentric test in the xy plane, then z-intersection above point
    for start in range(0, points.shape[0], 4096):
        p = points[start:start + 4096] + np.array([eps[0], eps[1], 0.0])
        ax, ay = a[:, 0][None], a[:, 1][None]
        bx, by = b[:, 0][None], b[:, 1][None]
        cx, cy = c[:, 0][None], c[:, 1][None]
        px, py = p[:, 0][:, None], p[:, 1][:, None]
        d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        d = np.where(np.abs(d) < 1e-30, 1e-30, d)
        l1 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / d
        l2 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / d
        l3 = 1.0 - l1 - l2
        hit = (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        z = l1 * a[:, 2][None] + l2 * b[:, 2][None] + l3 * c[:, 2][None]
        above = hit & (z > p[:, 2][:, None])
        inside[start:start + 4096] = (above.sum(axis=1) % 2) == 1
    return inside


def _grid_parity_z(verts, tris, axes) -> np.ndarray:
    """Grid form of :func:`_ray_parity_z`: all nodes of one (x, y)
    column share a +z ray, so triangle crossings are computed ONCE per
    column and bucketed over the column's z axis — O(columns × T)
    instead of O(nodes × T). Crossing z values land in z-axis bins via
    one global ``searchsorted``; parity per node is a suffix-sum of the
    per-column histogram. Bit-identical to the per-node test (same hit
    predicate, same strict ``z > p_z`` through bin placement)."""
    ax_x, ax_y, ax_z = axes
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    nx, ny, nz = len(ax_x), len(ax_y), len(ax_z)
    eps = _parity_eps(verts)
    tx_lo = np.minimum(np.minimum(a[:, 0], b[:, 0]), c[:, 0])
    tx_hi = np.maximum(np.maximum(a[:, 0], b[:, 0]), c[:, 0])
    counts = np.zeros((nx, ny, nz + 1), np.int64)
    for ix in range(nx):
        x_col = ax_x[ix] + eps[0]
        # x-slab triangle pruning: only triangles whose x-range covers
        # this column row can be crossed by its rays
        sel = (tx_lo <= x_col) & (tx_hi >= x_col)
        if not sel.any():
            continue
        at, bt, ct = a[sel], b[sel], c[sel]
        ax_, ay_ = at[:, 0][None], at[:, 1][None]
        bx, by = bt[:, 0][None], bt[:, 1][None]
        cx, cy = ct[:, 0][None], ct[:, 1][None]
        px = np.full((ny, 1), x_col)
        py = np.asarray(ax_y)[:, None] + eps[1]
        d = (by - cy) * (ax_ - cx) + (cx - bx) * (ay_ - cy)
        d = np.where(np.abs(d) < 1e-30, 1e-30, d)
        l1 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / d
        l2 = ((cy - ay_) * (px - cx) + (ax_ - cx) * (py - cy)) / d
        l3 = 1.0 - l1 - l2
        hit = (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        z = l1 * at[:, 2][None] + l2 * bt[:, 2][None] + l3 * ct[:, 2][None]
        # bin = number of z-axis nodes with value < crossing z ⇒ the
        # crossing is strictly above exactly the first `bin` nodes
        bins = np.searchsorted(ax_z, z.ravel(), side="left").reshape(z.shape)
        ci = np.broadcast_to(np.arange(ny)[:, None], z.shape)
        flat = (np.int64(nz + 1) * ci + bins).ravel()[hit.ravel()]
        counts[ix] += np.bincount(
            flat, minlength=ny * (nz + 1)).reshape(ny, nz + 1)
    # crossings strictly above node iz = sum over bins > iz
    suffix = np.cumsum(counts[:, :, ::-1], axis=2)[:, :, ::-1]
    above = suffix[:, :, 1:]
    return (above % 2) == 1


def _godunov_far_field(dist_flat, band, res, spacings, tol=1e-7):
    """Fill the far field of an unsigned distance grid by iterated
    vectorized Godunov (eikonal |∇d| = 1) updates, seeded by the exact
    narrow-band values — the "sweeping for the far field" half of the
    narrow-band bake. Error vs exact Euclidean distance is O(cell) away
    from the band; contact queries only read the exact band."""
    d = np.where(band, dist_flat, np.inf).reshape(res)
    hx, hy, hz = spacings
    big = 1e30

    def axis_min(arr, axis):
        lo_ = np.full_like(arr, np.inf)
        hi_ = np.full_like(arr, np.inf)
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(1, None)
        sl_hi[axis] = slice(None, -1)
        lo_[tuple(sl_lo)] = arr[tuple(sl_hi)]
        hi_[tuple(sl_hi)] = arr[tuple(sl_lo)]
        return np.minimum(lo_, hi_)

    n_iter = 4 * int(res[0] + res[1] + res[2])
    h3 = np.array([hx, hy, hz])
    band3 = band.reshape(res)
    for _ in range(n_iter):
        u = np.stack([axis_min(d, 0), axis_min(d, 1), axis_min(d, 2)], -1)
        order = np.argsort(u, axis=-1)
        us = np.take_along_axis(u, order, axis=-1)
        hs = h3[order]
        us_c = np.minimum(us, big)       # keep arithmetic finite
        with np.errstate(invalid="ignore", over="ignore"):
            x = us_c[..., 0] + hs[..., 0]
            a2 = 1.0 / hs[..., 0] ** 2 + 1.0 / hs[..., 1] ** 2
            b2 = (us_c[..., 0] / hs[..., 0] ** 2
                  + us_c[..., 1] / hs[..., 1] ** 2)
            c2 = (us_c[..., 0] ** 2 / hs[..., 0] ** 2
                  + us_c[..., 1] ** 2 / hs[..., 1] ** 2 - 1.0)
            disc = np.maximum(b2 * b2 - a2 * c2, 0.0)
            x2 = (b2 + np.sqrt(disc)) / a2
            x = np.where((x > us[..., 1]) & (us[..., 1] < big), x2, x)
            a3 = a2 + 1.0 / hs[..., 2] ** 2
            b3 = b2 + us_c[..., 2] / hs[..., 2] ** 2
            c3 = c2 + us_c[..., 2] ** 2 / hs[..., 2] ** 2
            disc = np.maximum(b3 * b3 - a3 * c3, 0.0)
            x3 = (b3 + np.sqrt(disc)) / a3
            x = np.where((x > us[..., 2]) & (us[..., 2] < big), x3, x)
        # a node only receives a value once it has a REAL-valued
        # neighbor (front propagation); pseudo-values seeded from the
        # `big` clamp must not count as filled
        x = np.where(us[..., 0] < big, x, np.inf)
        new = np.where(band3, d, np.minimum(d, x))
        converged = (bool(np.isfinite(d).all())
                     and not np.any(np.abs(new - d) > tol))
        d = new
        if converged:
            break
    return d.reshape(-1)


def bake_mesh_sdf(vertices, triangles, resolution=32, padding=0.2,
                  chunk=2048, tri_chunk=2048, band_cells=2.0,
                  exact=False):
    """Bake a closed triangle mesh into ``(values, origin, extent)`` for
    :meth:`SDFShape.grid`. ``resolution`` may be an int (longest axis) or a
    3-tuple. ``padding`` is relative AABB padding (reference default SDF
    domains are likewise padded; ``doc/file_format.md`` resolution field).

    Default pipeline (``exact=False``): per-column ray parity for sign,
    exact KD-pruned point–triangle distance on a narrow band of
    ``band_cells`` grid cells around the surface, eikonal sweeps for the
    far field (O(cell) error there; the band — everything a contact
    query reads — is exact). ``exact=True`` forces exact distance at
    every node (the old brute-force-equivalent answer, still KD-pruned)."""
    verts = np.asarray(vertices, np.float64)
    tris = np.asarray(triangles, np.int64).reshape(-1, 3)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    size = hi - lo
    pad = padding * max(float(size.max()), 1e-6)
    lo, hi = lo - pad, hi + pad
    extent = hi - lo

    if np.isscalar(resolution):
        longest = float(extent.max())
        res = np.maximum((extent / longest * resolution).astype(int), 2)
    else:
        res = np.asarray(resolution, int)

    axes = [np.linspace(lo[i], hi[i], res[i]) for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    try:
        from scipy.spatial import cKDTree

        if exact:
            dist = _min_dist_kdtree(pts, a, b, c)
        else:
            # narrow band: every node whose true distance could be
            # within band_cells cells must be included — nearest-VERTEX
            # distance overestimates true distance by at most the
            # longest edge incident to the closest point, bounded by
            # 2·r_max (circumradius)
            cent = (a + b + c) / 3.0
            r_max = float(np.sqrt(np.maximum(
                ((a - cent) ** 2).sum(-1),
                np.maximum(((b - cent) ** 2).sum(-1),
                           ((c - cent) ** 2).sum(-1))).max()))
            spacings = extent / np.maximum(res - 1, 1)
            vtree = cKDTree(verts)
            d_v = vtree.query(pts, workers=-1)[0]
            band = d_v <= band_cells * float(spacings.max()) + 2.0 * r_max
            dist = np.full(pts.shape[0], np.inf)
            dist[band] = _min_dist_kdtree(pts[band], a, b, c)
            dist = _godunov_far_field(dist, band, tuple(res), spacings)
    except ImportError:      # scipy absent: brute-force fallback
        dist = np.full(pts.shape[0], np.inf)
        for s in range(0, pts.shape[0], chunk):
            p = pts[s:s + chunk]
            best = np.full(p.shape[0], np.inf)
            for ts in range(0, tris.shape[0], tri_chunk):
                d = _point_triangle_distance(
                    p, a[ts:ts + tri_chunk], b[ts:ts + tri_chunk],
                    c[ts:ts + tri_chunk])
                best = np.minimum(best, d.min(axis=1))
            dist[s:s + chunk] = best

    inside = _grid_parity_z(verts, tris, axes).reshape(-1)
    sdf = np.where(inside, -dist, dist).astype(np.float32)
    return sdf.reshape(tuple(res)), lo.astype(np.float32), extent.astype(np.float32)


def bake_cache_key(vertices, triangles, resolution, padding) -> str:
    """MD5 content key for bake caching — the same idea as the reference's
    MD5-validated ``.csdf`` cache (``Utils/FileSystem.h:310-353``)."""
    h = hashlib.md5()
    h.update(np.ascontiguousarray(np.asarray(vertices, np.float32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(triangles, np.int32)).tobytes())
    # "v2" = narrow-band + eikonal far field (band values unchanged);
    # keying the pipeline version keeps pre-band caches from mixing in
    h.update(repr((resolution, padding, "v2")).encode())
    return h.hexdigest()


def bake_mesh_sdf_cached(vertices, triangles, resolution=32, padding=0.2,
                         cache_dir=None):
    """Bake with an on-disk npz cache keyed by mesh content + params."""
    if cache_dir is None:
        return bake_mesh_sdf(vertices, triangles, resolution, padding)
    os.makedirs(cache_dir, exist_ok=True)
    key = bake_cache_key(vertices, triangles, resolution, padding)
    path = os.path.join(cache_dir, f"sdf_{key}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return z["values"], z["origin"], z["extent"]
    values, origin, extent = bake_mesh_sdf(vertices, triangles, resolution, padding)
    np.savez(path, values=values, origin=origin, extent=extent)
    return values, origin, extent
