"""Discregrid ``.csdf`` (cubic SDF grid) file ingest.

The port's own copy of ``positionbaseddynamics_tpu/collision/csdf.py``
(numpy only). ``serendipity_basis`` is written in operators that numpy
arrays and torch tensors share, so ``collision/sdf.py`` evaluates it on
tensors.


The reference loads precomputed cubic signed-distance grids produced by
Discregrid's ``CubicLagrangeDiscreteGrid`` from ``.csdf`` files
(``Simulation/CubicSDFCollisionDetection.h:27-33``; scenes reference
them via ``collisionObjectFileName``, e.g. PileScene's bunnies). This
module parses that binary format and converts it into the engine's
native CSDF evaluation arrays, so scenes shipping ``.csdf`` fields run
against the reference's *exact* shipped data instead of a rebake.

Binary layout (little endian; verified against the shipped
``data/sdf/bunny_10k.csdf``):

    domain            6 × f64   (AABB min, max)
    resolution        3 × u32   cells per axis
    cell_size         3 × f64
    inv_cell_size     3 × f64
    n_cells           u64
    n_fields          u64
    #fields           u64       then per field:
        #nodes        u64  +  #nodes × f64 nodal values
    #fields           u64       then per field:
        #cells        u64  +  #cells × 32 × u32 node indices
    #fields           u64       then per field:
        #cell_map     u64  +  #cell_map × u32

Each cell is a 32-node tricubic *serendipity* element: 8 corner nodes
and 24 edge nodes at the third points of the 12 edges. Node world
positions follow Discregrid's implicit indexing (vertices first, then
x/y/z edge-node pairs); we recover each slot's LOCAL coordinates
ξ ∈ {−1, −1/3, 1/3, 1}³ from the decoded positions of one cell rather
than assuming Discregrid's slot order. The nodal basis of that element
space is the standard 32-node serendipity cubic:

    corner (ξ₀,η₀,ζ₀ = ±1):
        N = 1/64 (1+ξ₀ξ)(1+η₀η)(1+ζ₀ζ)(9(ξ²+η²+ζ²) − 19)
    edge along x (ξ₀ = ±1/3):
        N = 9/64 (1−ξ²)(1+9ξ₀ξ)(1+η₀η)(1+ζ₀ζ)      (y/z analogous)

Partition of unity is asserted at load time.
"""
from __future__ import annotations

import struct

import numpy as np


def _node_positions(indices, res, dmin, cell_size):
    """World positions of Discregrid node ``indices`` under the implicit
    indexing: grid vertices first, then per-axis edge-node pairs at the
    1/3 and 2/3 points of every edge."""
    rx, ry, rz = (int(r) for r in res)
    nv = (rx + 1) * (ry + 1) * (rz + 1)
    ne_x = rx * (ry + 1) * (rz + 1)
    ne_y = (rx + 1) * ry * (rz + 1)
    ne_z = (rx + 1) * (ry + 1) * rz
    idx = np.asarray(indices, np.int64)
    out = np.zeros(idx.shape + (3,), np.float64)

    def vertex(l):
        k = l // ((ry + 1) * (rx + 1))
        t = l % ((ry + 1) * (rx + 1))
        j = t // (rx + 1)
        i = t % (rx + 1)
        return np.stack([i, j, k], -1).astype(np.float64) * cell_size + dmin

    def edge(l, axis):
        # each edge family is ordered fastest along its own axis, then
        # cyclically (x→y→z): x-edges (i, j, k), y-edges (j, k, i),
        # z-edges (k, i, j) — verified against the shipped bunny field
        e = l // 2
        third = (1.0 + (l % 2).astype(np.float64)) / 3.0
        if axis == 0:
            i = e % rx
            j = (e // rx) % (ry + 1)
            k = e // (rx * (ry + 1))
        elif axis == 1:
            j = e % ry
            k = (e // ry) % (rz + 1)
            i = e // (ry * (rz + 1))
        else:
            k = e % rz
            i = (e // rz) % (rx + 1)
            j = e // (rz * (rx + 1))
        p = np.stack([i, j, k], -1).astype(np.float64) * cell_size + dmin
        p[..., axis] += third * cell_size[axis]
        return p

    m = idx < nv
    if m.any():
        out[m] = vertex(idx[m])
    m = (idx >= nv) & (idx < nv + 2 * ne_x)
    if m.any():
        out[m] = edge(idx[m] - nv, 0)
    m = (idx >= nv + 2 * ne_x) & (idx < nv + 2 * ne_x + 2 * ne_y)
    if m.any():
        out[m] = edge(idx[m] - nv - 2 * ne_x, 1)
    m = idx >= nv + 2 * ne_x + 2 * ne_y
    if m.any():
        out[m] = edge(idx[m] - nv - 2 * ne_x - 2 * ne_y, 2)
    return out


def serendipity_basis(xi, node_xi):
    """Evaluate the 32 serendipity shape functions at ``xi (..., 3)`` in
    [−1, 1]³. ``node_xi (32, 3)`` are the slots' local coordinates.
    Returns ``(..., 32)``. Branch-free and fully vectorized, so it works
    with numpy arrays and torch tensors alike."""
    x = xi[..., 0:1]                       # (..., 1) broadcasting vs (32,)
    y = xi[..., 1:2]
    z = xi[..., 2:3]
    r2 = x * x + y * y + z * z
    x0 = node_xi[..., 0]
    y0 = node_xi[..., 1]
    z0 = node_xi[..., 2]
    # slot classification from |coord|: 1 → tensor factor (1+c0 c),
    # 1/3 → edge factor; exactly one coord of an edge node is ±1/3
    ex = abs(x0) < 0.9
    ey = abs(y0) < 0.9
    ez = abs(z0) < 0.9
    corner = (1.0 / 64.0) * (1 + x0 * x) * (1 + y0 * y) * (1 + z0 * z) \
        * (9.0 * r2 - 19.0)
    edge_x = (9.0 / 64.0) * (1 - x * x) * (1 + 9.0 * x0 * x) \
        * (1 + y0 * y) * (1 + z0 * z)
    edge_y = (9.0 / 64.0) * (1 - y * y) * (1 + 9.0 * y0 * y) \
        * (1 + x0 * x) * (1 + z0 * z)
    edge_z = (9.0 / 64.0) * (1 - z * z) * (1 + 9.0 * z0 * z) \
        * (1 + x0 * x) * (1 + y0 * y)
    n = corner * (~ex & ~ey & ~ez) + edge_x * ex + edge_y * ey \
        + edge_z * ez
    return n


def load_csdf(path):
    """Parse a Discregrid ``.csdf`` file. Returns a dict with
    ``domain_min/domain_max (3,)``, ``resolution (3,) int``,
    ``cell_size (3,)``, ``cell_values (rx, ry, rz, 32) float32`` (the
    per-cell node values, pre-gathered for index-free evaluation) and
    ``node_xi (32, 3)`` (the slots' local element coordinates)."""
    with open(path, "rb") as f:
        d = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from("<" + fmt, d, off)
        off += struct.calcsize("<" + fmt)
        return vals

    dmin = np.asarray(take("3d"))
    dmax = np.asarray(take("3d"))
    res = np.asarray(take("3I"), np.int64)
    cell_size = np.asarray(take("3d"))
    take("3d")                       # inv_cell_size (recomputed)
    n_cells, n_fields = take("2Q")
    (n_field_vecs,) = take("Q")
    if n_fields != 1 or n_field_vecs != 1:
        raise NotImplementedError(
            f"multi-field .csdf not supported (n_fields={n_fields})")
    (n_nodes,) = take("Q")
    nodes = np.frombuffer(d, "<f8", n_nodes, off).copy()
    off += n_nodes * 8
    (outer,) = take("Q")
    assert outer == 1
    (nc,) = take("Q")
    if nc != n_cells:
        raise NotImplementedError(
            ".csdf cell vector does not cover the full grid")
    cells = np.frombuffer(d, "<u4", nc * 32, off).reshape(nc, 32).copy()
    off += nc * 32 * 4
    (outer,) = take("Q")
    assert outer == 1
    (ncm,) = take("Q")
    cell_map = np.frombuffer(d, "<u4", ncm, off).copy()
    off += ncm * 4
    assert off == len(d), f"trailing bytes in {path}"
    if not np.array_equal(cell_map, np.arange(nc, dtype=np.uint32)):
        raise NotImplementedError("adaptive .csdf cell maps not supported")

    rx, ry, rz = (int(r) for r in res)
    # per-slot local coordinates, recovered from cell 0's node positions
    pos0 = _node_positions(cells[0], res, dmin, cell_size)
    cell0_min = dmin
    xi = 2.0 * (pos0 - cell0_min) / cell_size - 1.0
    node_xi = np.round(xi * 3.0) / 3.0            # snap to {−1,−1/3,1/3,1}
    if not np.allclose(xi, node_xi, atol=1e-9):
        raise NotImplementedError(
            "unexpected .csdf node layout (not a 32-node serendipity cell)")
    # partition of unity sanity check
    rng = np.random.default_rng(0)
    probe = rng.uniform(-1.0, 1.0, (64, 3))
    sums = serendipity_basis(probe, node_xi).sum(-1)
    assert np.allclose(sums, 1.0, atol=1e-9), "basis is not a partition of 1"

    # pre-gather node values per cell; Discregrid cell order is x-fastest
    vals = nodes[cells.astype(np.int64)]          # (nc, 32)
    cell_values = np.asarray(
        vals.reshape(rz, ry, rx, 32).transpose(2, 1, 0, 3), np.float32)
    return dict(domain_min=dmin, domain_max=dmax,
                resolution=np.asarray([rx, ry, rz]),
                cell_size=cell_size, cell_values=cell_values,
                node_xi=node_xi.astype(np.float32))
