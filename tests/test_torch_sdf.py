"""The port's SDF shapes and build-time collision helpers
(``positionbaseddynamics_tpu_torch/collision/{sdf,sampling,bvh,csdf,bake}
.py``) against the JAX package's, on the CPU.

Tolerances: distances and normals 1e-6 at 10⁴ seeded points (JAX's
``jnp.linalg.norm`` adds in another order, an ulp of the O(1) values),
except the ``.csdf`` normal, a float32 central difference of a 32-term
sum, held to JAX's own distance from the float64 normal; the numpy
helpers — surface samples, Morton orders, block spheres, the ``.csdf``
reader and the mesh baker — exactly, since both packages run the same
numpy code."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.collision import bake as jbake
from positionbaseddynamics_tpu.collision import bvh as jbvh
from positionbaseddynamics_tpu.collision import csdf as jcsdf
from positionbaseddynamics_tpu.collision import sampling as jsampling
from positionbaseddynamics_tpu.collision import sdf as jsdf
from positionbaseddynamics_tpu_torch.collision import bake as tbake
from positionbaseddynamics_tpu_torch.collision import bvh as tbvh
from positionbaseddynamics_tpu_torch.collision import csdf as tcsdf
from positionbaseddynamics_tpu_torch.collision import sampling as tsampling
from positionbaseddynamics_tpu_torch.collision import sdf as tsdf

TOL = 1e-6
ANALYTIC = [("sphere", (0.7,)), ("box", ((0.5, 0.3, 0.8),)),
            ("torus", (0.8, 0.2)), ("cylinder", (0.5, 1.2)),
            ("hollow_sphere", (0.8, 0.1)),
            ("hollow_box", ((0.5, 0.6, 0.4), 0.05)),
            ("plane", ((0.2, 1.0, 0.1), 0.3))]


def _points(seed=0, n=10_000, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _both(jshape, tshape, p):
    dj = np.asarray(jshape.distance(jnp.asarray(p)))
    nj = np.asarray(jshape.normal(jnp.asarray(p)))
    dt = tshape.distance(torch.from_numpy(p)).numpy()
    nt = tshape.normal(torch.from_numpy(p)).numpy()
    return np.abs(dj - dt).max(), np.abs(nj - nt).max()


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("kind,args", ANALYTIC, ids=[k for k, _ in ANALYTIC])
def test_analytic_shape_distance_and_normal(kind, args, invert):
    jshape = getattr(jsdf.SDFShape, kind)(*args, invert=invert)
    tshape = getattr(tsdf.SDFShape, kind)(*args, invert=invert)
    assert tshape.kind == jshape.kind
    np.testing.assert_array_equal(tshape.params.numpy(),
                                  np.asarray(jshape.params))
    dd, dn = _both(jshape, tshape, _points())
    assert dd <= TOL and dn <= TOL
    assert tsdf.shape_bounding_radius(tshape) == \
        jsdf.shape_bounding_radius(jshape)


@pytest.mark.parametrize("order", [1, 3], ids=["trilinear", "cubic"])
def test_grid_samplers(order):
    """Trilinear and cubic-Lagrange grids, points inside and outside the
    box (the clamping), with their central-difference normals."""
    vals = np.random.default_rng(1).normal(size=(9, 7, 8)).astype(np.float32)
    args = (vals, (-1.0, -1.0, -1.0), (2.0, 2.5, 2.0))
    jshape = jsdf.SDFShape.grid(*args, order=order)
    tshape = tsdf.SDFShape.grid(*args, order=order)
    dd, dn = _both(jshape, tshape, _points(2))
    assert dd <= TOL and dn <= TOL
    assert tsdf.shape_bounding_radius(tshape) == \
        jsdf.shape_bounding_radius(jshape)


def test_stacked_shapes_take_one_shape_a_row():
    """A stack of same-kind shapes selected row by row evaluates as each
    shape alone (the batched narrow phase's per-kind group), grids
    included."""
    vals = np.random.default_rng(3).normal(size=(6, 5, 7)).astype(
        np.float32)
    p = torch.from_numpy(_points(4, 60).reshape(1, 3, 20, 3))
    rows = [1, 0, 1]
    for shapes in ([tsdf.SDFShape.box((0.5, 0.3, 0.8)),
                    tsdf.SDFShape.box((0.2, 0.3, 0.1), invert=True)],
                   [tsdf.SDFShape.grid(vals, (-1, -1, -1), (2, 2.5, 2)),
                    tsdf.SDFShape.grid(2 * vals, (-1, -1, -1.5),
                                       (2, 2.5, 2))]):
        sel = tsdf.SDFShape.stack(shapes).take(torch.tensor([rows]))
        for k, i in enumerate(rows):
            assert torch.equal(sel.distance(p)[0, k],
                               shapes[i].distance(p[0, k]))
            assert torch.equal(sel.normal(p)[0, k], shapes[i].normal(p[0, k]))


def _cell_nodes(i, j, k, res):
    """The 32 Discregrid node indices of cell (i, j, k) in one fixed slot
    order: 8 corners, then the x, y and z edges' third-point pairs."""
    rx, ry, rz = res
    nv = (rx + 1) * (ry + 1) * (rz + 1)
    ne_x = rx * (ry + 1) * (rz + 1)
    ne_y = (rx + 1) * ry * (rz + 1)
    out = []
    for dk in (0, 1):
        for dj in (0, 1):
            for di in (0, 1):
                out.append((k + dk) * (ry + 1) * (rx + 1)
                           + (j + dj) * (rx + 1) + i + di)
    for dj in (0, 1):
        for dk in (0, 1):
            e = i + rx * ((j + dj) + (ry + 1) * (k + dk))
            out += [nv + 2 * e, nv + 2 * e + 1]
    for dk in (0, 1):
        for di in (0, 1):
            e = j + ry * ((k + dk) + (rz + 1) * (i + di))
            out += [nv + 2 * ne_x + 2 * e, nv + 2 * ne_x + 2 * e + 1]
    for di in (0, 1):
        for dj in (0, 1):
            e = k + rz * ((i + di) + (rx + 1) * (j + dj))
            out += [nv + 2 * ne_x + 2 * ne_y + 2 * e,
                    nv + 2 * ne_x + 2 * ne_y + 2 * e + 1]
    return out


def _write_csdf(path, res=(3, 2, 4), seed=5):
    """A ``.csdf`` file in the layout ``csdf.py:135-203`` reads, its node
    values a sphere's distance plus seeded noise."""
    rx, ry, rz = res
    dmin = np.array([-1.0, -0.8, -1.2])
    cell = np.array([0.7, 0.8, 0.6])
    dmax = dmin + cell * np.array(res)
    nv = (rx + 1) * (ry + 1) * (rz + 1)
    n_nodes = nv + 2 * (rx * (ry + 1) * (rz + 1) + (rx + 1) * ry * (rz + 1)
                        + (rx + 1) * (ry + 1) * rz)
    cells = np.array([_cell_nodes(i, j, k, res) for k in range(rz)
                      for j in range(ry) for i in range(rx)], np.uint32)
    pos = jcsdf._node_positions(np.arange(n_nodes), res, dmin, cell)
    rng = np.random.default_rng(seed)
    nodes = np.linalg.norm(pos, axis=1) - 0.5 + 0.01 * rng.normal(
        size=n_nodes)
    nc = rx * ry * rz
    with open(path, "wb") as f:
        f.write(struct.pack("<3d", *dmin) + struct.pack("<3d", *dmax))
        f.write(struct.pack("<3I", *res))
        f.write(struct.pack("<3d", *cell) + struct.pack("<3d", *(1 / cell)))
        f.write(struct.pack("<2Q", nc, 1) + struct.pack("<Q", 1))
        f.write(struct.pack("<Q", n_nodes) + nodes.astype("<f8").tobytes())
        f.write(struct.pack("<Q", 1) + struct.pack("<Q", nc)
                + cells.astype("<u4").tobytes())
        f.write(struct.pack("<Q", 1) + struct.pack("<Q", nc)
                + np.arange(nc, dtype="<u4").tobytes())
    return dmin, dmax


def _csdf_f64(data, p, scale, eps=1e-4):
    """The ``.csdf`` field and its central-difference normal in float64
    (``sdf.py:417-438`` in numpy): the truth both float32 normals
    approximate."""
    res = np.asarray(data["resolution"])
    lo, cell = data["domain_min"] * scale, data["cell_size"] * scale
    vals = data["cell_values"].astype(np.float64) * scale

    def field(q):
        u = np.clip((q - lo) / cell, 0.0, res - 1e-6)
        ijk = np.minimum(np.floor(u).astype(int), res - 1)
        xi = 2.0 * (u - ijk) - 1.0
        cv = vals[ijk[..., 0], ijk[..., 1], ijk[..., 2]]
        return (cv * jcsdf.serendipity_basis(xi, data["node_xi"])).sum(-1)

    q = p.astype(np.float64)[:, None, :]
    offs = np.eye(3) * eps
    g = (field(q + offs) - field(q - offs)) / (2 * eps)
    return field(p.astype(np.float64)), g / np.linalg.norm(
        g, axis=-1, keepdims=True)


def test_csdf_reader_and_serendipity_field(tmp_path):
    """The reader exactly; the field within 1e-6. A ``.csdf`` normal is a
    float32 central difference over 2·10⁻⁴, so an ulp of the field moves
    it by ~3e-4 and JAX's own normal is that far from the float64 one: inside
    the domain the port's normal is held to JAX's own distance from the
    float64 normal (its normal is rounding noise where the clamp flattens
    the field outside)."""
    path = tmp_path / "seeded.csdf"
    _write_csdf(path)
    dj, dt = jcsdf.load_csdf(path), tcsdf.load_csdf(path)
    assert sorted(dj) == sorted(dt)
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k])
    for scale in (1.0, 1.5):
        jshape = jsdf.SDFShape.from_csdf(path, scale=scale)
        tshape = tsdf.SDFShape.from_csdf(path, scale=scale)
        p = _points(6, lo=-1.6 * scale, hi=1.6 * scale)
        d_t = tshape.distance(torch.from_numpy(p)).numpy()
        assert np.abs(d_t - np.asarray(jshape.distance(jnp.asarray(p)))
                      ).max() <= TOL
        lo = dj["domain_min"] * scale + 1e-3
        hi = dj["domain_max"] * scale - 1e-3
        p = p[((p > lo) & (p < hi)).all(-1)]
        assert len(p) > 1000
        d64, n64 = _csdf_f64(dj, p, scale)
        n_t = tshape.normal(torch.from_numpy(p)).numpy()
        n_j = np.asarray(jshape.normal(jnp.asarray(p)))
        err_t = np.abs(n_t - n64).max(-1)
        err_j = np.abs(n_j - n64).max(-1)
        assert err_j.max() > 1e-4          # the reference's own noise
        assert err_t.max() <= 2.0 * err_j.max(), (err_t.max(), err_j.max())
        assert tsdf.shape_bounding_radius(tshape) == \
            jsdf.shape_bounding_radius(jshape)
    xi = np.random.default_rng(7).uniform(-1, 1, (50, 3))
    np.testing.assert_array_equal(
        tcsdf.serendipity_basis(xi, dj["node_xi"]),
        jcsdf.serendipity_basis(xi, dj["node_xi"]))


@pytest.mark.parametrize("name,args", [
    ("sample_sphere", (0.3, 64)), ("sample_box", ((0.5, 0.2, 0.7), 4)),
    ("sample_cylinder", (0.4, 1.2, 10, 4)), ("sample_torus", (0.8, 0.2))])
def test_sampling_is_exact(name, args):
    np.testing.assert_array_equal(getattr(tsampling, name)(*args),
                                  getattr(jsampling, name)(*args))


def test_bvh_is_exact():
    pts = np.random.default_rng(8).normal(size=(77, 3)).astype(np.float32)
    np.testing.assert_array_equal(tbvh.morton_order(pts),
                                  jbvh.morton_order(pts))
    for bs in (16, 32):
        for a, b in zip(tbvh.build_block_spheres(pts, bs),
                        jbvh.build_block_spheres(pts, bs)):
            np.testing.assert_array_equal(a, b)


def _icosphere(subdiv=1, r=0.4):
    t = (1.0 + 5 ** 0.5) / 2.0
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    v = [np.array(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(subdiv):
        mid, nf = {}, []
        for a, b, c in f:
            m = []
            for i, j in ((a, b), (b, c), (c, a)):
                key = (min(i, j), max(i, j))
                if key not in mid:
                    p = v[i] + v[j]
                    v.append(p / np.linalg.norm(p))
                    mid[key] = len(v) - 1
                m.append(mid[key])
            nf += [(a, m[0], m[2]), (b, m[1], m[0]), (c, m[2], m[1]),
                   (m[0], m[1], m[2])]
        f = nf
    return r * np.array(v), np.array(f, np.int32)


def _cube():
    import torch_collision_scenes as scenes
    return scenes.cube_mesh(0.35)


@pytest.mark.parametrize("mesh", [_cube, _icosphere], ids=["cube",
                                                           "icosphere"])
def test_bake_mesh_sdf_is_bit_for_bit(mesh, tmp_path):
    v, f = mesh()
    for kw in (dict(resolution=14), dict(resolution=(9, 11, 10),
                                         padding=0.3)):
        for a, b in zip(tbake.bake_mesh_sdf(v, f, **kw),
                        jbake.bake_mesh_sdf(v, f, **kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tbake.bake_cache_key(v, f, 14, 0.2) == \
        jbake.bake_cache_key(v, f, 14, 0.2)
    first = tbake.bake_mesh_sdf_cached(v, f, 10, 0.2, cache_dir=tmp_path)
    again = tbake.bake_mesh_sdf_cached(v, f, 10, 0.2, cache_dir=tmp_path)
    for a, b, c in zip(first, again, jbake.bake_mesh_sdf(v, f, 10, 0.2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
