"""The port's mesh loaders (``utils/loaders.py``, a numpy copy) against
the JAX package's on files the test writes: OBJ with quads, negative
indices, texture coordinates and normals; PLY in ASCII and binary with
extra properties and elements; TetGen ``.node``/``.ele`` pairs with
comments, 1-based and 0-based. Outputs equal JAX's exactly (keys, dtypes,
arrays). Then the deformed meshes' face and vertex normals
(``models/mesh.py``) within 1e-6 of JAX's on seeded inputs."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models import mesh as jmesh
from positionbaseddynamics_tpu.utils import loaders as jload
from positionbaseddynamics_tpu_torch import models as tmodels
from positionbaseddynamics_tpu_torch import utils as tutils
from positionbaseddynamics_tpu_torch.models import mesh as tmesh
from positionbaseddynamics_tpu_torch.utils import loaders as tload

NORMAL_TOL = 1e-6

OBJ = """# quads, a pentagon, negative indices, texture coordinates, normals
o thing
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
v 0 0 1
v 1 0 1.5
v 1 1 1
f -3 -2 -1
f 1//1 5//1 6//1 2//1
v 2 0 0
v 2 1 0.25
f 2/2 8/3 9/4 3/1 6/2
s off
usemtl none
"""


def _same(t, j):
    if isinstance(j, dict):
        assert sorted(t) == sorted(j)
        for k in j:
            _same(t[k], j[k])
    elif isinstance(j, tuple):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
    else:
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)


def test_obj(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(OBJ)
    t, j = tload.load_obj(str(p)), jload.load_obj(str(p))
    _same(t, j)
    assert t["faces"].shape == (2 + 1 + 2 + 3, 3)
    assert "uvs" in t and "normals" in t and "uv_indices" not in t
    _same(tload.load_mesh(str(p)), j)


def test_obj_with_uv_on_every_face(tmp_path):
    p = tmp_path / "q.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
                 "vt 1 1\nvt 0 1\nf 1/1 2/2 3/3 4/4\nf -4/-4 -2/-2 -1/-1\n")
    t, j = tload.load_obj(str(p)), jload.load_obj(str(p))
    _same(t, j)
    assert t["uv_indices"].shape == (3, 3)


def _ply_header(fmt, n_v, n_f, extra=0):
    h = (f"ply\nformat {fmt} 1.0\ncomment seeded\nelement vertex {n_v}\n"
         "property float x\nproperty float y\nproperty float z\n"
         "property uchar red\n")
    if extra:
        h += f"element edge {extra}\nproperty int vertex1\n" \
             "property int vertex2\n"
    h += (f"element face {n_f}\nproperty list uchar int vertex_indices\n"
          "end_header\n")
    return h


def _ply_data(seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(7, 3)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5], [1, 5, 6, 0, 3]]
    return v, faces


def test_ply_ascii(tmp_path):
    v, faces = _ply_data()
    body = "".join(f"{a!r} {b!r} {c!r} 7\n" for a, b, c in v.tolist())
    body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n"
                    for f in faces)
    p = tmp_path / "a.ply"
    p.write_text(_ply_header("ascii", len(v), len(faces)) + body)
    t, j = tload.load_ply(str(p)), jload.load_ply(str(p))
    _same(t, j)
    assert t["faces"].shape == (1 + 2 + 3, 3)
    _same(tload.load_mesh(str(p)), j)


@pytest.mark.parametrize("extra", [0, 2], ids=["plain", "edge_element"])
def test_ply_binary(tmp_path, extra):
    v, faces = _ply_data(1)
    body = b"".join(struct.pack("<fffB", *row, 9) for row in v.tolist())
    body += b"".join(struct.pack("<ii", i, i + 1) for i in range(extra))
    body += b"".join(struct.pack("<B", len(f)) + struct.pack(
        f"<{len(f)}i", *f) for f in faces)
    p = tmp_path / "b.ply"
    p.write_bytes(_ply_header("binary_little_endian", len(v), len(faces),
                              extra).encode() + body)
    t, j = tload.load_ply(str(p)), jload.load_ply(str(p))
    _same(t, j)
    np.testing.assert_array_equal(t["vertices"], v.astype(np.float64))


@pytest.mark.parametrize("first", [1, 0])
def test_tetgen(tmp_path, first):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(6, 3))
    tets = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [2, 3, 4, 5]])
    node = "# nodes\n\n6 3 0 0\n" + "".join(
        f"{i + first} {a!r} {b!r} {c!r}\n"
        for i, (a, b, c) in enumerate(pts.tolist())) + "# end\n"
    ele = "3 4 0\n# comment\n" + "".join(
        f"{i + first} " + " ".join(str(k + first) for k in t) + "\n"
        for i, t in enumerate(tets))
    (tmp_path / "m.node").write_text(node)
    (tmp_path / "m.ele").write_text(ele)
    args = (str(tmp_path / "m.node"), str(tmp_path / "m.ele"))
    t, j = tload.load_tetgen(*args), jload.load_tetgen(*args)
    _same(t, j)
    np.testing.assert_array_equal(t[1], tets)


def test_utils_exports_match_jax():
    from positionbaseddynamics_tpu import utils as jutils

    assert sorted(tutils.__all__) == sorted(jutils.__all__)
    for name in ("load_mesh", "load_obj", "load_ply", "load_tetgen"):
        assert getattr(tutils, name) is getattr(tload, name)
    assert tmodels.face_normals is tmesh.face_normals
    assert tmodels.vertex_normals is tmesh.vertex_normals


def _mesh(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, size=(60, 3)).astype(np.int32)
    faces[0] = [3, 3, 7]                      # degenerate: UnitX
    x[12] = x[11]
    faces[1] = [11, 12, 13]                   # zero area: UnitX
    return x, faces


@pytest.mark.parametrize("seed", [0, 1])
def test_face_and_vertex_normals(seed):
    x, faces = _mesh(seed)
    fj = np.asarray(jmesh.face_normals(jnp.asarray(x), jnp.asarray(faces)))
    ft = tmesh.face_normals(torch.from_numpy(x), faces).numpy()
    np.testing.assert_allclose(ft, fj, atol=NORMAL_TOL, rtol=0)
    np.testing.assert_array_equal(ft[:2], [[1, 0, 0], [1, 0, 0]])
    for n in (None, 45):
        vj = np.asarray(jmesh.vertex_normals(jnp.asarray(x),
                                             jnp.asarray(faces), n))
        vt = tmesh.vertex_normals(torch.from_numpy(x), faces, n).numpy()
        assert vt.shape == vj.shape
        np.testing.assert_allclose(vt, vj, atol=NORMAL_TOL, rtol=0)


def test_normals_take_leading_axes():
    """``(..., N, 3)`` positions: each rollout's normals as alone, and a
    tensor of faces as a numpy one."""
    xs = np.stack([_mesh(s)[0] for s in (0, 1, 2)])
    _, faces = _mesh(0)
    xt = torch.from_numpy(xs)
    ft = tmesh.face_normals(xt, torch.from_numpy(faces))
    vt = tmesh.vertex_normals(xt, faces)
    assert ft.shape == (3, 60, 3) and vt.shape == (3, 40, 3)
    for k in range(3):
        assert torch.equal(ft[k], tmesh.face_normals(xt[k], faces))
        assert torch.equal(vt[k], tmesh.vertex_normals(xt[k], faces))
