"""The port's scene builder against the JAX package's: a 33×29 cloth
built by both gives equal arrays (atol 1e-7: both compute the build in
float64 numpy and round once to float32), and the branches this slice of
the port does not cover raise NotImplementedError."""
import numpy as np
import pytest

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.models.mesh import TriangleMesh as JMesh
from positionbaseddynamics_tpu.solver import grid_cloth as jgc
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.models.mesh import TriangleMesh as TMesh
from positionbaseddynamics_tpu_torch.solver import grid_cloth as tgc

ATOL = 1e-7
W, H = 33, 29


def _scene(builder, **build_kw):
    b = builder()
    tm = b.add_regular_triangle_model(W, H, translation=(0.1, 0.2, -0.3),
                                      scale=(2.0, 1.5))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + W - 1, 0.0)
    b.set_mass(tm.offset + 7, 2.5)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(**build_kw)


def _np(a):
    return np.asarray(a.cpu().numpy() if hasattr(a, "cpu") else a)


def test_cloth_build_matches_jax():
    js, jc = _scene(JBuilder)
    ts, tc = _scene(TBuilder, device="cpu")
    for f in ("x", "v", "old_x", "last_x", "x0", "inv_mass"):
        np.testing.assert_allclose(_np(getattr(ts.particles, f)),
                                   _np(getattr(js.particles, f)), atol=ATOL)
    assert float(ts.time) == float(js.time) == 0.0
    assert len(tc.grid_cloths) == len(jc.grid_cloths) == 1
    assert tc.n_particles == W * H
    g, gj = tc.grid_cloths[0], jc.grid_cloths[0]
    for f in ("height", "width", "offset", "xpbd_distance", "xpbd_bending",
              "has_distance", "has_bending"):
        assert getattr(g, f) == getattr(gj, f), f
    for f in ("rest", "stiff", "q_mat", "bend_stiff"):
        td, jd = getattr(g, f), getattr(gj, f)
        assert list(td) == list(jd), f
        for fam in jd:
            assert tuple(td[fam].shape) == tuple(np.shape(jd[fam])), (f, fam)
            np.testing.assert_allclose(_np(td[fam]), _np(jd[fam]), atol=ATOL)
    for f in ("inv_cnt_dist", "inv_cnt_bend"):
        np.testing.assert_allclose(_np(getattr(g, f)), _np(getattr(gj, f)),
                                   atol=ATOL)


def test_state_fields_are_distinct_tensors():
    ts, _ = _scene(TBuilder, device="cpu")
    p = ts.particles
    ptrs = {getattr(p, f).data_ptr()
            for f in ("x", "v", "old_x", "last_x", "x0")}
    assert len(ptrs) == 5


def test_mesh_and_stencil_tables_match_jax():
    from positionbaseddynamics_tpu.models.builders import (
        regular_triangle_grid as jgrid)
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_triangle_grid as tgrid)

    pj, fj = jgrid(W, H, scale=(2.0, 1.5))
    pt, ft = tgrid(W, H, scale=(2.0, 1.5))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ft, fj)
    mj, mt = JMesh(len(pj), fj), TMesh(len(pt), ft)
    np.testing.assert_array_equal(mt.edges, mj.edges)
    np.testing.assert_array_equal(mt.edge_faces, mj.edge_faces)
    np.testing.assert_array_equal(mt.bending_stencils(),
                                  mj.bending_stencils())
    for k, (a, b) in jgc._grid_edges_np(H, W).items():
        ta, tb = tgc._grid_edges_np(H, W)[k]
        np.testing.assert_array_equal(ta, a)
        np.testing.assert_array_equal(tb, b)
    for k, sten in jgc._bend_stencils_np(H, W).items():
        for a, b in zip(tgc._bend_stencils_np(H, W)[k], sten):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call", [
    lambda b, tm: b.add_cloth_constraints(tm, method=2),
    lambda b, tm: b.add_cloth_constraints(tm, method=3),
    lambda b, tm: b.add_cloth_constraints(tm, method=7),
    lambda b, tm: b.add_bending_constraints(tm, method=1),
], ids=["fem_triangle", "strain_triangle", "unknown_method", "dihedral"])
def test_unported_branches_raise(call):
    b = TBuilder()
    tm = b.add_regular_triangle_model(5, 4)
    with pytest.raises(NotImplementedError):
        call(b, tm)


@pytest.mark.parametrize("method", ["cloth", "bending"])
def test_unstructured_grid_raises(method):
    b = TBuilder(use_structured_grid=False)
    tm = b.add_regular_triangle_model(5, 4)
    with pytest.raises(NotImplementedError):
        if method == "cloth":
            b.add_cloth_constraints(tm, method=4)
        else:
            b.add_bending_constraints(tm, method=3)


def test_build_without_cuda_and_device_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = TBuilder()
    b.add_regular_triangle_model(4, 4)
    with pytest.raises(RuntimeError):
        b.build()
