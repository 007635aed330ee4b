"""The port's scene builder against the JAX package's: a 33×29 cloth
built by both gives equal arrays (atol 1e-7: both compute the build in
float64 numpy and round once to float32), the cloth branches that take
the particle batches build the same batches, and an unknown method
raises NotImplementedError."""
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
    lambda b, tm: b.add_cloth_constraints(tm, method=7),
], ids=["unknown_method"])
def test_unported_branches_raise(call):
    b = TBuilder()
    tm = b.add_regular_triangle_model(5, 4)
    with pytest.raises(NotImplementedError):
        call(b, tm)


def assert_builds_equal(t_built, j_built):
    """The two packages' ``(state, set)`` of one scene: equal particle
    fields, the same particle batches in the same order with equal fields
    (exactly: both compute them in numpy and round once to float32), and
    equal Jacobi counts."""
    import dataclasses

    (ts, tc), (js, jc) = t_built, j_built
    for f in ("x", "v", "old_x", "last_x", "x0", "inv_mass"):
        np.testing.assert_array_equal(_np(getattr(ts.particles, f)),
                                      _np(getattr(js.particles, f)))
    assert tc.n_particles == js.particles.x.shape[0]
    names = [n for n, _ in jc.particle_batches()]
    assert [n for n, _ in tc.particle_batches()] == names
    for (name, tb), (_, jb) in zip(tc.particle_batches(),
                                   jc.particle_batches()):
        assert type(tb).__name__ == type(jb).__name__, name
        for f in dataclasses.fields(jb):
            jv, tv = getattr(jb, f.name), getattr(tb, f.name)
            if f.metadata.get("static"):
                assert tv == jv, (name, f.name)
            else:
                np.testing.assert_array_equal(_np(tv), _np(jv),
                                              err_msg=f"{name}.{f.name}")
    assert sorted(tc.jacobi_inv_counts) == sorted(jc.jacobi_inv_counts)
    for key, v in jc.jacobi_inv_counts.items():
        np.testing.assert_array_equal(_np(tc.jacobi_inv_counts[key]),
                                      _np(v), err_msg=key)
    return names


def _cloth_branch(builder, call, structured=True, **build_kw):
    b = builder(use_structured_grid=structured)
    tm = b.add_regular_triangle_model(5, 4, scale=(1.0, 0.8))
    b.set_mass(tm.offset, 0.0)
    call(b, tm)
    return b.build(**build_kw)


@pytest.mark.parametrize("call,family", [
    (lambda b, tm: b.add_cloth_constraints(tm, method=2, xx_stiffness=0.9,
                                           xy_poisson=0.2), "fem_triangle"),
    (lambda b, tm: b.add_cloth_constraints(tm, method=3,
                                           normalize_shear=True),
     "strain_triangle"),
    (lambda b, tm: b.add_bending_constraints(tm, method=1, stiffness=0.3),
     "dihedral"),
], ids=["fem_triangle", "strain_triangle", "dihedral"])
def test_cloth_branches_build_batches_as_jax(call, family):
    """The cloth branches that only the batches serve (cloth methods 2
    and 3, dihedral bending) build the same batch as JAX's builder, also
    on a structured builder's regular grid."""
    names = assert_builds_equal(_cloth_branch(TBuilder, call, device="cpu"),
                                _cloth_branch(JBuilder, call))
    assert names == [family]


@pytest.mark.parametrize("method", ["cloth", "bending"])
def test_unstructured_grid_builds_batches_as_jax(method):
    """``use_structured_grid=False`` puts a regular grid's distance and
    isometric bending in the batches, as JAX's builder does."""
    def call(b, tm):
        if method == "cloth":
            b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        else:
            b.add_bending_constraints(tm, method=3, stiffness=0.05)

    t = _cloth_branch(TBuilder, call, structured=False, device="cpu")
    names = assert_builds_equal(t, _cloth_branch(JBuilder, call,
                                                 structured=False))
    assert not t[1].grid_cloths
    assert names == ["distance" if method == "cloth"
                     else "isometric_bending"]


def test_build_without_cuda_and_device_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = TBuilder()
    b.add_regular_triangle_model(4, 4)
    with pytest.raises(RuntimeError):
        b.build()


def test_every_jax_builder_method_exists_and_the_unported_raise():
    """The port's builder has each public method of JAX's; those of later
    slices raise NotImplementedError naming their slice (6a, 6b or 7)."""
    import inspect

    from positionbaseddynamics_tpu_torch.models.builders import _UNPORTED

    jnames = {n for n, v in vars(JBuilder).items()
              if not n.startswith("_") and callable(v)}
    missing = [n for n in sorted(jnames) if not hasattr(TBuilder, n)]
    assert not missing, missing
    unported = [n for names in _UNPORTED.values() for n in names]
    assert set(unported) <= jnames
    b = TBuilder()
    for name in unported:
        with pytest.raises(NotImplementedError, match=r"slice (6a|6b|7)"):
            getattr(b, name)(*[0] * len(inspect.signature(
                getattr(JBuilder, name)).parameters))
