"""The port's particle batches (``solver/constraints.py``) against the JAX
package's, on the CPU.

Every batch is created by both packages from the same seeded numpy
inputs: its fields must be equal exactly (both compute them in the same
numpy code and round once to float32) and its static fields the same.
``solve`` on the same positions, inverse masses (some 0) and λ agrees to
1e-6 absolute plus 1e-5 relative; classic isometric bending to 1e-5
absolute, since its ``Q x`` over absolute positions cancels terms ~1e2
times the gradient (XLA's fused multiply-adds round them otherwise). ``scatter_add`` is held to JAX's below
and above the 8,192 rows where JAX's jitted step switches to its planned
scatter, with out-of-range indices dropped, and ``with_jacobi_counts`` to
JAX's counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.solver import constraints as jcs
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import constraints as tcs

ATOL, RTOL = 1e-6, 1e-5
DT = 0.001


def _mesh(rng):
    """Rest positions of a 4×3×3 tet grid and a folded 6×5 triangle grid,
    their tets, faces and bending stencils, and the current positions
    (rest plus 1 cm of jitter) and inverse masses (every seventh 0)."""
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_tet_grid, regular_triangle_grid)
    from positionbaseddynamics_tpu_torch.models.mesh import TriangleMesh

    pt, tets = regular_tet_grid(4, 3, 3, scale=(1.2, 0.8, 0.8))
    pc, faces = regular_triangle_grid(6, 5)
    pc[:, 2] = 0.25 * np.sin(3.0 * pc[:, 0]) + 0.15 * np.cos(4.0 * pc[:, 1])
    faces = faces + len(pt)
    stencils = TriangleMesh(len(pc), faces - len(pt)).bending_stencils()
    x0 = np.concatenate([pt, pc]).astype(np.float32)
    n = len(x0)
    x = x0 + rng.normal(0.0, 0.01, x0.shape).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    inv_mass[::7] = 0.0
    return (x0, tets.astype(np.int32), faces.astype(np.int32),
            (stencils + len(pt)).astype(np.int32), x, inv_mass)


def _batches(rng):
    """``{name: (class, create args, create kwargs)}`` shared by both
    packages."""
    from positionbaseddynamics_tpu_torch.models.mesh import TetMesh

    x0, tets, faces, stencils, _, _ = _mesh(rng)
    edges = TetMesh(len(x0), tets).edges

    def k(c, lo=0.2, hi=1.0):
        return rng.uniform(lo, hi, c).astype(np.float32)

    rest = np.linalg.norm(x0[edges[:, 0]] - x0[edges[:, 1]], axis=-1)
    ns, nt, nb = len(stencils), len(tets), len(faces)
    clusters = [list(map(int, r)) for r in tets] + [[1, 2, 3, 14, 15]]
    return {
        "distance_xpbd": ("DistanceBatch", (edges, rest, k(len(edges), 1e2,
                                                           1e5)),
                          dict(xpbd_mode=True)),
        "distance_classic": ("DistanceBatch", (edges, rest, k(len(edges))),
                             dict(xpbd_mode=False)),
        "isometric_xpbd": ("IsometricBendingBatch", (stencils, x0, k(ns)),
                           dict(xpbd_mode=True)),
        "isometric_classic": ("IsometricBendingBatch",
                              (stencils, x0, k(ns)), dict(xpbd_mode=False)),
        "dihedral": ("DihedralBatch", (stencils, x0, k(ns)), {}),
        "volume_xpbd": ("VolumeBatch", (tets, x0, k(nt, 1e2, 1e5)),
                        dict(xpbd_mode=True)),
        "volume_classic": ("VolumeBatch", (tets, x0, k(nt)),
                           dict(xpbd_mode=False)),
        "fem_tetra_xpbd": ("FEMTetraBatch", (tets, x0, k(nt, 1e2, 1e5), 0.3),
                           dict(xpbd_mode=True)),
        "fem_tetra_classic": ("FEMTetraBatch", (tets, x0, k(nt), 0.3),
                              dict(xpbd_mode=False)),
        "fem_triangle": ("FEMTriangleBatch",
                         (faces, x0, k(nb), 0.8, 0.5, 0.3, 0.2), {}),
        "strain_triangle": ("StrainTriangleBatch",
                            (faces, x0, (0.9, 0.7), 0.5),
                            dict(normalize_stretch=True)),
        "strain_tetra": ("StrainTetraBatch", (tets, x0, 0.8, 0.6),
                         dict(normalize_shear=True)),
        "shape_matching": ("ShapeMatchingBatch", (clusters, x0, 0.7), {}),
    }


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_fields_equal(tb, jb):
    import dataclasses

    for f in dataclasses.fields(jb):
        jv, tv = getattr(jb, f.name), getattr(tb, f.name)
        if f.metadata.get("static"):
            assert tv == jv, f.name
        else:
            np.testing.assert_array_equal(_np(tv), _np(jv), err_msg=f.name)
    assert tb.self_averaged == getattr(jb, "self_averaged", False)


@pytest.mark.parametrize("name", list(_batches(np.random.default_rng(0))))
def test_batch_create_and_solve_match_jax(name):
    rng = np.random.default_rng(1)
    cls, args, kw = _batches(rng)[name]
    jb = getattr(jcs, cls).create(*args, **kw)
    tb = getattr(tcs, cls).create(*args, **kw, device="cpu")
    _assert_fields_equal(tb, jb)
    assert tb.n_rows == jb.idx.shape[0]

    *_, x, inv_mass = _mesh(np.random.default_rng(1))
    if name == "shape_matching":
        # final masses with pins, as the builder's finalize
        jb, tb = jb.finalize(inv_mass), tb.finalize(inv_mass)
        _assert_fields_equal(tb, jb)
    lam = np.asarray(jb.init_lambda())
    assert tuple(tb.init_lambda().shape) == lam.shape
    lam = rng.normal(0.0, 1e-4, lam.shape).astype(np.float32)
    jc, jl = jb.solve(jnp.asarray(x), jnp.asarray(inv_mass),
                      jnp.asarray(lam), DT)
    tc, tl = tb.solve(torch.from_numpy(x), torch.from_numpy(inv_mass),
                      torch.from_numpy(lam), DT)
    atol = 1e-5 if name == "isometric_classic" else ATOL
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=atol,
                               rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    assert np.abs(np.asarray(jc)).max() > 1e-6    # the solve moved something


def test_batch_solve_keeps_rollout_axes():
    """K rollouts as a leading axis give each rollout's own solve; the
    inverse masses are shared ``(N,)`` or per rollout ``(K, N)``."""
    rng = np.random.default_rng(2)
    cls, args, kw = _batches(rng)["fem_tetra_xpbd"]
    tb = getattr(tcs, cls).create(*args, **kw, device="cpu")
    *_, x, inv_mass = _mesh(rng)
    xs = torch.from_numpy(np.stack([x, x * 1.01, x - 0.02]))
    w = torch.from_numpy(inv_mass)
    lam = tb.init_lambda()
    corr, new_lam = tb.solve(xs, w, lam, DT)
    corr2, _ = tb.solve(xs, w.expand(3, -1), lam, DT)
    assert corr.shape == (3, tb.n_rows, 4, 3)
    assert new_lam.shape == (3, tb.n_rows)
    np.testing.assert_array_equal(corr.numpy(), corr2.numpy())
    for k in range(3):
        one, l1 = tb.solve(xs[k], w, lam, DT)
        np.testing.assert_array_equal(corr[k].numpy(), one.numpy())
        np.testing.assert_array_equal(new_lam[k].numpy(), l1.numpy())


@pytest.mark.parametrize("rows", [1000, 20000])
def test_scatter_add_matches_jax(rows):
    """Below and above JAX's 8,192-row switch to the planned scatter:
    equal to ``.at[].add`` (both add in row order on the CPU), and within
    1e-4 of the planned form, whose error at a tile crossing is bounded by
    ε·Σ|corr| over a 512-row tile (~5e-5 for these unit normal rows).
    Indices from −n wrap; others outside [0, n) are dropped."""
    rng = np.random.default_rng(3)
    n = 500
    idx = rng.integers(0, n, (rows // 2, 2)).astype(np.int32)
    corr = rng.normal(0.0, 1.0, (rows // 2, 2, 3)).astype(np.float32)
    j = np.asarray(jcs.scatter_add(n, jnp.asarray(idx), jnp.asarray(corr)))
    t = tcs.scatter_add(n, torch.from_numpy(idx), torch.from_numpy(corr))
    np.testing.assert_array_equal(t.numpy(), j)
    if rows > 8192:
        plan = jcs.make_scatter_plan(n, idx)
        planned = np.asarray(jcs.scatter_add_planned(plan, jnp.asarray(corr)))
        np.testing.assert_allclose(t.numpy(), planned, atol=1e-4, rtol=0)
    bad = idx.copy()
    bad[:5, 0] = n + 3
    bad[5:10, 1] = -1
    bad[10:12, 0] = -n - 2
    j = np.asarray(jcs.scatter_add(n, jnp.asarray(bad), jnp.asarray(corr)))
    t = tcs.scatter_add(n, torch.from_numpy(bad), torch.from_numpy(corr))
    np.testing.assert_array_equal(t.numpy(), j)
    # leading rollout axes
    two = tcs.scatter_add(n, torch.from_numpy(idx),
                          torch.from_numpy(np.stack([corr, 2 * corr])))
    np.testing.assert_array_equal(two[1].numpy(), 2 * two[0].numpy())


def _mixed(builder, **build_kw):
    """A tet model under XPBD and classic distance and volume constraints
    and a shape-matching cluster, beside a cloth under strain triangles
    of two flag sets."""
    b = builder(use_structured_grid=False)
    tm = b.add_regular_tet_model(3, 3, 2, scale=(1.0, 1.0, 0.5))
    b.add_solid_constraints(tm, method=6, stiffness=1e4,
                            volume_stiffness=1e4)
    b.add_solid_constraints(tm, method=1, stiffness=0.5,
                            volume_stiffness=0.5)
    b.add_shape_matching_constraint([0, 1, 4, 9], stiffness=0.5)
    cm = b.add_regular_triangle_model(4, 3, translation=(0, 2, 0))
    b.add_cloth_constraints(cm, method=3)
    b.add_strain_triangle_constraint(cm.offset, cm.offset + 1,
                                     cm.offset + 4, normalize_stretch=True)
    b.set_mass(0, 0.0)
    return b.build(**build_kw)


def test_with_jacobi_counts_and_mixed_families_match_jax():
    _, jc = _mixed(JBuilder)
    _, tc = _mixed(TBuilder, device="cpu")
    jn = [n for n, _ in jc.particle_batches()]
    assert [n for n, _ in tc.particle_batches()] == jn
    assert jn == ["distance", "strain_triangle", "volume", "shape_matching",
                  "extra0", "extra1", "extra2"]
    assert sorted(tc.jacobi_inv_counts) == sorted(jc.jacobi_inv_counts)
    for key, v in jc.jacobi_inv_counts.items():
        np.testing.assert_array_equal(tc.jacobi_inv_counts[key].numpy(),
                                      np.asarray(v), err_msg=key)
    for (name, tb), (_, jb) in zip(tc.particle_batches(),
                                   jc.particle_batches()):
        assert type(tb).__name__ == type(jb).__name__, name
        _assert_fields_equal(tb, jb)


def test_with_jacobi_counts_refuses_indices_outside_the_scene():
    tb = tcs.DistanceBatch.create([[0, 5]], [1.0], 1.0, device="cpu")
    with pytest.raises(ValueError):
        tcs.ConstraintSet(distance=tb, n_particles=5).with_jacobi_counts(5)
