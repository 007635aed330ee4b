"""The port's constraint ops (``ops/pbd.py``, ``ops/xpbd.py``) and the 3×3
helpers of ``ops/mathutils.py`` against the JAX package's, on the CPU.

The JAX functions solve one constraint and run under ``jax.vmap``; the
port's take the batch as leading axes. Inputs are seeded numpy: 64 rows of
points near a rest shape, jittered, with random inverse masses (some 0),
stiffnesses and λ. Tolerance: 1e-6 absolute plus 1e-5 relative (float32
on both sides; XLA and PyTorch may pair a sum's terms otherwise). Both
forms of the signed SVD are held to the products they feed: ``U diag(σ)
Vᵀ`` against the input, σ against JAX's, ``U`` and ``V`` rotations, and the
FEM energy and stress built on them. Inverted tets, reflections and
degenerate inputs are among the rows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.ops import mathutils as jmu
from positionbaseddynamics_tpu.ops import pbd as jpbd
from positionbaseddynamics_tpu.ops import xpbd as jxpbd
from positionbaseddynamics_tpu_torch.ops import mathutils as tmu
from positionbaseddynamics_tpu_torch.ops import pbd as tpbd
from positionbaseddynamics_tpu_torch.ops import xpbd as txpbd

B = 64
ATOL, RTOL = 1e-6, 1e-5
DT = 1e-3


def _close(t, j, atol=ATOL, rtol=RTOL, what=""):
    ts = t if isinstance(t, (tuple, list)) else (t,)
    js = j if isinstance(j, (tuple, list)) else (j,)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=what)


def _run(jfn, tfn, args, **kw):
    """``jax.vmap(jfn)`` and ``tfn`` on the same float32 rows."""
    args = [np.array(a, np.float32) for a in args]
    j = jax.vmap(jfn)(*[jnp.asarray(a) for a in args])
    t = tfn(*[torch.from_numpy(a) for a in args])
    _close(tuple(x.numpy() for x in t) if isinstance(t, tuple) else t.numpy(),
           j, **kw)
    return t, j


def _points(rng, k, scale=0.3, jitter=0.05):
    """``k`` point arrays ``(B, 3)``: a random rest shape of a few
    decimetres, jittered row by row."""
    base = rng.normal(0.0, scale, (1, k, 3))
    pts = base + rng.normal(0.0, jitter, (B, k, 3))
    return [pts[:, i] for i in range(k)]


def _weights(rng, k):
    w = rng.uniform(0.2, 2.0, (B, k))
    w[rng.random((B, k)) < 0.15] = 0.0
    return [w[:, i] for i in range(k)]


def _pw(rng, k, **kw):
    """``[p0, w0, p1, w1, ...]``."""
    ps, ws = _points(rng, k, **kw), _weights(rng, k)
    return [a for pair in zip(ps, ws) for a in pair]


def _tets(rng, invert=0.25):
    """Tet corners near a regular tet, a quarter of the rows inverted (two
    corners swapped), and their rest data as the FEM-tet batch makes it."""
    rest = np.array([[0, 0, 0], [0.4, 0, 0], [0, 0.4, 0], [0, 0, 0.4]],
                    np.float64)
    x0 = rest[None] + rng.normal(0, 0.03, (B, 4, 3))
    x = x0 + rng.normal(0, 0.04, (B, 4, 3))
    flip = rng.random(B) < invert
    x[flip] = x[flip][:, [1, 0, 2, 3]]
    dm = np.stack([x0[:, 0] - x0[:, 3], x0[:, 1] - x0[:, 3],
                   x0[:, 2] - x0[:, 3]], axis=-1)
    vol = np.abs(np.einsum("cd,cd->c", np.cross(x0[:, 1] - x0[:, 0],
                                                x0[:, 2] - x0[:, 0]),
                           x0[:, 3] - x0[:, 0]) / 6.0)
    return [x[:, i] for i in range(4)], np.linalg.inv(dm), vol, flip


def _matrices(rng):
    """3×3 matrices: random, reflections (det < 0), near rotations,
    rank-2, rank-1, zero and diagonal with repeated values."""
    a = rng.normal(0.0, 1.0, (B, 3, 3))
    a[8:16, 2] *= -1.0
    q, _ = np.linalg.qr(rng.normal(0.0, 1.0, (8, 3, 3)))
    a[16:24] = q + rng.normal(0, 1e-3, (8, 3, 3))
    a[24:28, 2] = a[24:28, 0] + a[24:28, 1]
    a[28:30] = np.einsum("bi,bj->bij", rng.normal(0, 1, (2, 3)),
                         rng.normal(0, 1, (2, 3)))
    a[30] = 0.0
    a[31] = np.diag([2.0, 2.0, 0.5])
    return a


# -- mathutils -------------------------------------------------------------


def test_small_helpers_match_jax():
    rng = np.random.default_rng(0)
    v, w = rng.normal(0, 1, (B, 3)), rng.normal(0, 1, (B, 3))
    _run(jmu.cot_theta, tmu.cot_theta, [v, w])
    # parallel vectors take the guard: finite, of the sign of v·w (XLA's
    # fused multiply-adds leave JAX's cross product a rounding error
    # instead of 0 there, so the values themselves are not compared)
    par = tmu.cot_theta(torch.from_numpy(v[:4].astype(np.float32)),
                        torch.from_numpy(2 * v[:4].astype(np.float32)))
    assert torch.isfinite(par).all() and (par > 1e6).all()
    a = _matrices(rng)
    _run(jmu.mv3, tmu.mv3, [a, v])
    _run(jmu.mm3, tmu.mm3, [a, a[::-1]])
    _run(jmu.det3, tmu.det3, [a])
    _run(jmu.cross_product_matrix, tmu.cross_product_matrix, [v])
    # the inverse is compared where the matrix is well conditioned
    good = np.abs(np.linalg.det(a)) > 0.05
    _run(jmu.inv3, tmu.inv3, [a[good]], rtol=1e-4)


def _svd_checks(u, s, vt, a, s_ref):
    u, s, vt = (np.asarray(x, np.float64) for x in (u, s, vt))
    recon = np.einsum("bij,bj,bjk->bik", u, s, vt)
    np.testing.assert_allclose(recon, a, atol=2e-5, rtol=0)
    np.testing.assert_allclose(s, s_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.linalg.det(u), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(vt), 1.0, atol=1e-5)


@pytest.mark.parametrize("form", ["lapack", "jacobi"])
def test_signed_svd_forms_match_jax(form):
    rng = np.random.default_rng(1)
    a = _matrices(rng).astype(np.float32)
    jf = {"lapack": jmu._svd_inversion_handling_lapack,
          "jacobi": jmu._svd_inversion_handling_jacobi}[form]
    tf = {"lapack": tmu._svd_inversion_handling_lapack,
          "jacobi": tmu._svd_inversion_handling_jacobi}[form]
    ju, js, jvt = jax.vmap(jf)(jnp.asarray(a))
    tu, ts, tvt = tf(torch.from_numpy(a))
    # the full-rank rows: a unique factorisation up to the sign pairing
    full = slice(0, 24)
    _svd_checks(tu[full], ts[full], tvt[full], a[full], np.asarray(js)[full])
    _svd_checks(ju[full], js[full], jvt[full], a[full], np.asarray(js)[full])
    # every row, rank-deficient ones included: the product is about as
    # close to the input as JAX's (in the Jacobi form a zero singular
    # value comes out as the root of AᵀA's rounding, ~1e-4, in JAX's as in
    # the port's, on rows that differ between the two)
    err = np.abs(torch.einsum("bij,bj,bjk->bik", tu, ts, tvt).numpy()
                 - a).max((-1, -2))
    jerr = np.abs(np.einsum("bij,bj,bjk->bik", np.asarray(ju),
                            np.asarray(js), np.asarray(jvt))
                  - a).max((-1, -2))
    assert err.max() <= max(2e-5, 2.0 * jerr.max()), (err, jerr)
    # the CPU tensor takes the LAPACK form, as JAX on the CPU
    u, s, vt = tmu.svd_inversion_handling(torch.from_numpy(a))
    np.testing.assert_allclose(s.numpy(), np.asarray(
        jax.vmap(jmu.svd_inversion_handling)(jnp.asarray(a))[1]),
        atol=1e-6, rtol=1e-6)


def test_jacobi_eigh_matches_jax():
    rng = np.random.default_rng(2)
    a = _matrices(rng)
    sym = np.einsum("bki,bkj->bij", a, a).astype(np.float32)
    jl, jv = jax.vmap(jmu._jacobi_eigh_3x3)(jnp.asarray(sym))
    tl, tv = tmu._jacobi_eigh_3x3(torch.from_numpy(sym))
    _close(tl.numpy(), jl, atol=1e-5)
    # eigenvectors where the eigenvalues are apart (not the near
    # rotations, whose AᵀA is close to I)
    lam = np.sort(np.asarray(jl), axis=-1)
    apart = np.diff(lam, axis=-1).min(-1) > 1e-2
    assert apart.sum() > 40
    _close(tv.numpy()[apart], np.asarray(jv)[apart])
    v, lam = tv.numpy().astype(np.float64), tl.numpy().astype(np.float64)
    np.testing.assert_allclose(np.einsum("bij,bj,bkj->bik", v, lam, v), sym,
                               atol=5e-5)


def test_polar_decompositions_match_jax():
    """On full-rank inputs; the zero matrix gives the identity. A singular
    but nonzero input has no unique rotation factor, and the scaled Newton
    iteration's outcome there turns on whether its determinant rounds to
    exactly 0, so those rows are not compared."""
    rng = np.random.default_rng(3)
    a = _matrices(rng)
    full = [*range(24), 31]
    _run(jmu.polar_decomposition_stable, tmu.polar_decomposition_stable,
         [a[full]])
    zero = tmu.polar_decomposition_stable(torch.zeros((1, 3, 3)))
    np.testing.assert_array_equal(zero[0].numpy(), np.eye(3))
    np.testing.assert_array_equal(np.asarray(
        jmu.polar_decomposition_stable(jnp.zeros((3, 3)))), np.eye(3))
    # the SVD form, where R is unique
    full = a[:24].astype(np.float32)
    jr, js = jax.vmap(jmu.polar_decomposition)(jnp.asarray(full))
    tr, ts = tmu.polar_decomposition(torch.from_numpy(full))
    _close((tr.numpy(), ts.numpy()), (jr, js))


# -- pbd -------------------------------------------------------------------


def _k(rng, lo=0.1, hi=1.0):
    return rng.uniform(lo, hi, B)


def test_pbd_distance_matches_jax():
    rng = np.random.default_rng(10)
    args = _pw(rng, 2) + [rng.uniform(0.1, 0.6, B), _k(rng)]
    _run(jpbd.solve_distance, tpbd.solve_distance, args)


def test_pbd_dihedral_matches_jax():
    """Two triangles folded about 1 rad on the shared edge (p2, p3), each
    row jittered; near a flat or a closed fold ``arccos`` has an unbounded
    slope and amplifies any rounding of its argument."""
    rng = np.random.default_rng(11)
    a = 1.0
    base = np.array([[0.2, 0.3, 0.0], [0.2, -0.3 * np.cos(a), 0.3 * np.sin(a)],
                     [0.0, 0.0, 0.0], [0.4, 0.0, 0.0]])
    pts = base[None] + rng.normal(0.0, 0.02, (B, 4, 3))
    ws = _weights(rng, 4)
    pw = [v for i in range(4) for v in (pts[:, i], ws[i])]
    pw[4][:3] = pw[6][:3]                # a degenerate shared edge
    _run(jpbd.solve_dihedral, tpbd.solve_dihedral,
         pw + [rng.uniform(0.5, 1.5, B), _k(rng)])


def test_pbd_volume_matches_jax():
    rng = np.random.default_rng(12)
    k = _k(rng)
    k[:4] = 0.0
    args = _pw(rng, 4) + [rng.uniform(-0.01, 0.01, B), k]
    _run(jpbd.solve_volume, tpbd.solve_volume, args)


def _q_mats(rng):
    pts = np.stack(_points(rng, 4, jitter=0.02), axis=1)
    return jax.vmap(jxpbd.init_isometric_bending)(
        *[jnp.asarray(pts[:, i], jnp.float32) for i in range(4)])


def test_isometric_bending_both_forms_match_jax():
    rng = np.random.default_rng(13)
    q = np.asarray(_q_mats(rng))
    pw = _pw(rng, 4)
    _run(jpbd.solve_isometric_bending, tpbd.solve_isometric_bending,
         pw + [q, _k(rng)])
    lam = rng.normal(0, 1e-3, B)
    dt = np.full(B, DT)
    _run(jxpbd.solve_isometric_bending, txpbd.solve_isometric_bending,
         pw + [q, rng.uniform(0.01, 1.0, B), dt, lam])


def _tri_rest(rng):
    pts = np.stack(_points(rng, 3, jitter=0.02), axis=1)
    from positionbaseddynamics_tpu.solver.constraints import (
        _init_fem_triangle_np, _init_strain_triangle_np)
    return pts, _init_fem_triangle_np(pts), _init_strain_triangle_np(pts)


def test_fem_triangle_matches_jax():
    rng = np.random.default_rng(14)
    _, (area, inv), _ = _tri_rest(rng)
    args = _pw(rng, 3) + [area, inv, _k(rng, 0.5, 2), _k(rng, 0.5, 2),
                          _k(rng, 0.5, 2), _k(rng, 0.1, 0.4),
                          _k(rng, 0.1, 0.4)]
    _run(jpbd.solve_fem_triangle, tpbd.solve_fem_triangle, args)


@pytest.mark.parametrize("ns,nh", [(False, False), (True, True)])
def test_strain_triangle_matches_jax(ns, nh):
    rng = np.random.default_rng(15)
    _, _, inv = _tri_rest(rng)
    args = _pw(rng, 3) + [inv, rng.uniform(0.2, 1, (B, 2)),
                          rng.uniform(0.2, 1, (B, 1))]
    _run(functools.partial(jpbd.solve_strain_triangle, normalize_stretch=ns,
                           normalize_shear=nh),
         functools.partial(tpbd.solve_strain_triangle, normalize_stretch=ns,
                           normalize_shear=nh), args)


@pytest.mark.parametrize("ns,nh", [(False, False), (True, True)])
def test_strain_tetra_matches_jax(ns, nh):
    from positionbaseddynamics_tpu.solver.constraints import (
        _init_strain_tetra_np)
    rng = np.random.default_rng(16)
    ps, _, _, _ = _tets(rng, invert=0.0)
    x0 = np.stack(ps, axis=1) + rng.normal(0.0, 0.03, (B, 4, 3))
    inv = _init_strain_tetra_np(x0)
    ws = _weights(rng, 4)
    pw = [v for i in range(4) for v in (ps[i], ws[i])]
    args = pw + [inv, rng.uniform(0.2, 1, (B, 3)), rng.uniform(0.2, 1, (B, 3))]
    _run(functools.partial(jpbd.solve_strain_tetra, normalize_stretch=ns,
                           normalize_shear=nh),
         functools.partial(tpbd.solve_strain_tetra, normalize_stretch=ns,
                           normalize_shear=nh), args)


def _fem_args(rng):
    ps, inv, vol, flip = _tets(rng)
    ws = _weights(rng, 4)
    pw = [a for pair in zip(ps, ws) for a in pair]
    assert flip.any() and (~flip).any()
    return pw, inv, vol


def test_fem_tetra_classic_matches_jax_with_inverted_tets():
    rng = np.random.default_rng(17)
    pw, inv, vol = _fem_args(rng)
    youngs = rng.uniform(0.5, 2.0, B)
    youngs[:3] = 0.0
    _run(jpbd.solve_fem_tetra_classic, tpbd.solve_fem_tetra_classic,
         pw + [vol, inv, youngs, rng.uniform(0.1, 0.45, B)])


def test_shape_matching_cluster_matches_jax():
    rng = np.random.default_rng(18)
    k = 6
    x0 = rng.normal(0, 0.3, (B, k, 3))
    x = x0 + rng.normal(0, 0.05, (B, k, 3))
    w = rng.uniform(0.2, 2.0, (B, k))
    w[:, 0][rng.random(B) < 0.3] = 0.0
    mask = np.ones((B, k))
    mask[::3, -2:] = 0.0                 # padded clusters
    m = mask / (w + 1e-6)
    rest_cm = (m[..., None] * x0).sum(1) / m.sum(1, keepdims=True)
    x[5] = rest_cm[5]                    # collapsed: a degenerate A_pq
    _run(jpbd.solve_shape_matching_cluster,
         tpbd.solve_shape_matching_cluster,
         [x, x0, w, rest_cm, _k(rng), mask])


def test_point_edge_triangle_and_edge_edge_distances_match_jax():
    rng = np.random.default_rng(19)
    comp, stretch = _k(rng), _k(rng)
    pw3 = _pw(rng, 3)
    _run(jpbd.solve_edge_point_distance, tpbd.solve_edge_point_distance,
         pw3 + [rng.uniform(0.0, 0.2, B), comp, stretch])
    pw4 = _pw(rng, 4)
    _run(jpbd.solve_triangle_point_distance,
         tpbd.solve_triangle_point_distance,
         pw4 + [rng.uniform(0.0, 0.2, B), comp, stretch])
    # edge-edge, a quarter of the rows parallel (the overlap rule)
    pe = _pw(rng, 4)
    d = pe[2] - pe[0]
    pe[4][:16] = pe[0][:16] + 0.1
    pe[6][:16] = pe[4][:16] + d[:16] * 0.7
    _run(jpbd.solve_edge_edge_distance, tpbd.solve_edge_edge_distance,
         pe + [rng.uniform(0.0, 0.2, B), comp, stretch])


# -- xpbd ------------------------------------------------------------------


def test_xpbd_distance_and_volume_match_jax():
    rng = np.random.default_rng(20)
    dt = np.full(B, DT)
    stiff = rng.uniform(1e2, 1e5, B)
    stiff[:4] = 0.0                      # infinitely stiff: α = 0
    _run(jxpbd.compliance, txpbd.compliance, [stiff, dt])
    lam = rng.normal(0, 1e-3, B)
    _run(jxpbd.solve_distance, txpbd.solve_distance,
         _pw(rng, 2) + [rng.uniform(0.1, 0.6, B), stiff, dt, lam])
    _run(jxpbd.solve_volume, txpbd.solve_volume,
         _pw(rng, 4) + [rng.uniform(-0.01, 0.01, B), stiff, dt, lam])


def test_init_isometric_bending_matches_jax():
    rng = np.random.default_rng(21)
    pts = _points(rng, 4, jitter=0.02)
    _run(jxpbd.init_isometric_bending, txpbd.init_isometric_bending, pts,
         atol=1e-5)


@pytest.mark.parametrize("fn", ["green_strain_energy",
                                "green_strain_energy_inversion"])
def test_green_strain_energies_match_jax(fn):
    rng = np.random.default_rng(22)
    ps, inv, vol, _ = _tets(rng)
    mu, lame = rng.uniform(0.3, 0.5, B), rng.uniform(0.3, 1.0, B)
    t, j = _run(getattr(jxpbd, fn), getattr(txpbd, fn),
                ps + [inv, vol, mu, lame])
    _run(jxpbd.grad_c_green, txpbd.grad_c_green, [vol, inv, np.asarray(j[1])],
         atol=1e-5)


def test_green_strain_energy_inversion_jacobi_form_feeds_the_same_stress(
        monkeypatch):
    """The Jacobi SVD (the card's form) gives the energy and stress of the
    LAPACK form, inverted tets included."""
    rng = np.random.default_rng(23)
    ps, inv, vol, flip = _tets(rng)
    assert flip.any()
    args = [torch.from_numpy(np.asarray(a, np.float32))
            for a in ps + [inv, vol]]
    lapack = txpbd.green_strain_energy_inversion(*args, 0.4, 0.6)
    monkeypatch.setattr(txpbd, "svd_inversion_handling",
                        tmu._svd_inversion_handling_jacobi)
    jacobi = txpbd.green_strain_energy_inversion(*args, 0.4, 0.6)
    for a, b in zip(jacobi[:2], lapack[:2]):
        _close(a.numpy(), b.numpy())


def test_xpbd_fem_tetra_matches_jax_with_inverted_tets():
    rng = np.random.default_rng(24)
    pw, inv, vol = _fem_args(rng)
    youngs = rng.uniform(1e3, 1e5, B)
    youngs[:3] = 0.0
    _run(jxpbd.solve_fem_tetra, txpbd.solve_fem_tetra,
         pw + [vol, inv, youngs, rng.uniform(0.1, 0.45, B), np.full(B, DT),
               rng.normal(0, 1e-4, B)])
