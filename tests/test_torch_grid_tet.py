"""The port's structured tet-grid solver (solver/grid_tet.py), its mesh and
grid builders and the 3×3 helpers it uses (ops/mathutils.py, ops/xpbd.py)
against the JAX package's, called eagerly on the same numpy inputs.

Tolerances: the batch fields and the topology are built in float64 numpy
by both and rounded once to float32, so they must be equal. ``project``
and ``project_gs`` run the same float32 operations in the same order as
eager JAX (sums left to right, a correctly rounded square root), so they
are held to 1e-6, a margin of a few ulps over the exact agreement they
show. The SVD-based inversion path is held to 1e-5: LAPACK's float32 SVD
may differ between the two packages in its last bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models.builders import (
    regular_tet_grid as jgrid)
from positionbaseddynamics_tpu.models.mesh import TetMesh as JMesh
from positionbaseddynamics_tpu.ops import mathutils as jmu
from positionbaseddynamics_tpu.ops import xpbd as jxpbd
from positionbaseddynamics_tpu.solver.grid_tet import GridTetBatch as JBatch
from positionbaseddynamics_tpu_torch.models.builders import (
    regular_tet_grid as tgrid)
from positionbaseddynamics_tpu_torch.models.mesh import TetMesh as TMesh
from positionbaseddynamics_tpu_torch.ops import mathutils as tmu
from positionbaseddynamics_tpu_torch.ops import xpbd as txpbd
from positionbaseddynamics_tpu_torch.solver.grid_tet import GridTetBatch as TBatch

ATOL = 1e-6
SVD_ATOL = 1e-5
FIELDS = ("inv_rest_odd", "inv_rest_even", "rest_vol_odd", "rest_vol_even",
          "youngs", "poisson", "inv_cnt")
STATIC = ("width", "height", "depth", "offset", "inversion_handling")


def _batches(dims, scale=(2.0, 0.5, 0.5), stiffness=1e4, inversion=False,
             offset=0):
    x0, _ = jgrid(*dims, scale=scale)
    full = np.concatenate([np.zeros((offset, 3), np.float32), x0])
    jb = JBatch.create(*dims, offset, full, stiffness, 0.3,
                       inversion_handling=inversion)
    tb = TBatch.create(*dims, offset, full, stiffness, 0.3,
                       inversion_handling=inversion, device="cpu")
    return jb, tb, full


def _inputs(full, dims, seed, offset=0, sigma=2e-3):
    """Seeded perturbed positions and inverse masses with the i = 0 face
    pinned."""
    rng = np.random.default_rng(seed)
    x = (full + rng.normal(0.0, sigma, full.shape)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (len(full),)).astype(np.float32)
    w[offset:offset + dims[1] * dims[2]] = 0.0
    return x, w


@pytest.mark.parametrize("dims", [(8, 4, 4), (9, 5, 7)])
def test_batch_fields_match_jax(dims):
    jb, tb, _ = _batches(dims)
    for f in FIELDS:
        a, b = getattr(tb, f), np.asarray(getattr(jb, f))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    for f in STATIC:
        assert getattr(tb, f) == getattr(jb, f), f
    assert tuple(tb.init_lambda().shape) == jb.init_lambda().shape


def test_tet_grid_and_mesh_match_jax():
    dims = (7, 4, 5)
    pj, tj = jgrid(*dims, translation=(0.1, 0.2, -0.3), scale=(2.0, 0.6, 0.8))
    pt, tt = tgrid(*dims, translation=(0.1, 0.2, -0.3), scale=(2.0, 0.6, 0.8))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(tt, tj)
    mj, mt = JMesh(len(pj), tj), TMesh(len(pt), tt)
    np.testing.assert_array_equal(mt.edges, mj.edges)
    np.testing.assert_array_equal(mt.surface_faces, mj.surface_faces)


@pytest.mark.parametrize("omega", [1.0, 0.7])
@pytest.mark.parametrize("dims", [(8, 4, 4), (9, 5, 7)])
def test_project_matches_jax(dims, omega):
    jb, tb, full = _batches(dims)
    x, w = _inputs(full, dims, seed=0)
    xj, wj, lj = jnp.asarray(x), jnp.asarray(w), jb.init_lambda()
    xt, wt, lt = torch.from_numpy(x), torch.from_numpy(w), tb.init_lambda()
    for _ in range(3):
        xj, lj = jb.project(xj, wj, lj, 1e-3, omega)
        xt, lt = tb.project(xt, wt, lt, 1e-3, omega)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert np.abs(xt.numpy() - x).max() > 1e-5        # the passes moved x
    pinned = w == 0.0
    np.testing.assert_array_equal(xt.numpy()[pinned], x[pinned])


def test_project_at_offset_leaves_other_particles():
    dims = (6, 4, 5)
    jb, tb, full = _batches(dims, offset=4)
    x, w = _inputs(full, dims, seed=1, offset=4)
    xj, lj = jb.project(jnp.asarray(x), jnp.asarray(w), jb.init_lambda(),
                        1e-3)
    xt, lt = tb.project(torch.from_numpy(x), torch.from_numpy(w),
                        tb.init_lambda(), 1e-3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
    np.testing.assert_array_equal(xt.numpy()[:4], x[:4])


def test_project_gs_matches_jax():
    dims = (7, 4, 5)
    jb, tb, full = _batches(dims)
    x, w = _inputs(full, dims, seed=2)
    xj, wj, lj = jnp.asarray(x), jnp.asarray(w), jb.init_lambda()
    xt, wt, lt = torch.from_numpy(x), torch.from_numpy(w), tb.init_lambda()
    for _ in range(2):
        xj, lj = jb.project_gs(xj, wj, lj, 1e-3)
        xt, lt = tb.project_gs(xt, wt, lt, 1e-3)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert np.abs(xt.numpy() - x).max() > 1e-5


def _inverted(dims):
    """A bar whose last layer of vertices is mirrored through the layer
    before it, so that the last layer of cells is inverted; the rest data
    is that of the undeformed bar."""
    jb, tb, full = _batches(dims, stiffness=1e6, inversion=True)
    w_, h_, d_ = dims
    g = full.reshape(w_, h_, d_, 3).copy()
    g[-1] = 2.0 * g[-2] - g[-1]
    x = g.reshape(-1, 3).astype(np.float32)
    w = np.ones((len(x),), np.float32)
    w[:h_ * d_] = 0.0
    return jb, tb, x, w


def test_inversion_handling_matches_jax_on_inverted_tets():
    dims = (6, 4, 4)
    jb, tb, x, w = _inverted(dims)
    xj, lj = jb.project(jnp.asarray(x), jnp.asarray(w), jb.init_lambda(),
                        1e-3)
    xt, lt = tb.project(torch.from_numpy(x), torch.from_numpy(w),
                        tb.init_lambda(), 1e-3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=SVD_ATOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=SVD_ATOL,
                               rtol=1e-5)
    # the SVD path changes the result where tets are inverted
    _, tb_off, _ = _batches(dims, stiffness=1e6)
    xo, _ = tb_off.project(torch.from_numpy(x), torch.from_numpy(w),
                           tb_off.init_lambda(), 1e-3)
    assert (xo - xt).abs().max().item() > 100 * SVD_ATOL


def test_inversion_handling_is_bitwise_neutral_without_inversions():
    dims = (6, 4, 4)
    _, on, full = _batches(dims, inversion=True)
    _, off, _ = _batches(dims, inversion=False)
    x, w = _inputs(full, dims, seed=3)
    xa, la = on.project(torch.from_numpy(x), torch.from_numpy(w),
                        on.init_lambda(), 1e-3)
    xb, lb = off.project(torch.from_numpy(x), torch.from_numpy(w),
                         off.init_lambda(), 1e-3)
    assert torch.equal(xa, xb) and torch.equal(la, lb)


def test_batched_positions_raise():
    """Fault C-1 repaired: ``project`` and ``project_gs`` take leading
    rollout axes, as JAX's planner ``vmap``s them. K = 3 jittered rollouts
    (inverse masses shared, and per rollout) equal each rollout projected
    alone (≤ 1e-6) and JAX's ``jax.vmap`` of the same call (≤ 1e-5)."""
    import jax

    dims = (5, 3, 3)
    jb, tb, full = _batches(dims)
    rng = np.random.default_rng(11)
    x = np.stack([full + rng.normal(0.0, 2e-3, full.shape)
                  for _ in range(3)]).astype(np.float32)
    _, w = _inputs(full, dims, seed=12)
    lam = np.abs(rng.normal(0.0, 1e-3, (3,) + tuple(tb.init_lambda().shape))
                 ).astype(np.float32)
    for ws in (w, np.stack([w, w[::-1].copy(), w])):
        for name in ("project", "project_gs"):
            extra = (1e-3, 0.9) if name == "project" else (1e-3,)
            xt, lt = getattr(tb, name)(torch.from_numpy(x),
                                       torch.from_numpy(ws),
                                       torch.from_numpy(lam), *extra)
            assert xt.shape == x.shape and lt.shape == lam.shape
            for k in range(3):
                wk = ws if ws.ndim == 1 else ws[k]
                xa, la = getattr(tb, name)(torch.from_numpy(x[k]),
                                           torch.from_numpy(wk),
                                           torch.from_numpy(lam[k]), *extra)
                assert (xt[k] - xa).abs().max().item() <= ATOL
                assert (lt[k] - la).abs().max().item() <= ATOL
            fn = getattr(jb, name)
            wax = None if ws.ndim == 1 else 0
            xj, lj = jax.vmap(lambda xx, ww, ll: fn(xx, ww, ll, *extra),
                              in_axes=(0, wax, 0))(
                jnp.asarray(x), jnp.asarray(ws), jnp.asarray(lam))
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj),
                                       atol=SVD_ATOL)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       atol=SVD_ATOL)


def _mats(seed, n=64, flip=False):
    rng = np.random.default_rng(seed)
    a = (np.eye(3) + 0.3 * rng.normal(size=(n, 3, 3))).astype(np.float32)
    if flip:
        a[:, 0] *= -1.0
    return a


@pytest.mark.parametrize("name", ["mm3", "mm3_tn", "mm3_nt"])
def test_unrolled_products_match_jax(name):
    a, b = _mats(4), _mats(5)
    got = getattr(tmu, name)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(jmu, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tmu.det3(torch.from_numpy(a)).numpy(),
                               np.asarray(jmu.det3(jnp.asarray(a))),
                               atol=ATOL)
    x = np.float32([0.0, 1e-31, -2.0, 4.0])
    np.testing.assert_array_equal(
        tmu.safe_inv(torch.from_numpy(x)).numpy(),
        np.asarray(jmu.safe_inv(jnp.asarray(x))))


@pytest.mark.parametrize("flip", [False, True], ids=["proper", "reflected"])
def test_signed_svd_and_inversion_energy_match_jax(flip):
    import jax

    a = _mats(6, flip=flip)
    u, s, vt = tmu.svd_inversion_handling(torch.from_numpy(a))
    ju, js, jvt = jax.vmap(jmu._svd_inversion_handling_lapack)(
        jnp.asarray(a))
    assert (torch.linalg.det(u) > 0).all() and (torch.linalg.det(vt) > 0).all()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=SVD_ATOL)
    # the factors are unique up to the signs of paired columns; their
    # product is not
    np.testing.assert_allclose((u * s[:, None, :]) @ vt, a, atol=SVD_ATOL)
    if flip:
        assert (s[:, 2] < 0).all()

    # near-rest tets (F close to I), every other one inverted through its
    # base, as a deforming solid presents them
    rng = np.random.default_rng(7)
    rest = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    p = rest[:, None, :] + rng.normal(0.0, 0.05, (4, 64, 3))
    p[3, ::2, 2] *= -1.0
    p = p.astype(np.float32)
    dm = np.stack([rest[i] - rest[3] for i in range(3)], axis=-1)
    irm = np.broadcast_to(np.linalg.inv(dm), (64, 3, 3)).astype(np.float32)
    vol = rng.uniform(0.1, 1.0, 64).astype(np.float32)
    got = txpbd.green_strain_energy_inversion(
        *[torch.from_numpy(q) for q in p], torch.from_numpy(irm),
        torch.from_numpy(vol), 0.4, 0.6)
    want = jax.vmap(jxpbd.green_strain_energy_inversion,
                    in_axes=(0, 0, 0, 0, 0, 0, None, None))(
        *[jnp.asarray(q) for q in p], jnp.asarray(irm), jnp.asarray(vol),
        0.4, 0.6)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=SVD_ATOL,
                                   rtol=1e-5)
