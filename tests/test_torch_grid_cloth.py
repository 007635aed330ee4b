"""The port's structured-grid cloth solver (solver/grid_cloth.py) against
the JAX package's: ``project`` (Jacobi, omega 1.0 and 0.7, λ carried over 3
iterations) and ``project_gs`` on seeded perturbed positions, XPBD and
classic (methods 4/3 and 1/2), on a regular grid and on a jittered grid
whose rest data does not collapse. Tolerance 1e-5: the same float32
stencil arithmetic, summed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models.builders import regular_triangle_grid
from positionbaseddynamics_tpu.solver.grid_cloth import (
    GridClothBatch as JBatch)
from positionbaseddynamics_tpu_torch.solver.grid_cloth import (
    GridClothBatch as TBatch)

ATOL = 1e-5
H, W = 17, 21


def _setup(jitter, xpbd, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x0, _ = regular_triangle_grid(W, H, scale=(2.0, 1.6))
    if jitter:
        x0 = x0 + rng.normal(0.0, 0.01, x0.shape).astype(np.float32)
    kw = dict(distance_stiffness=1e4 if xpbd else 0.8,
              bending_stiffness=0.05 if xpbd else 0.3,
              xpbd_distance=xpbd, xpbd_bending=xpbd)
    jb = JBatch.create(H, W, 0, x0, **kw)
    tb = TBatch.create(H, W, 0, x0, device="cpu", **kw)
    x = (x0 + rng.normal(0.0, 0.02, lead + x0.shape)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, (H * W,)).astype(np.float32)
    inv_mass[[0, W - 1, W * (H // 2)]] = 0.0
    return jb, tb, x, inv_mass


def _cmp_lams(tl, jl):
    for td, jd in zip(tl, jl):
        assert list(td) == list(jd)
        for f in jd:
            np.testing.assert_allclose(td[f].numpy(), np.asarray(jd[f]),
                                       atol=ATOL)


@pytest.mark.parametrize("jitter", [False, True], ids=["regular", "jittered"])
@pytest.mark.parametrize("xpbd", [True, False], ids=["xpbd", "classic"])
@pytest.mark.parametrize("omega", [1.0, 0.7])
def test_project_matches_jax(jitter, xpbd, omega):
    jb, tb, x, inv_mass = _setup(jitter, xpbd)
    if not jitter:
        assert all(np.ndim(r) == 0 for r in jb.rest.values())
        assert all(tb.rest[f].dim() == 0 for f in tb.rest)
    else:
        assert any(tb.rest[f].dim() == 2 for f in tb.rest)
        assert any(tb.q_mat[f].dim() == 3 for f in tb.q_mat)
    xj, wj = jnp.asarray(x), jnp.asarray(inv_mass)
    xt, wt = torch.from_numpy(x), torch.from_numpy(inv_mass)
    lj, lt = jb.init_lambda(), tb.init_lambda()
    for _ in range(3):
        xj, lj = jb.project(xj, wj, lj, 0.001, omega)
        xt, lt = tb.project(xt, wt, lt, 0.001, omega)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
        _cmp_lams(lt, lj)
    assert np.abs(xt.numpy() - x).max() > 1e-4     # the pass did move x
    pinned = inv_mass == 0.0
    np.testing.assert_array_equal(xt.numpy()[pinned], x[pinned])


@pytest.mark.parametrize("jitter", [False, True], ids=["regular", "jittered"])
@pytest.mark.parametrize("xpbd", [True, False], ids=["xpbd", "classic"])
def test_project_gs_matches_jax(jitter, xpbd):
    jb, tb, x, inv_mass = _setup(jitter, xpbd, seed=1)
    xj, wj = jnp.asarray(x), jnp.asarray(inv_mass)
    xt, wt = torch.from_numpy(x), torch.from_numpy(inv_mass)
    lj, lt = jb.init_lambda(), tb.init_lambda()
    for _ in range(2):
        xj, lj = jb.project_gs(xj, wj, lj, 0.001)
        xt, lt = tb.project_gs(xt, wt, lt, 0.001)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
        _cmp_lams(lt, lj)


def test_project_batched_equals_per_rollout():
    """A leading rollout axis broadcasts through every pass; each rollout
    equals its own single-rollout projection."""
    _, tb, x, inv_mass = _setup(False, True, seed=2, lead=(3,))
    wt = torch.from_numpy(inv_mass)
    xb, _ = tb.project(torch.from_numpy(x), wt, tb.init_lambda(), 0.001)
    for r in range(3):
        xr, _ = tb.project(torch.from_numpy(x[r]), wt, tb.init_lambda(),
                           0.001)
        np.testing.assert_allclose(xb[r].numpy(), xr.numpy(), atol=1e-7)


def test_project_at_offset_leaves_other_particles():
    """A cloth at a particle offset updates its own block only."""
    rng = np.random.default_rng(3)
    x0, _ = regular_triangle_grid(W, H)
    pre = rng.normal(size=(5, 3)).astype(np.float32)
    full = np.concatenate([pre, x0]).astype(np.float32)
    kw = dict(distance_stiffness=1e4, bending_stiffness=0.05)
    jb = JBatch.create(H, W, 5, full, **kw)
    tb = TBatch.create(H, W, 5, full, device="cpu", **kw)
    x = (full + rng.normal(0.0, 0.02, full.shape)).astype(np.float32)
    w = np.ones((len(full),), np.float32)
    xj, _ = jb.project(jnp.asarray(x), jnp.asarray(w), jb.init_lambda(), 1e-3)
    xt, _ = tb.project(torch.from_numpy(x), torch.from_numpy(w),
                       tb.init_lambda(), 1e-3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
    np.testing.assert_array_equal(xt.numpy()[:5], x[:5])
