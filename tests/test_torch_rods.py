"""The port's rod ops and batches (``ops/rods.py``, ``ops/ghost_rods.py``,
the five rod batches of ``solver/constraints.py``, ``solver/grid_rods.py``)
against the JAX package's, on the CPU, on seeded numpy inputs.

Tolerances: the ops and the batches' ``solve`` 1e-6 (a few float32 ulps:
both packages run the same float32 operations, XLA's CPU reductions and
matrix products in their own order); the 5-point Darboux Jacobian 1e-5
against ``jax.jacfwd`` (a chain of three normalisations and cross
products, forward-mode in both). The batches' build fields are computed
in numpy by both and must be equal, the ghost rod's rest Darboux vectors
(float32 in both) to 1e-6. The rod lattice's ``project`` is held to
JAX's lattice at 1e-6 and to the port's unstructured batches at 2e-5,
JAX's own bar between its two paths (``tests/test_grid_rods.py:38-42``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rod_scenes as scenes
from positionbaseddynamics_tpu.ops import ghost_rods as jg
from positionbaseddynamics_tpu.ops import rods as jr
from positionbaseddynamics_tpu.solver.step import (
    _project_rod_batches as j_project_rods)
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu_torch.ops import ghost_rods as tg
from positionbaseddynamics_tpu_torch.ops import rods as tr
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver.step import (
    _project_rod_batches as t_project_rods)

ATOL = 1e-6
JAC_ATOL = 1e-5
C = 64


def _unit(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _diff(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


def _element(rng, c=C):
    """Seeded rod elements near ``test_ghost_rods.py``'s (points p0, p1, p2
    and ghosts g0, g1) and per-element weights."""
    base = np.array([[0, 0, 0], [1, 0.1, 0], [2, 0, 0.2], [0.5, 0.3, 0],
                     [1.5, 0.31, 0.05]], np.float64)
    pts = [(b + 0.05 * rng.normal(size=(c, 3))).astype(np.float32)
           for b in base]
    ws = [rng.uniform(0.0, 2.0, c).astype(np.float32) for _ in range(5)]
    return pts, ws


def test_cosserat_ops_match_jax():
    rng = np.random.default_rng(0)
    p0, p1 = (rng.normal(size=(C, 3)).astype(np.float32) for _ in range(2))
    w0, w1, wq0, wq1 = (rng.uniform(0.0, 2.0, C).astype(np.float32)
                        for _ in range(4))
    q0, q1, rest = _unit(rng, C), _unit(rng, C), _unit(rng, C)
    ks = rng.uniform(0.1, 1.0, (C, 3)).astype(np.float32)
    length = rng.uniform(0.2, 1.0, C).astype(np.float32)
    cases = [
        (jr.solve_stretch_shear, tr.solve_stretch_shear,
         (p0, w0, p1, w1, q0, wq0, ks, length)),
        (jr.solve_bend_twist, tr.solve_bend_twist,
         (q0, wq0, q1, wq1, ks, rest)),
        (jr.rest_darboux, tr.rest_darboux, (q0, q1))]
    for jf, tf, args in cases:
        want = jax.vmap(jf)(*map(jnp.asarray, args))
        got = tf(*map(torch.from_numpy, args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, want):
            assert _diff(a, b) <= ATOL, jf.__name__


def test_bend_twist_double_cover_pick_and_rest_zero():
    """``−q1`` is the same rotation as ``q1``: the double-cover pick gives
    the same zero correction at rest (``test_rods_e2e.py``)."""
    rng = np.random.default_rng(1)
    q0, q1 = _unit(rng, 8), _unit(rng, 8)
    rest = tr.rest_darboux(torch.from_numpy(q0), torch.from_numpy(q1))
    one = torch.ones(8)
    for sign in (1.0, -1.0):
        c0, c1 = tr.solve_bend_twist(torch.from_numpy(q0), one,
                                     sign * torch.from_numpy(q1), one,
                                     torch.ones(8, 3), rest)
        assert c0.abs().max().item() <= 1e-5
        assert c1.abs().max().item() <= 1e-5


@pytest.mark.parametrize("name", [
    "material_frame", "darboux_vector", "element_darboux",
    "solve_perpendicular_bisector", "solve_ghost_edge_distance",
    "solve_darboux_vector"])
def test_ghost_ops_match_jax(name):
    rng = np.random.default_rng(2)
    pts, ws = _element(rng)
    ml = rng.uniform(0.8, 1.2, C).astype(np.float32)
    ks = rng.uniform(0.1, 1.0, (C, 3)).astype(np.float32)
    k = rng.uniform(0.5, 1.0, C).astype(np.float32)
    if name == "material_frame":
        args = pts[:3]
    elif name == "darboux_vector":
        fa = np.asarray(jax.vmap(jg.material_frame)(pts[0], pts[1], pts[3]))
        fb = np.asarray(jax.vmap(jg.material_frame)(pts[1], pts[2], pts[4]))
        args = [fa, fb, ml]
    elif name == "element_darboux":
        args = pts + [ml]
    elif name == "solve_perpendicular_bisector":
        args = [pts[0], ws[0], pts[1], ws[1], pts[3], ws[2], k]
    elif name == "solve_ghost_edge_distance":
        args = [pts[0], ws[0], pts[1], ws[1], pts[3], ws[2], k,
                np.full(C, 0.3, np.float32)]
    else:
        rest = (np.asarray(jax.vmap(jg.element_darboux)(*pts, ml))
                + 0.05 * rng.normal(size=(C, 3))).astype(np.float32)
        args = [a for pw in zip(pts, ws) for a in pw] + [ks, ml, rest]
    want = jax.vmap(getattr(jg, name))(*map(jnp.asarray, args))
    got = getattr(tg, name)(*map(torch.from_numpy, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _diff(a, b) <= ATOL


def test_darboux_jacobian_matches_jax_jacfwd():
    """``torch.func.jacfwd`` under ``vmap`` against ``jax.jacfwd``, all five
    3×3 blocks, on K = 2 rollouts of C elements (leading axes)."""
    rng = np.random.default_rng(3)
    pts, _ = _element(rng, 2 * C)
    ml = np.ones(2 * C, np.float32)
    want = jax.vmap(jax.jacfwd(jg.element_darboux, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, pts + [ml]))
    got = tg.darboux_jacobians(
        *(torch.from_numpy(p).reshape(2, C, 3) for p in pts),
        torch.from_numpy(ml).reshape(2, C))
    for a, b in zip(got, want):
        assert a.shape == (2, C, 3, 3) and a.dtype == torch.float32
        assert _diff(a.reshape(-1, 3, 3), b) <= JAC_ATOL


def _perturbed(ts, rng, dx=0.02, dq=0.05):
    """Seeded positions and quaternions near the build state, float32."""
    x = (ts.particles.x.numpy() + dx * rng.normal(
        size=tuple(ts.particles.x.shape))).astype(np.float32)
    q = None
    if ts.orientations is not None:
        q = ts.orientations.q.numpy() + dq * rng.normal(
            size=tuple(ts.orientations.q.shape))
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
            np.float32)
    return x, q


ROD_BATCHES = ("stretch_shear", "bend_twist", "perpendicular_bisector",
               "ghost_edge", "darboux_vector")


@pytest.mark.parametrize("name", ROD_BATCHES)
def test_rod_batch_solve_matches_jax(name):
    """Each batch built by both builders (the helix for the Cosserat
    batches, the ghost rod for the others): equal fields, then ``solve``
    on seeded perturbed states, ≤ 1e-6."""
    scene = scenes.helix if name in ("stretch_shear", "bend_twist") \
        else scenes.ghost_rod
    js, jc = scene("jax")
    ts, tc = scene("torch")
    jb, tb = getattr(jc, name), getattr(tc, name)
    for f in dataclasses.fields(jb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if f.metadata.get("static"):
            assert a == b, f.name
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       rtol=0, err_msg=f.name)
    rng = np.random.default_rng(4)
    x, q = _perturbed(ts, rng)
    w = ts.particles.inv_mass.numpy()
    if name == "stretch_shear":
        wq = ts.orientations.inv_mass.numpy()
        want = jb.solve(jnp.asarray(x), jnp.asarray(w), jnp.asarray(q),
                        jnp.asarray(wq))
        got = tb.solve(*map(torch.from_numpy, (x, w, q, wq)))
    elif name == "bend_twist":
        wq = ts.orientations.inv_mass.numpy()
        want = (jb.solve(jnp.asarray(q), jnp.asarray(wq)),)
        got = (tb.solve(torch.from_numpy(q), torch.from_numpy(wq)),)
    else:
        want = jb.solve(jnp.asarray(x), jnp.asarray(w), jb.init_lambda(),
                        1e-3)[:1]
        got = tb.solve(torch.from_numpy(x), torch.from_numpy(w),
                       tb.init_lambda(), 1e-3)[:1]
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert _diff(a, b) <= ATOL


def _lattice_inputs(ts, seed):
    x, q = _perturbed(ts, np.random.default_rng(seed))
    return (x, ts.particles.inv_mass.numpy(), q,
            ts.orientations.inv_mass.numpy())


@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_lattice_project_matches_jax_and_the_batches(omega):
    """One lattice pass from seeded perturbed states equals JAX's lattice
    (≤ 1e-6) and the port's unstructured stretch-shear and bend-twist
    pass (``_project_rod_batches`` of the same rods built with
    ``use_structured_grid=False``, ≤ 2e-5); K = 2 rollouts on a leading
    axis equal each alone (≤ 1e-6)."""
    js, jc = scenes.rods("jax")
    ts, tc = scenes.rods("torch")
    _, tu = scenes.rods("torch", structured=False)
    assert jc.rod_lattices and tc.rod_lattices and tu.stretch_shear
    jl, tl = jc.rod_lattices[0], tc.rod_lattices[0]
    for f in dataclasses.fields(jl):
        a, b = getattr(tl, f.name), getattr(jl, f.name)
        if f.metadata.get("static"):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x, w, q, wq = _lattice_inputs(ts, 5)
    xj, qj = jl.project(*map(jnp.asarray, (x, w, q, wq)), omega)
    xt, qt = tl.project(*map(torch.from_numpy, (x, w, q, wq)), omega)
    assert _diff(xt, xj) <= ATOL and _diff(qt, qj) <= ATOL
    cfg = TConfig(jacobi_omega=omega)
    xu, qu = t_project_rods(*map(torch.from_numpy, (x, w, q, wq)), tu, cfg)
    assert (xu - xt).abs().max().item() <= 2e-5
    assert (qu - qt).abs().max().item() <= 2e-5
    x2, _, q2, _ = _lattice_inputs(ts, 6)
    xb, qb = tl.project(torch.from_numpy(np.stack([x, x2])),
                        torch.from_numpy(w),
                        torch.from_numpy(np.stack([q, q2])),
                        torch.from_numpy(wq), omega)
    xa, qa = tl.project(*map(torch.from_numpy, (x2, w, q2, wq)), omega)
    assert (xb[0] - xt).abs().max().item() <= ATOL
    assert (xb[1] - xa).abs().max().item() <= ATOL
    assert (qb[1] - qa).abs().max().item() <= ATOL


@pytest.mark.parametrize("mode", ["jacobi", "gauss_seidel"])
def test_unstructured_rod_pass_matches_jax(mode):
    """``_project_rod_batches`` on the helix's stretch-shear and
    bend-twist batches in both solver modes, ≤ 1e-6."""
    js, jc = scenes.helix("jax")
    ts, tc = scenes.helix("torch")
    x, q = _perturbed(ts, np.random.default_rng(7))
    w = ts.particles.inv_mass.numpy()
    wq = ts.orientations.inv_mass.numpy()
    xj, qj = j_project_rods(*map(jnp.asarray, (x, w, q, wq)), jc,
                            JConfig(solver_mode=mode))
    xt, qt = t_project_rods(*map(torch.from_numpy, (x, w, q, wq)), tc,
                            TConfig(solver_mode=mode))
    assert _diff(xt, xj) <= ATOL and _diff(qt, qj) <= ATOL


def test_lattice_refuses_gauss_seidel():
    """The lattice has Jacobi semantics only and refuses ``gauss_seidel``
    with JAX's message (``step.py:185-192``)."""
    ts, tc = scenes.rods("torch", n_rods=2, n=6)
    fn = make_step_fn(tc, TConfig(solver_mode="gauss_seidel"),
                      device="cpu")
    with pytest.raises(ValueError, match="rod-lattice fast path has no "
                                         "gauss_seidel mode"):
        fn(ts)
