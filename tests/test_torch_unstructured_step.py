"""The port's unstructured route (the particle batches of
``solver/constraints.py`` through ``solver/step.py``) against the JAX
package's jitted ``rollout``, on the CPU.

Scenes are built by each package's ``SceneBuilder`` from the same
arguments: a 12×12 cloth (scale 2×2, two pinned corners) and a perturbed
irregular cloth mesh under cloth methods 1–4 and bending methods 0–3, a
4×3×3 tet grid and a perturbed tet mesh under solid methods 1–6 (method 3
on a structured grid whose cells are not congruent takes JAX's FEM-tet
fallback), a mixed XPBD/classic scene, and the Jacobi (ω ≠ 1) and
Gauss-Seidel modes.

Tolerances: positions 1e-5 over 10 steps, the repo's kernel-against-
stencil bar (``bench.py --check``); the JAX side is compiled by XLA, which
contracts products into fused multiply-adds where the port rounds each
operation. A velocity is a position difference over the substep ``h``,
held to 2 × the position bar / h. Classic (non-XPBD) stiffnesses are in
[0, 1], as the reference's PBD constraints take them.

Two bending families of a flat cloth are not defined to 1e-5 in float32
by the reference itself (``test_flat_cloth_bending_spread_is_the_
references_own``): dihedral bending takes ``arccos`` of a normal product
within 1e-6 of 1, and classic isometric bending computes ``Q x`` over
absolute positions, terms of ~1e2 cancelling to a gradient of ~1e-2. JAX's
own jitted and eager rollouts part by 1.9e-5 and 6.4e-4 within 5 steps;
their bars are 1e-4 (dihedral) and 5e-3 (classic isometric), and a scene
holding either takes its bar (ROADMAP §C).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver import rollout as jrollout
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout

POS_ATOL = 1e-5
N_STEPS = 10
N = 12
CLOTH_STIFF = {1: 1.0, 2: 1.0, 3: 1.0, 4: 1e5}    # by cloth method
BEND_STIFF = {1: 0.5, 2: 0.5, 3: 0.05}            # by bending method
BEND_ATOL = {0: POS_ATOL, 1: 1e-4, 2: 5e-3, 3: POS_ATOL}


def _irregular_cloth(seed=0, n=10):
    """A 10×10 grid's triangles over jittered points, the vertices
    numbered in a random order: an irregular mesh for ``add_triangle_
    model``."""
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_triangle_grid)
    rng = np.random.default_rng(seed)
    pts, faces = regular_triangle_grid(n, n, scale=(1.5, 1.5))
    pts = pts + rng.uniform(-0.03, 0.03, pts.shape).astype(np.float32)
    pts[:, 2] = 0.02 * rng.normal(size=len(pts))
    perm = rng.permutation(len(pts))
    inv = np.argsort(perm)
    return pts[perm], inv[faces].astype(np.int32), inv[[0, n - 1]]


def _cloth(builder, method, bend, mesh="grid", **build_kw):
    b = builder(use_structured_grid=False)
    if mesh == "grid":
        tm = b.add_regular_triangle_model(N, N, scale=(2.0, 2.0))
        pins = [tm.offset, tm.offset + N - 1]
    else:
        pts, faces, pins = _irregular_cloth()
        tm = b.add_triangle_model(pts, faces)
    for p in pins:
        b.set_mass(int(p), 0.0)
    b.add_cloth_constraints(tm, method=method,
                            distance_stiffness=CLOTH_STIFF[method])
    if bend:
        b.add_bending_constraints(tm, method=bend, stiffness=BEND_STIFF[bend])
    return b.build(**build_kw)


TET_DIMS = (4, 3, 3)


def _solid(builder, method, mesh="grid", **build_kw):
    """A 4×3×3 tet bar (scale 1 × 0.5 × 0.5), the i = 0 face pinned; on
    ``"perturbed"`` the same tets over jittered points (``add_tet_model``);
    on ``"noncongruent"`` a structured grid whose cells differ, which
    JAX's builder hands to the FEM-tet batch.

    Shape matching (method 5) pins one corner only: a cluster with two
    pinned members (mass ``1/(w + ε)``, 1e6 each) has an ``A_pq`` of
    condition ~1e6, and the reference's polar iteration turns its rounding
    into a different rotation (ROADMAP §C)."""
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_tet_grid)
    w, h, d = TET_DIMS
    b = builder(use_structured_grid=mesh == "noncongruent")
    if mesh == "perturbed":
        pts, tets = regular_tet_grid(w, h, d, scale=(1.0, 0.5, 0.5))
        rng = np.random.default_rng(1)
        pts = pts + rng.uniform(-0.02, 0.02, pts.shape).astype(np.float32)
        tm = b.add_tet_model(pts, tets)
    else:
        tm = b.add_regular_tet_model(w, h, d, scale=(1.0, 0.5, 0.5))
        if mesh == "noncongruent":
            b._x[0][::3] += 0.03
    for k in range(1 if method == 5 else h * d):
        b.set_mass(tm.offset + k, 0.0)
    xpbd = method in (3, 6)
    b.add_solid_constraints(tm, method=method,
                            stiffness=1e4 if xpbd else 0.8,
                            poisson_ratio=0.3,
                            volume_stiffness=1e4 if xpbd else 0.8)
    return b.build(**build_kw)


def _jax_rollout(state, cset, cfg, n):
    fin, _ = jax.jit(lambda s: jrollout(s, cset, cfg, n))(state)
    return fin


def _assert_states_close(ts, js, h, atol=POS_ATOL):
    for f in ("x", "old_x", "last_x", "x0", "inv_mass"):
        np.testing.assert_allclose(getattr(ts.particles, f).numpy(),
                                   np.asarray(getattr(js.particles, f)),
                                   atol=atol, rtol=0, err_msg=f)
    np.testing.assert_allclose(ts.particles.v.numpy(),
                               np.asarray(js.particles.v),
                               atol=2 * atol / h, rtol=0, err_msg="v")
    np.testing.assert_allclose(ts.time.numpy(), np.asarray(js.time),
                               atol=1e-7, err_msg="time")


def _compare(scene, overrides=None, n_steps=N_STEPS, atol=POS_ATOL, **kw):
    """Build with both packages, run ``n_steps`` on each, compare to
    ``atol``; returns the port's start and end states."""
    js, jc = scene(JBuilder, **kw)
    ts, tc = scene(TBuilder, device="cpu", **kw)
    assert [n for n, _ in tc.particle_batches()] == \
        [n for n, _ in jc.particle_batches()]
    assert not tc.grid_cloths and not tc.grid_tets
    jcfg, tcfg = JConfig(**(overrides or {})), TConfig(**(overrides or {}))
    assert make_step_fn(tc, tcfg, device="cpu").path == "torch_unstructured"
    jfin = _jax_rollout(js, jc, jcfg, n_steps)
    tfin, _ = trollout(ts, tc, tcfg, n_steps)
    _assert_states_close(tfin, jfin, tcfg.dt / tcfg.substeps, atol)
    x0, xf = ts.particles.x.numpy(), tfin.particles.x.numpy()
    pinned = ts.particles.inv_mass.numpy() == 0.0
    np.testing.assert_array_equal(xf[pinned], x0[pinned])
    assert np.abs(xf - x0).max() > 1e-3          # the scene moved
    return ts, tfin


@pytest.mark.parametrize("method", [1, 2, 3, 4])
@pytest.mark.parametrize("bend", [0, 1, 2, 3])
def test_cloth_methods_on_a_grid_match_jax(method, bend):
    _compare(_cloth, method=method, bend=bend, atol=BEND_ATOL[bend])


@pytest.mark.parametrize("method,bend", [(1, 3), (2, 2), (3, 1), (4, 0)])
def test_cloth_methods_on_an_irregular_mesh_match_jax(method, bend):
    _compare(_cloth, method=method, bend=bend, mesh="irregular",
             atol=BEND_ATOL[bend])


@pytest.mark.parametrize("method", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("mesh", ["grid", "perturbed"])
def test_solid_methods_match_jax(method, mesh):
    _compare(_solid, method=method, mesh=mesh)


def test_rollout_above_the_planned_scatter_size_matches_jax():
    """A 48×48 cloth: 6,721 distance and 6,533 bending rows, 13,442 and
    26,132 scattered entries, above the 8,192 at which JAX's jitted step
    takes its planned (sorted prefix-sum) scatter, which rounds its sums
    otherwise than ``index_add_``'s row order; the 1e-5 bar holds."""
    def scene(builder, **kw):
        b = builder(use_structured_grid=False)
        tm = b.add_regular_triangle_model(48, 48, scale=(2.0, 2.0))
        b.set_mass(tm.offset, 0.0)
        b.set_mass(tm.offset + 47, 0.0)
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        b.add_bending_constraints(tm, method=3, stiffness=0.05)
        return b.build(**kw)

    _, tc = scene(TBuilder, device="cpu")
    assert tc.distance.idx.numel() >= 8192
    assert tc.isometric_bending.idx.numel() >= 8192
    _compare(scene)


def test_noncongruent_grid_takes_the_fem_tet_fallback_as_jax():
    _, tc = _solid(TBuilder, 3, mesh="noncongruent", device="cpu")
    assert tc.fem_tetra is not None and tc.fem_tetra.xpbd
    _compare(_solid, method=3, mesh="noncongruent")


@pytest.mark.parametrize("scene,kw,overrides", [
    (_cloth, dict(method=4, bend=3), dict(jacobi_omega=0.7)),
    (_solid, dict(method=6), dict(jacobi_omega=0.7)),
    (_cloth, dict(method=4, bend=3), dict(solver_mode="gauss_seidel")),
    (_cloth, dict(method=4, bend=3), dict(max_iterations=2, damping=0.01)),
    (_solid, dict(method=6), dict(max_iterations=2, damping=0.01)),
], ids=["omega-cloth", "omega-solid", "gauss_seidel-cloth",
        "iterations2_damping-cloth", "iterations2_damping-solid"])
def test_solver_modes_match_jax(scene, kw, overrides):
    _compare(scene, overrides, n_steps=5, **kw)


def _mixed(builder, **build_kw):
    """XPBD and classic distance and volume constraints on one tet model,
    a shape-matching cluster, per-constraint adders of every family, and a
    cloth under strain triangles of two flag sets."""
    b = builder(use_structured_grid=False)
    tm = b.add_regular_tet_model(3, 3, 2, scale=(1.0, 1.0, 0.5))
    b.add_solid_constraints(tm, method=6, stiffness=1e4,
                            volume_stiffness=1e4)
    b.add_solid_constraints(tm, method=1, stiffness=0.5,
                            volume_stiffness=0.5)
    b.add_shape_matching_constraint([0, 1, 4, 9], stiffness=0.5)
    b.add_fem_tet_constraint(1, 2, 5, 10, youngs=1e4, xpbd=True)
    b.add_fem_tet_constraint(3, 4, 7, 13, youngs=0.5)
    b.add_strain_tet_constraint(0, 3, 4, 9, stretch_stiffness=0.5)
    b.add_distance_constraint(2, 17, stiffness=0.5)
    cm = b.add_regular_triangle_model(4, 3, translation=(0, 2, 0))
    o = cm.offset
    b.add_cloth_constraints(cm, method=3)
    b.add_strain_triangle_constraint(o, o + 1, o + 4, normalize_stretch=True)
    b.add_fem_triangle_constraint(o + 5, o + 6, o + 9)
    b.add_isometric_bending_constraint(o + 1, o + 4, o + 0, o + 5,
                                       stiffness=0.3, xpbd=True)
    b.add_isometric_bending_constraint(o + 6, o + 9, o + 5, o + 10,
                                       stiffness=0.3)
    b.add_dihedral_constraint(o + 2, o + 5, o + 1, o + 6, stiffness=0.3)
    b.add_volume_constraint(0, 1, 3, 9, stiffness=1e4, xpbd=True)
    b.set_mass(0, 0.0)
    b.set_mass(o, 0.0)
    return b.build(**build_kw)


def test_mixed_xpbd_and_classic_scene_matches_jax():
    ts, _ = _mixed(TBuilder, device="cpu")
    _, tc = _mixed(TBuilder, device="cpu")
    names = [n for n, _ in tc.particle_batches()]
    assert names[:7] == ["distance", "fem_triangle", "strain_triangle",
                         "fem_tetra", "strain_tetra", "volume",
                         "shape_matching"]
    assert "dihedral" in names and "isometric_bending" in names
    assert len(tc.extra_batches) == 5
    _compare(_mixed, atol=BEND_ATOL[2])


def _eager_jax(state, cset, cfg, n):
    """JAX's step body op by op, no XLA fusion."""
    from positionbaseddynamics_tpu.solver.step import _substep

    for _ in range(n):
        for _ in range(cfg.substeps):
            state = _substep(state, cset, cfg.dt / cfg.substeps, cfg)[0]
        state = dataclasses.replace(state, time=state.time + cfg.dt)
    return state


@pytest.mark.parametrize("bend,floor", [(1, 1e-5), (2, 1e-4)])
def test_flat_cloth_bending_spread_is_the_references_own(bend, floor):
    """The probe behind ``BEND_ATOL``: on the flat 12×12 cloth, JAX's own
    jitted and eager rollouts part by more than 1e-5 (dihedral) and 1e-4
    (classic isometric) within 5 steps, and the port stays within 3× of
    that spread of the jitted one."""
    js, jc = _cloth(JBuilder, 4, bend)
    ts, tc = _cloth(TBuilder, 4, bend, device="cpu")
    jit = np.asarray(_jax_rollout(js, jc, JConfig(), 5).particles.x)
    eager = np.asarray(_eager_jax(js, jc, JConfig(), 5).particles.x)
    port = trollout(ts, tc, TConfig(), 5)[0].particles.x.numpy()
    spread = np.abs(jit - eager).max()
    print(f"bending {bend}: JAX jit vs eager {spread!r}, port vs jit "
          f"{np.abs(port - jit).max()!r}")
    assert spread > floor
    assert np.abs(port - jit).max() <= 3.0 * spread


def test_k_rollouts_equal_each_rollout_alone():
    """A ``(K, N, 3)`` state steps each rollout exactly as alone, with the
    inverse masses shared ``(N,)``; Gauss-Seidel and Jacobi."""
    ts, tc = _solid(TBuilder, 6, device="cpu")
    p = ts.particles
    rng = np.random.default_rng(0)
    kicks = torch.from_numpy(
        rng.normal(0.0, 0.2, (3,) + tuple(p.v.shape)).astype(np.float32))
    kicks[:, p.inv_mass == 0] = 0.0
    for mode in ("jacobi", "gauss_seidel"):
        cfg = TConfig(solver_mode=mode)
        singles = [dataclasses.replace(ts, particles=dataclasses.replace(
            p, v=p.v + kicks[r])) for r in range(3)]
        batched = dataclasses.replace(ts, particles=dataclasses.replace(
            p, **{f: torch.stack([getattr(s.particles, f) for s in singles])
                  for f in ("x", "v", "old_x", "last_x", "x0")}))
        fn = make_step_fn(tc, cfg, device="cpu")
        for _ in range(3):
            batched = fn(batched)
            singles = [fn(s) for s in singles]
        for r, s in enumerate(singles):
            for f in ("x", "v", "old_x", "last_x"):
                np.testing.assert_array_equal(
                    getattr(batched.particles, f)[r].numpy(),
                    getattr(s.particles, f).numpy(), err_msg=(mode, f))


def test_unstructured_cloth_matches_the_grid_route():
    """The port's two routes of one cloth: JAX's own bar between them
    (``tests/test_grid_cloth.py``: 2e-4 over 30 steps)."""
    def grid(builder, structured, **kw):
        b = builder(use_structured_grid=structured)
        tm = b.add_regular_triangle_model(N, N, scale=(2.0, 2.0))
        b.set_mass(tm.offset, 0.0)
        b.set_mass(tm.offset + N - 1, 0.0)
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        b.add_bending_constraints(tm, method=3, stiffness=0.05)
        return b.build(**kw)

    ss, sc = grid(TBuilder, True, device="cpu")
    us, uc = grid(TBuilder, False, device="cpu")
    assert make_step_fn(sc, TConfig(), device="cpu").path == "torch_stencil"
    assert make_step_fn(uc, TConfig(), device="cpu").path == \
        "torch_unstructured"
    sf, _ = trollout(ss, sc, TConfig(), 30)
    uf, _ = trollout(us, uc, TConfig(), 30)
    np.testing.assert_allclose(uf.particles.x.numpy(),
                               sf.particles.x.numpy(), atol=2e-4, rtol=0)


def test_grid_cloth_with_an_extra_batch_matches_jax():
    """A structured cloth plus a distance constraint on its own particles:
    the grid families, then the particle batch, as JAX's step orders
    them; no route takes only the grid."""
    def scene(builder, **kw):
        b = builder()
        tm = b.add_regular_triangle_model(N, N, scale=(2.0, 2.0))
        b.set_mass(tm.offset, 0.0)
        b.set_mass(tm.offset + N - 1, 0.0)
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        b.add_bending_constraints(tm, method=3, stiffness=0.05)
        b.add_distance_constraint(N * (N - 1), N * N - 1, stiffness=1e3,
                                  xpbd=True)
        return b.build(**kw)

    js, jc = scene(JBuilder)
    ts, tc = scene(TBuilder, device="cpu")
    assert len(tc.grid_cloths) == 1 and tc.distance is not None
    assert make_step_fn(tc, TConfig(), device="cpu").path == \
        "torch_unstructured"
    jfin = _jax_rollout(js, jc, JConfig(), N_STEPS)
    tfin, _ = trollout(ts, tc, TConfig(), N_STEPS)
    _assert_states_close(tfin, jfin, TConfig().dt / TConfig().substeps)


def _batches_to_numpy(cset):
    out = {}
    for name, b in cset.particle_batches():
        arrays, statics = {}, {}
        for f in dataclasses.fields(b):
            v = getattr(b, f.name)
            if f.metadata.get("static"):
                statics[f.name] = v
            else:
                arrays[f.name] = np.asarray(v)
        out[name] = (type(b).__name__, arrays, statics)
    return out


def test_scene_from_numpy_continues_a_jax_trajectory():
    """A JAX scene of particle batches (XPBD distance and isometric
    bending, and a classic distance constraint, on the irregular cloth),
    stepped 3 times in JAX and carried across, continues on the port as
    in JAX."""
    def scene(builder, **kw):
        b = builder(use_structured_grid=False)
        pts, faces, pins = _irregular_cloth()
        tm = b.add_triangle_model(pts, faces)
        for p in pins:
            b.set_mass(int(p), 0.0)
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        b.add_bending_constraints(tm, method=3, stiffness=0.05)
        b.add_distance_constraint(3, 40, stiffness=0.5)
        return b.build(**kw)

    js, jc = scene(JBuilder)
    jstep = jax.jit(lambda s: jrollout(s, jc, JConfig(), 1)[0])
    for _ in range(3):
        js = jstep(js)
    p = js.particles
    arrays = {f: np.asarray(getattr(p, f))
              for f in ("x", "v", "old_x", "last_x", "x0", "inv_mass")}
    arrays["time"] = np.asarray(js.time)
    ts, tc = convert.scene_from_numpy(
        arrays, [], [], device="cpu",
        particle_batches=_batches_to_numpy(jc))
    assert [n for n, _ in tc.particle_batches()] == [
        "distance", "isometric_bending", "extra0"]
    for key, v in jc.jacobi_inv_counts.items():
        np.testing.assert_array_equal(tc.jacobi_inv_counts[key].numpy(),
                                      np.asarray(v))
    for _ in range(10):
        js = jstep(js)
    tfin, _ = trollout(ts, tc, TConfig(), 10)
    _assert_states_close(tfin, js, TConfig().dt / TConfig().substeps)
    with pytest.raises(ValueError):
        convert.scene_from_numpy(arrays, [], [], device="cpu",
                                 particle_batches={"distance": (
                                     "GridClothBatch", {}, {})})
