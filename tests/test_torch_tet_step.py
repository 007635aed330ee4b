"""The port's stepper on the tet bar against the JAX package: a 10×6×6
cut of the bench bar (scale 2 × 0.5 × 0.5, the i = 0 face pinned, XPBD FEM
tets at stiffness 1e5, Poisson ratio 0.3), built by each package's
``SceneBuilder``.

The JAX side runs the body of its ``rollout`` — ``_substep`` × substeps,
then ``time += dt`` — with ``_substep`` jitted once for the default
configuration, and eagerly for the variants: XLA's CPU compile of the
multi-iteration and Gauss-Seidel bodies takes minutes.

Tolerances: positions (``x``, ``old_x``, ``last_x``) to 1e-5, the repo's
kernel-against-stencil bar (``bench.py --check``): XLA contracts products
into FMAs where the port rounds each operation, and the stiff bar
amplifies the ulps. A velocity is a position difference over the substep
``h``, so it is held to 2e-5 / h. ``time`` is a float32 sum of ``dt`` on
both sides and must agree to 1e-7.

At ``max_iterations > 1`` the reference's own trajectory breaks down. Its
update ``Δλ = −C(C + αλ)/(Σwᵢ|∇ᵢ|² + C²α)`` with ``C = √(2V₀ψ)`` and
``∇ᵢ`` the energy's gradient is the XPBD multiplier step of ``C`` divided
by ``C``, and λ accumulates it as it is, so from the second iteration on
the ``αλ`` term is ``1/C`` times too large for a tet of small strain. The
bar then jumps by 1e3–1e4 within a few steps (at step 7 at this size with
damping 0.01). Both packages do so alike, at the same step
(``test_multi_iteration_breakdown_is_in_the_reference``); the 5-iteration
case is compared over the 5 steps before it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver.step import _substep as j_substep
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout
from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

DIMS = (10, 6, 6)
POS_ATOL = 1e-5
POS_FIELDS = ("x", "old_x", "last_x")
N_PINNED = DIMS[1] * DIMS[2]


def _scene(builder, dims=DIMS, stiffness=1e5, **build_kw):
    b = builder()
    tm = b.add_regular_tet_model(*dims, scale=(2.0, 0.5, 0.5))
    for j in range(dims[1]):
        for k in range(dims[2]):
            b.set_mass(tm.offset + j * dims[2] + k, 0.0)
    b.add_solid_constraints(tm, method=3, stiffness=stiffness,
                            poisson_ratio=0.3)
    return b.build(**build_kw)


def _jax_steps(substep, state, cfg, n):
    for _ in range(n):
        for _ in range(cfg.substeps):
            state = substep(state)
        state = dataclasses.replace(state, time=state.time + cfg.dt)
    return state


def _jax_substep(cset, cfg, jit):
    def sub(s):
        return j_substep(s, cset, cfg.dt / cfg.substeps, cfg)[0]
    return jax.jit(sub) if jit else sub


@pytest.fixture(scope="module")
def jax_bar():
    """The JAX bar, its state after 10 and 50 steps of the default
    configuration, and its jitted substep (compiled once here)."""
    js, jc = _scene(JBuilder)
    cfg = JConfig()
    sub = _jax_substep(jc, cfg, jit=True)
    s10 = _jax_steps(sub, js, cfg, 10)
    s50 = _jax_steps(sub, s10, cfg, 40)
    return {"state": js, "cset": jc, "sub": sub, 10: s10, 50: s50}


def _assert_states_close(ts, js, h):
    for f in POS_FIELDS + ("x0", "inv_mass"):
        np.testing.assert_allclose(getattr(ts.particles, f).numpy(),
                                   np.asarray(getattr(js.particles, f)),
                                   atol=POS_ATOL, err_msg=f)
    np.testing.assert_allclose(ts.particles.v.numpy(),
                               np.asarray(js.particles.v),
                               atol=2 * POS_ATOL / h, err_msg="v")
    np.testing.assert_allclose(ts.time.numpy(), np.asarray(js.time),
                               atol=1e-7, err_msg="time")


@pytest.mark.parametrize("n_steps", [10, 50])
def test_trajectory_matches_jax(jax_bar, n_steps):
    ts, tc = _scene(TBuilder, device="cpu")
    assert len(tc.grid_tets) == 1 and not tc.grid_cloths
    tfin, traj = trollout(ts, tc, TConfig(), n_steps, collect=True)
    _assert_states_close(tfin, jax_bar[n_steps],
                         TConfig().dt / TConfig().substeps)
    assert traj.shape == (n_steps, ts.particles.n, 3)
    np.testing.assert_array_equal(traj[-1].numpy(), tfin.particles.x.numpy())
    x0, xf = ts.particles.x.numpy(), tfin.particles.x.numpy()
    np.testing.assert_array_equal(xf[:N_PINNED], x0[:N_PINNED])
    np.testing.assert_array_equal(tfin.particles.v.numpy()[:N_PINNED], 0.0)
    assert xf[N_PINNED:, 1].mean() < x0[N_PINNED:, 1].mean() - 1e-3
    assert tfin.time.item() == float(np.asarray(jax_bar[n_steps].time))


@pytest.mark.parametrize("overrides,n_steps", [
    (dict(max_iterations=5, damping=0.01), 5),
    (dict(solver_mode="gauss_seidel"), 1),
    (dict(jacobi_omega=0.8, damping=0.01), 2),
], ids=["iterations5", "gauss_seidel", "omega_damping"])
def test_config_variants_match_jax(overrides, n_steps):
    """JAX runs these eagerly, one operation at a time."""
    js, jc = _scene(JBuilder)
    ts, tc = _scene(TBuilder, device="cpu")
    jcfg, tcfg = JConfig(**overrides), TConfig(**overrides)
    jfin = _jax_steps(_jax_substep(jc, jcfg, jit=False), js, jcfg, n_steps)
    tfin, _ = trollout(ts, tc, tcfg, n_steps)
    _assert_states_close(tfin, jfin, tcfg.dt / tcfg.substeps)
    moved = np.abs(tfin.particles.x.numpy() - ts.particles.x.numpy()).max()
    assert 1e-5 < moved < 0.1           # moving, and not yet diverged


def test_multi_iteration_breakdown_is_in_the_reference():
    """At 5 iterations a soft 6×4×4 bar (stiffness 1e3) leaves its scale in
    the second step, in JAX as in the port: the divergence belongs to the
    reference's λ update (module docstring), not to the port. The first
    step, before it, agrees to the usual bar."""
    cfg_kw = dict(max_iterations=5)
    js, jc = _scene(JBuilder, dims=(6, 4, 4), stiffness=1e3)
    ts, tc = _scene(TBuilder, dims=(6, 4, 4), stiffness=1e3, device="cpu")
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    jsub = _jax_substep(jc, jcfg, jit=False)
    j1 = _jax_steps(jsub, js, jcfg, 1)
    t1, _ = trollout(ts, tc, tcfg, 1)
    _assert_states_close(t1, j1, tcfg.dt / tcfg.substeps)
    j2 = _jax_steps(jsub, j1, jcfg, 1)
    t2, _ = trollout(t1, tc, tcfg, 1)
    x0 = ts.particles.x.numpy()
    for x in (np.asarray(j2.particles.x), t2.particles.x.numpy()):
        assert np.abs(x - x0).max() > 10.0      # a bar of length 2 m
    one, _ = trollout(ts, tc, TConfig(), 2)      # one iteration holds
    assert np.abs(one.particles.x.numpy() - x0).max() < 1e-2


def _to_numpy(state, cset):
    p = state.particles
    arrays = {f: np.asarray(getattr(p, f))
              for f in ("x", "v", "old_x", "last_x", "x0", "inv_mass")}
    arrays["time"] = np.asarray(state.time)
    arrays["overflow"] = np.asarray(state.overflow)
    tets = [{f: np.asarray(getattr(gt, f)) for f in (
        "inv_rest_odd", "inv_rest_even", "rest_vol_odd", "rest_vol_even",
        "youngs", "poisson", "inv_cnt")} for gt in cset.grid_tets]
    meta = [{f: getattr(gt, f) for f in (
        "width", "height", "depth", "offset", "inversion_handling")}
        for gt in cset.grid_tets]
    return arrays, tets, meta


def test_scene_from_numpy_continues_jax_trajectory(jax_bar):
    """The JAX bar after 10 steps, carried across, continues on the port as
    it continues in JAX."""
    jc = jax_bar["cset"]
    assert not jc.particle_batches() and not jc.grid_cloths
    arrays, tets, meta = _to_numpy(jax_bar[10], jc)
    ts, tc = convert.scene_from_numpy(arrays, [], [], device="cpu",
                                      grid_tet_arrays=tets,
                                      grid_tet_meta=meta)
    assert tc.n_particles == np.prod(DIMS) and len(tc.grid_tets) == 1
    tfin, _ = trollout(ts, tc, TConfig(), 40)
    _assert_states_close(tfin, jax_bar[50], TConfig().dt / TConfig().substeps)


def test_make_step_fn_on_cpu_takes_the_stencil_path():
    ts, tc = _scene(TBuilder, device="cpu")
    fn = make_step_fn(tc, TConfig(), device="cpu")
    assert fn.path == "torch_stencil"
    before = gtc.tet_substep_cuda.launches
    out = fn(ts)
    assert torch.isfinite(out.particles.x).all()
    assert gtc.tet_substep_cuda.launches == before


def test_batched_state_raises():
    """Fault C-1 repaired: ``make_step_fn`` on a structured bar steps K =
    3 seeded-jittered rollouts on a leading axis. Each equals itself
    stepped alone (≤ 1e-6) and JAX's ``jax.vmap``-ped jitted step
    (≤ 1e-5), over 5 steps."""
    from positionbaseddynamics_tpu.solver.step import step as jstep

    dims, n_steps = (4, 3, 3), 5
    ts, tc = _scene(TBuilder, dims=dims, device="cpu")
    js, jc = _scene(JBuilder, dims=dims)
    rng = np.random.default_rng(5)
    x = (ts.particles.x.numpy()[None]
         + rng.normal(0.0, 1e-2, (3,) + tuple(ts.particles.x.shape))
         ).astype(np.float32)
    w = ts.particles.inv_mass.numpy()
    x[:, w == 0] = ts.particles.x.numpy()[w == 0]
    p = ts.particles
    batched = dataclasses.replace(ts, particles=dataclasses.replace(
        p, x=torch.from_numpy(x), v=torch.zeros(x.shape),
        old_x=torch.from_numpy(x.copy()), last_x=torch.from_numpy(x.copy())))
    fn = make_step_fn(tc, TConfig(), device="cpu")
    assert fn.path == "torch_stencil"
    out = batched
    for _ in range(n_steps):
        out = fn(out)
    assert tuple(out.particles.x.shape) == x.shape
    for k in range(3):
        alone = dataclasses.replace(ts, particles=dataclasses.replace(
            p, x=torch.from_numpy(x[k]), v=torch.zeros(x.shape[1:]),
            old_x=torch.from_numpy(x[k].copy()),
            last_x=torch.from_numpy(x[k].copy())))
        for _ in range(n_steps):
            alone = fn(alone)
        for f in POS_FIELDS + ("v",):
            d = (getattr(out.particles, f)[k]
                 - getattr(alone.particles, f)).abs().max().item()
            assert d <= 1e-6, (k, f, d)
    jp = js.particles
    jb = dataclasses.replace(js, particles=dataclasses.replace(
        jp, x=jax.numpy.asarray(x), v=jax.numpy.zeros(x.shape),
        old_x=jax.numpy.asarray(x), last_x=jax.numpy.asarray(x),
        x0=jax.numpy.broadcast_to(jp.x0, x.shape),
        inv_mass=jax.numpy.broadcast_to(jp.inv_mass, x.shape[:2])),
        time=jax.numpy.zeros((3,)), overflow=jax.numpy.zeros((3,)))
    jf = jax.jit(jax.vmap(lambda s: jstep(s, jc, JConfig())))
    for _ in range(n_steps):
        jb = jf(jb)
    cfg = TConfig()
    h = cfg.dt / cfg.substeps
    for f in POS_FIELDS:
        np.testing.assert_allclose(getattr(out.particles, f).numpy(),
                                   np.asarray(getattr(jb.particles, f)),
                                   atol=POS_ATOL, err_msg=f)
    np.testing.assert_allclose(out.particles.v.numpy(),
                               np.asarray(jb.particles.v),
                               atol=2 * POS_ATOL / h)


def _tets_of(builder_cls, **kw):
    b = builder_cls(**kw)
    return b, b.add_regular_tet_model(4, 3, 3)


@pytest.mark.parametrize("method", [7])
def test_unported_solid_methods_raise(method):
    b, tm = _tets_of(TBuilder)
    with pytest.raises(NotImplementedError):
        b.add_solid_constraints(tm, method=method)


def _solid_scene(builder, method=3, case="grid", **build_kw):
    """A 4×3×3 tet grid (or one tet of an irregular mesh) under a solid
    method, one corner pinned."""
    if case == "irregular_mesh":
        b = builder()
        tm = b.add_tet_model(np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                                         [0, 0, 1]]), [[0, 1, 2, 3]])
        assert tm.grid is None and len(tm.mesh.edges) == 6
    else:
        b, tm = _tets_of(builder, use_structured_grid=case != "unstructured")
    b.set_mass(0, 0.0)
    stiff = 1e5
    if case == "array_stiffness":
        stiff = np.linspace(1e4, 1e5, len(tm.mesh.tets))
    b.add_solid_constraints(tm, method=method, stiffness=stiff,
                            volume_stiffness=0.7, poisson_ratio=0.25)
    if case == "noncongruent":
        # a grid whose cells differ: the FEM-tet batch, as JAX's fallback
        b._x[0][::3] += 0.05
    return b.build(**build_kw)


@pytest.mark.parametrize("method", [1, 2, 4, 5, 6])
def test_solid_methods_build_batches_as_jax(method):
    """Solid methods 1, 2, 4, 5 and 6 on a regular grid build JAX's
    batches (``tests/test_torch_unstructured_step.py`` steps them)."""
    from test_torch_builders import assert_builds_equal

    names = assert_builds_equal(_solid_scene(TBuilder, method, device="cpu"),
                                _solid_scene(JBuilder, method))
    assert names == {1: ["distance", "volume"], 2: ["fem_tetra"],
                     4: ["strain_tetra"], 5: ["shape_matching"],
                     6: ["distance", "volume"]}[method]


@pytest.mark.parametrize("case", ["irregular_mesh", "unstructured",
                                  "array_stiffness", "noncongruent"])
def test_unstructured_tet_scenes_build_batches_as_jax(case):
    """XPBD FEM tets that the structured solver does not take (an
    irregular mesh, ``use_structured_grid=False``, per-tet stiffness, a
    grid of cells that are not congruent) build JAX's FEM-tet batch."""
    from test_torch_builders import assert_builds_equal

    t = _solid_scene(TBuilder, case=case, device="cpu")
    names = assert_builds_equal(t, _solid_scene(JBuilder, case=case))
    assert names == ["fem_tetra"] and not t[1].grid_tets
    assert t[1].fem_tetra.xpbd
