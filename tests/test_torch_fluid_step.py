"""The port's fluid model and stepper (fluids/model.py, convert.py) against
the JAX package on the same dams, on the CPU, where the cell route runs
the plain versions of the PBF kernels.

Tolerances are the JAX package's own: the cell route within 1e-4 max|Δx|
over 10 steps, the bar of ``test_classgrid_matches_cellgrid`` (float32
sums in another order, amplified by the projection), against JAX's
default step (the occupancy classes) and against its unpartitioned cell
step; the hash route within 5e-4, the bar of
``test_cellgrid_path_matches_hash_path``; ``dt`` and ``time`` within
1e-6 relative after the first step. Later, ``dt = 0.4·diam/max‖v‖``
follows the fastest particle, and ``v = (x − old_x)/h`` with h ≈ 3e-4,
so a spread δ of the positions moves ``dt`` by up to δ/(h·max‖v‖)
relative: ~1e-3 at δ = 1e-5 and max‖v‖ ≈ 30 m/s. JAX's own two cell
routes (classes and unpartitioned) differ by 3.6e-6 relative in ``dt``
over these 10 steps on the 8×8×6 dam
(``scripts/fluid_reference_probe.py``) and the port by 1.8e-5, so ``dt``
and ``time`` are held within 1e-4 at step 10. The scene's masses exactly
and its ψ within 1e-5 relative (a float32 sum over each boundary
particle's neighbors)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.fluids import model as jm
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.fluids import model as tm

R = 0.025
D = 2 * R
DAMS = {
    # name: (block, domain hi) of the JAX package's fluid tests
    "6x8x6": ((6, 8, 6), (8 * D * 3, 10 * D, 8 * D)),
    "8x8x6": ((8, 8, 6), (10 * D * 3, 10 * D * 2, 8 * D)),
    "12x10x8": ((12, 10, 8), (1.4, 1.1, 0.5)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for these tests: the plain passes are large
    elementwise ops, and under the suite's parallel workers each process's
    thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name):
    block, hi = DAMS[name]
    fluid = tm.block_positions((D, D, D), block, D)
    return fluid, tm.box_boundary((0.0, 0.0, 0.0), hi, D), ((0, 0, 0), hi)


def scene_numpy(scene):
    """A JAX FluidScene as the mapping ``convert.fluid_scene_from_numpy``
    reads."""
    out = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    for k in ("mass", "boundary_x", "boundary_psi"):
        out[k] = np.asarray(out[k])
    g = scene.cellgrid
    if g is not None:
        b = g.boundary
        out["cellgrid"] = dict(
            origin=g.origin, dims=g.dims, cell=g.cell, cap=g.cap,
            max_active=g.max_active, boundary=None if b is None else dict(
                xt=[np.asarray(p) for p in b.xt], psit=np.asarray(b.psit),
                capb=b.capb, near=np.asarray(b.near),
                near_frac=b.near_frac))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", ["6x8x6", "12x10x8"])
def test_fluid_scene_create_matches_jax(name):
    fluid, bnd, domain = _inputs(name)
    js = jm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain)
    ts = tm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain, device="cpu")
    np.testing.assert_array_equal(ts.mass.numpy(), np.asarray(js.mass))
    np.testing.assert_array_equal(ts.boundary_x.numpy(),
                                  np.asarray(js.boundary_x))
    assert _rel(ts.boundary_psi.numpy(), js.boundary_psi) <= 1e-5
    for f in ("density0", "support_radius", "viscosity", "iterations",
              "cap_per_cell", "min_dt", "max_dt", "particle_radius",
              "gravity", "hash_cap"):
        assert getattr(ts, f) == getattr(js, f), f
    jg, tg = js.cellgrid, ts.cellgrid
    for f in ("origin", "dims", "cell", "cap", "max_active"):
        assert getattr(tg, f) == getattr(jg, f), f
    assert tg.boundary.capb == jg.boundary.capb
    np.testing.assert_array_equal(tg.boundary.near.numpy(),
                                  np.asarray(jg.boundary.near))
    assert _rel(tg.boundary.psit.numpy(), jg.boundary.psit) <= 1e-5


def test_convert_carries_a_jax_scene_and_state():
    fluid, bnd, domain = _inputs("6x8x6")
    js = jm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain, viscosity=0.03)
    ts = convert.fluid_scene_from_numpy(scene_numpy(js), device="cpu")
    np.testing.assert_array_equal(ts.boundary_psi.numpy(),
                                  np.asarray(js.boundary_psi))
    np.testing.assert_array_equal(
        ts.cellgrid.boundary.xt.numpy(),
        np.stack([np.asarray(p) for p in js.cellgrid.boundary.xt]))
    np.testing.assert_array_equal(ts.cellgrid.boundary.psit.numpy(),
                                  np.asarray(js.cellgrid.boundary.psit))
    assert ts.viscosity == 0.03 and ts.cellgrid.dims == js.cellgrid.dims
    assert ts.cellgrid.boundary.count.dtype == torch.int32
    jst = jm.FluidState.create(fluid)
    jst = jax.jit(jm.fluid_step)(jst, js)
    tst = convert.fluid_state_from_numpy(
        {f.name: np.asarray(getattr(jst, f.name))
         for f in dataclasses.fields(jst)}, device="cpu")
    np.testing.assert_array_equal(tst.x.numpy(), np.asarray(jst.x))
    assert tst.dt.item() == float(jst.dt)
    assert tst.overflow.item() == 0.0
    with pytest.raises(ValueError, match="lacks"):
        convert.fluid_scene_from_numpy({"mass": np.ones(3)}, device="cpu")


def _run(fn, state, n):
    for _ in range(n):
        state = fn(state)
    return state


def _assert_same_trajectory(t, j, tol, dt_rtol=1e-4):
    x = t.x.numpy()
    assert np.isfinite(x).all()
    dev = np.abs(x - np.asarray(j.x)).max()
    assert dev <= tol, dev
    assert _rel(t.dt.numpy(), j.dt) <= dt_rtol
    assert _rel(t.time.numpy(), j.time) <= dt_rtol
    assert t.overflow.item() == 0.0 and float(j.overflow) == 0.0


@pytest.mark.parametrize("name", ["8x8x6", "12x10x8"])
def test_cell_route_matches_jax_default_step(name):
    """10 steps of the port's cell route against JAX's ``fluid_step`` (the
    occupancy classes) and ``_fluid_step_cells(partition=False)``."""
    fluid, bnd, domain = _inputs(name)
    js = jm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain)
    assert jm.use_classes(js.cellgrid)
    ts = convert.fluid_scene_from_numpy(scene_numpy(js), device="cpu")
    fn = tm.make_fluid_step_fn(ts, device="cpu")
    assert fn.path == "torch_cells"
    jfn = jm.make_fluid_step_fn(js)
    t1 = fn(tm.FluidState.create(fluid, device="cpu"))
    j1 = jfn(jm.FluidState.create(fluid))
    _assert_same_trajectory(t1, j1, 1e-6, dt_rtol=1e-6)
    t = _run(fn, t1, 9)
    j_default = _run(jfn, j1, 9)
    _assert_same_trajectory(t, j_default, 1e-4)
    j_cells = _run(jax.jit(lambda s: jm._fluid_step_cells(
        s, js, partition=False)), jm.FluidState.create(fluid), 10)
    _assert_same_trajectory(t, j_cells, 1e-4)
    # the dam collapsed: it spread sideways and fell
    assert t.x[:, 0].max().item() > fluid[:, 0].max() + 0.1 * D


def test_port_scene_steps_like_jax():
    """The whole slice on the port's own scene: ``FluidScene.create`` (ψ
    computed by the port) → ``make_fluid_step_fn`` → 10 steps."""
    fluid, bnd, domain = _inputs("6x8x6")
    ts = tm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain, device="cpu")
    js = jm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain)
    t = _run(tm.make_fluid_step_fn(ts, device="cpu"),
             tm.FluidState.create(fluid, device="cpu"), 10)
    j = _run(jm.make_fluid_step_fn(js), jm.FluidState.create(fluid), 10)
    _assert_same_trajectory(t, j, 1e-4)


def test_hash_route_matches_jax():
    """A scene without a domain: the sort-based hash candidates."""
    fluid, bnd, _ = _inputs("6x8x6")
    js = jm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              cap_per_cell=32)
    ts = tm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              cap_per_cell=32, device="cpu")
    fn = tm.make_fluid_step_fn(ts, device="cpu")
    assert fn.path == "torch_hash" and ts.cellgrid is None
    t = _run(fn, tm.FluidState.create(fluid, device="cpu"), 10)
    j = _run(jm.make_fluid_step_fn(js), jm.FluidState.create(fluid), 10)
    _assert_same_trajectory(t, j, 5e-4)


def test_hash_route_pieces_match_jax():
    """density, λ, corrections and XSPH of the hash route, one at a time."""
    fluid, bnd, _ = _inputs("6x8x6")
    js = jm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              cap_per_cell=32)
    ts = convert.fluid_scene_from_numpy(scene_numpy(js), device="cpu")
    rng = np.random.default_rng(5)
    x = (fluid * 0.9 + rng.uniform(-0.2 * R, 0.2 * R, fluid.shape)).astype(
        np.float32)
    v = rng.normal(0, 0.3, fluid.shape).astype(np.float32)
    xa_j = jax.numpy.concatenate([jax.numpy.asarray(x), js.boundary_x])
    xa_t = torch.cat([torch.tensor(x), ts.boundary_x])
    sj = jm._sph_sums(xa_j, js)
    st = tm._sph_sums(xa_t, ts)
    dj = jm.compute_density(xa_j, sj[0], sj[1], sj[3], js)
    dt = tm.compute_density(xa_t, st[0], st[1], st[3], ts)
    assert _rel(dt.numpy(), dj) <= 1e-6
    lj = jm.compute_lambda(xa_j, sj[0], sj[1], sj[3], dj, js)
    lt = tm.compute_lambda(xa_t, st[0], st[1], st[3], dt, ts)
    assert (lt < 0).any() and _rel(lt.numpy(), lj) <= 1e-5
    cj = jm.solve_density_constraint(xa_j, *sj, lj, js)
    ct = tm.solve_density_constraint(xa_t, *st, lt, ts)
    assert np.abs(ct.numpy() - np.asarray(cj)).max() <= 1e-6
    corr_t, dens_t = tm._pbf_iteration(xa_t, *st, ts)
    assert np.abs(corr_t.numpy() - np.asarray(cj)).max() <= 1e-6
    assert _rel(dens_t.numpy(), dj) <= 1e-6
    vj = jm.xsph_viscosity(jax.numpy.asarray(x), jax.numpy.asarray(v),
                           sj[0], sj[1], sj[2], dj, js)
    vt = tm.xsph_viscosity(torch.tensor(x), torch.tensor(v), st[0], st[1],
                           st[2], dt, ts)
    assert np.abs(vt.numpy() - np.asarray(vj)).max() <= 1e-6
    a = np.broadcast_to(np.float32([0, -9.81, 0]), v.shape)
    hj = jm.cfl_dt(jax.numpy.asarray(v), jax.numpy.asarray(a),
                   jax.numpy.float32(0.004), js)
    ht = tm.cfl_dt(torch.tensor(v), torch.tensor(a), torch.tensor(0.004),
                   ts)
    assert ht.dim() == 0 and _rel(ht.numpy(), hj) <= 1e-6


def test_chunked_plain_step_equals_the_whole():
    fluid, bnd, domain = _inputs("6x8x6")
    ts = tm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain, device="cpu")
    s0 = _run(tm.make_fluid_step_fn(ts, device="cpu"),
              tm.FluidState.create(fluid, device="cpu"), 3)
    whole = tm._fluid_step_cells(s0, ts)
    chunked = tm.fluid_step_reference(s0, ts, chunk=5)
    assert (whole.x - chunked.x).abs().max().item() <= 1e-7
    assert (whole.v - chunked.v).abs().max().item() <= 1e-6


def test_partition_and_missing_card_raise():
    fluid, bnd, domain = _inputs("6x8x6")
    ts = tm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                              domain=domain, device="cpu")
    hash_scene = tm.FluidScene.create(len(fluid), bnd, particle_radius=R,
                                      device="cpu")
    for partition in (None, True):
        with pytest.raises(ValueError, match="cell grid"):
            tm._fluid_step_cells(tm.FluidState.create(fluid, device="cpu"),
                                 hash_scene, partition=partition)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.make_fluid_step_fn(ts)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.FluidState.create(fluid)
