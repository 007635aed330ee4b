"""The port's cell-dense PBF pipeline (fluids/cellgrid.py and the plain
versions of the kernels in fluids/cellgrid_cuda.py) against the JAX
package on the same seeded inputs, on the JAX tests' small dams: with a
boundary box, without one, and at ``cap_per_cell = 40`` (more slots than
a warp has lanes).

Tolerances: the grid, its boundary tables and every table that
``build_fluid_tables`` returns exactly (the same stable sort); the density
iterations within 1e-6 in positions and 1e-5 relative in density, the
JAX package's bar for its Pallas kernels against this path
(``tests/test_fluids.py``): the sums run in another order. Each plain
pass is held against the Pallas kernels in interpret mode (B3 and B4, one
iteration) or against ``xsph_cell`` (B5, with non-zero velocities), as
the JAX tests run them. The CUDA kernels themselves are held against
these plain versions on the card (``tests/test_torch_kernel_card.py``,
``chip_smoke.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.fluids import cellgrid as jcg
from positionbaseddynamics_tpu.fluids.cellgrid_pallas import pbf_step_pallas
from positionbaseddynamics_tpu.fluids.model import FluidScene as JScene
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.fluids import cellgrid as tcg
from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as tcc
from positionbaseddynamics_tpu_torch.fluids.model import (block_positions,
                                                           box_boundary)

R = 0.025
D = 2 * R
DAMS = {
    # name: (block, domain hi, with boundary, cap_per_cell, squeeze)
    "boundary": ((8, 8, 6), (10 * D * 3, 10 * D * 2, 8 * D), True, 12, 0.85),
    "no_boundary": ((8, 8, 6), (10 * D * 3, 10 * D * 2, 8 * D), False, 12,
                    0.85),
    # squeezed until cells hold more than 32 particles
    "cap40": ((6, 8, 6), (8 * D * 3, 10 * D, 8 * D), True, 40, 0.61),
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


def _dam(name):
    block, hi, with_boundary, cap, squeeze = DAMS[name]
    fluid = block_positions((D, D, D), block, D)
    lo = (0.0, 0.0, 0.0)
    bnd = box_boundary(lo, hi, D) if with_boundary else np.zeros((0, 3))
    js = JScene.create(len(fluid), bnd, particle_radius=R, domain=(lo, hi),
                       cap_per_cell=cap)
    ts = convert.fluid_scene_from_numpy(scene_numpy(js), device="cpu")
    # the block squeezed below its spacing, onto the floor, and jittered
    # (seeded): λ, the corrections and the boundary terms are all non-zero
    rng = np.random.default_rng(7)
    x = (D + squeeze * (fluid - D)
         + rng.uniform(-0.3 * R, 0.3 * R, fluid.shape)
         - np.asarray([0.0, 0.4 * R, 0.0])).astype(np.float32)
    return js, ts, x


def _tables(js, ts, x):
    jt = jcg.build_fluid_tables(js.cellgrid, jnp.asarray(x), js.mass)
    tt = tcg.build_fluid_tables(ts.cellgrid, torch.tensor(x), ts.mass)
    return jt, tt


def _planes(xt):
    return np.stack([np.asarray(p) for p in xt])


def _close(a, b, atol=None, rtol=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dev = np.abs(a - b).max()
    if atol is not None:
        assert dev <= atol, dev
    else:
        assert dev <= rtol * np.abs(b).max(), dev / np.abs(b).max()


@pytest.mark.parametrize("name", ["boundary", "cap40"])
def test_cellgrid_spec_matches_jax(name):
    block, hi, _, cap, _ = DAMS[name]
    bnd = box_boundary((0, 0, 0), hi, D)
    psi = np.random.default_rng(1).uniform(1.0, 2.0, len(bnd))
    j = jcg.CellGridSpec.create((0, 0, 0), hi, 4 * R, cap=max(cap, 28),
                                boundary_x=bnd, boundary_psi=psi,
                                n_fluid_hint=int(np.prod(block)))
    t = tcg.CellGridSpec.create((0, 0, 0), hi, 4 * R, cap=max(cap, 28),
                                boundary_x=bnd, boundary_psi=psi,
                                n_fluid_hint=int(np.prod(block)),
                                device="cpu")
    for f in ("origin", "dims", "cell", "cap", "max_active"):
        assert getattr(t, f) == getattr(j, f), f
    jb, tb = j.boundary, t.boundary
    assert tb.capb == jb.capb and tb.near_frac == jb.near_frac
    np.testing.assert_array_equal(tb.xt.numpy(), _planes(jb.xt))
    np.testing.assert_array_equal(tb.psit.numpy(), np.asarray(jb.psit))
    np.testing.assert_array_equal(tb.near.numpy(), np.asarray(jb.near))
    # the occupied prefix of every cell's boundary slots
    psit = np.asarray(jb.psit)
    count = tb.count.numpy()
    for c in range(psit.shape[0]):
        assert (psit[c, :count[c]] > 0).all()
        assert (psit[c, count[c]:] == 0).all()


def test_cellgrid_spec_without_cuda_and_device_raises(monkeypatch):
    """``CellGridSpec.create`` is an entry point: without a ``device`` it
    means CUDA, and without CUDA it raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tcg.CellGridSpec.create((0, 0, 0), (1, 1, 1), 4 * R)
    spec = tcg.CellGridSpec.create((0, 0, 0), (1, 1, 1), 4 * R,
                                   device="cpu")
    assert spec.boundary is None


@pytest.mark.parametrize("name,shrink", [
    ("boundary", False), ("no_boundary", False), ("cap40", False),
    ("boundary", True)])
def test_build_fluid_tables_matches_jax(name, shrink):
    js, ts, x = _dam(name)
    if shrink:
        # caps that bind: particles crowded out of cells, occupied cells
        # beyond max_active
        js = dataclasses.replace(js, cellgrid=dataclasses.replace(
            js.cellgrid, cap=5, max_active=20))
        ts = dataclasses.replace(ts, cellgrid=dataclasses.replace(
            ts.cellgrid, cap=5, max_active=20))
    jt, tt = _tables(js, ts, x)
    names = ("slot", "kept", "xt", "mt", "active", "nbr", "nbr_ok",
             "overflow")
    for n, a, b in zip(names, tt, jt):
        b = _planes(b) if n == "xt" else np.asarray(b)
        assert tuple(a.shape) == b.shape, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    assert (int(tt[-1]) > 0) == shrink
    # occupied slots are a prefix of every cell
    mt = tt[3].numpy()
    count = tcg.occupied_count(tt[3]).numpy()
    assert count.max() > (32 if name == "cap40" else 0)
    for c in range(mt.shape[0]):
        assert (mt[c, :count[c]] > 0).all() and (mt[c, count[c]:] == 0).all()


@pytest.mark.parametrize("name", list(DAMS))
def test_pbf_iterations_match_jax(name):
    js, ts, x = _dam(name)
    jt, tt = _tables(js, ts, x)
    xj, dj, _ = jcg.pbf_iterations(js.cellgrid, *jt[2:7], 5, js.density0,
                                   js.support_radius)
    # chunk 16 splits the active cells of these dams into several pieces
    xp, dp, x0 = tcg.pbf_iterations(ts.cellgrid, *tt[2:7], 5, ts.density0,
                                    ts.support_radius, chunk=16)
    assert x0 is tt[2]
    moved = np.abs(xp.numpy() - tt[2].numpy()).max()
    assert moved > 1e-4, moved            # the projection did work
    _close(xp.numpy(), _planes(xj), atol=1e-6)
    _close(dp.numpy(), dj, rtol=1e-5)


@pytest.mark.parametrize("name", list(DAMS))
def test_density_and_corrections_match_pallas_kernels(name):
    """B3 and B4's plain versions, one iteration, against the Pallas
    kernels in interpret mode."""
    js, ts, x = _dam(name)
    jt, tt = _tables(js, ts, x)
    xj, dj, _ = pbf_step_pallas(js.cellgrid, *jt[2:7], 1, js.density0,
                                js.support_radius, interpret=True)
    spec = ts.cellgrid
    xt, mt, active, nbr, nbr_ok = tt[2:7]
    lam, dens = tcc.density_lambda_reference(
        spec, xt, xt, mt, active, nbr, nbr_ok, ts.density0,
        ts.support_radius)
    assert (lam < 0).any()
    dens_t = torch.zeros_like(mt).index_copy(0, active.long(), dens)
    _close(dens_t.numpy(), dj, rtol=1e-5)
    lam_t = torch.zeros_like(mt).index_copy(0, active.long(), lam)
    corr = tcc.corrections_reference(spec, xt, xt, mt, lam_t, active, nbr,
                                     nbr_ok, ts.density0, ts.support_radius,
                                     chunk=7)
    x1 = xt.index_add(1, active.long(), corr)
    _close(x1.numpy(), _planes(xj), atol=1e-6)


@pytest.mark.parametrize("name", list(DAMS))
def test_xsph_matches_jax_with_velocities(name):
    js, ts, x = _dam(name)
    jt, tt = _tables(js, ts, x)
    xj, dj, pair_ok = jcg.pbf_iterations(js.cellgrid, *jt[2:7], 5,
                                         js.density0, js.support_radius)
    xp, dp, x0 = tcg.pbf_iterations(ts.cellgrid, *tt[2:7], 5, ts.density0,
                                    ts.support_radius)
    v = np.random.default_rng(3).normal(0.0, 0.5, x.shape).astype(
        np.float32)
    spec_j, spec_t = js.cellgrid, ts.cellgrid
    nslots = spec_t.n_cells * spec_t.cap
    slot_j, kept_j = jt[0], jt[1]
    vt_j = tuple(
        jnp.zeros((nslots,), jnp.float32).at[
            jnp.where(kept_j, slot_j, nslots)].set(
            jnp.asarray(v[:, c]), mode="drop").reshape(spec_j.n_cells,
                                                       spec_j.cap)
        for c in range(3))
    vt_t = tcg.scatter_planes(torch.tensor(v), tt[0], tt[1], nslots,
                              (spec_t.n_cells, spec_t.cap))
    np.testing.assert_array_equal(vt_t.numpy(), _planes(vt_j))
    out_j = jcg.xsph_cell(spec_j, xj, vt_j, jt[3], *jt[4:7], dj,
                          js.viscosity, js.support_radius, pair_ok)
    out_t = tcg.xsph_cell(spec_t, xp, vt_t, tt[3], *tt[4:7], dp,
                          ts.viscosity, ts.support_radius, x0, chunk=5)
    smoothed = np.abs(out_t.numpy() - vt_t.numpy()).max()
    assert smoothed > 1e-4, smoothed
    _close(out_t.numpy(), _planes(out_j), atol=1e-6)


def _emulate_kernels(monkeypatch, scene):
    """Stand the three kernel wrappers in with CPU functions that keep
    their contract (write the active rows of the given output tables, from
    the plain versions), so that the orchestration around the kernels runs
    here."""
    d0, h, visc = scene.density0, scene.support_radius, scene.viscosity
    calls = []

    def b3(spec, xt, xt0, mt, count, active, nbr, nbr_ok, lam_t, dens_t,
           params):
        assert count.dtype == torch.int32 and params.shape == (8,)
        lam, dens = tcc.density_lambda_reference(spec, xt, xt0, mt, active,
                                                 nbr, nbr_ok, d0, h)
        lam_t[active.long()] = lam
        dens_t[active.long()] = dens
        calls.append("b3")

    def b4(spec, xt, xt0, mt, count, lam_t, active, nbr, nbr_ok, x_out,
           params):
        assert x_out.data_ptr() not in (xt.data_ptr(), xt0.data_ptr())
        corr = tcc.corrections_reference(spec, xt, xt0, mt, lam_t, active,
                                         nbr, nbr_ok, d0, h)
        x_out[:, active.long()] = xt[:, active.long()] + corr
        calls.append("b4")

    def b5(spec, xt, xt0, vt, mt, count, dens_t, active, nbr, nbr_ok,
           v_out, params):
        assert v_out.data_ptr() != vt.data_ptr()
        dv = tcc.xsph_reference(spec, xt, xt0, vt, mt, dens_t, active, nbr,
                                nbr_ok, h)
        v_out[:, active.long()] = vt[:, active.long()] + (-visc) * dv
        calls.append("b5")

    monkeypatch.setattr(tcc, "density_lambda_cuda", b3)
    monkeypatch.setattr(tcc, "corrections_cuda", b4)
    monkeypatch.setattr(tcc, "xsph_cuda", b5)
    return calls


@pytest.mark.parametrize("name", ["boundary", "no_boundary"])
def test_pbf_step_cuda_orchestration_equals_plain(monkeypatch, name):
    """``pbf_step_cuda`` (two tables in turn, λ and density tables, the
    frozen ``xt0`` handed to XSPH) with each kernel stood in by its plain
    version equals ``pbf_iterations`` + ``xsph_cell``, and leaves its
    inputs as they were."""
    js, ts, x = _dam(name)
    _, tt = _tables(js, ts, x)
    calls = _emulate_kernels(monkeypatch, ts)
    spec = ts.cellgrid
    xt, mt, active, nbr, nbr_ok = tt[2:7]
    before = xt.clone()
    xk, dk, none = tcc.pbf_step_cuda(spec, xt, mt, active, nbr, nbr_ok, 5,
                                     ts.density0, ts.support_radius)
    assert none is None and calls == ["b3", "b4"] * 5
    xp, dp, x0 = tcg.pbf_iterations(spec, xt, mt, active, nbr, nbr_ok, 5,
                                    ts.density0, ts.support_radius)
    assert torch.equal(xt, before)
    assert torch.equal(xk, xp) and torch.equal(dk, dp)
    v = torch.tensor(np.random.default_rng(4).normal(0, 0.5, x.shape),
                     dtype=torch.float32)
    vt = tcg.scatter_planes(v, tt[0], tt[1], spec.n_cells * spec.cap,
                            mt.shape)
    _, dk2, vk = tcc.pbf_step_cuda(spec, xk, mt, active, nbr, nbr_ok, 0,
                                   ts.density0, ts.support_radius, vt=vt,
                                   viscosity=ts.viscosity, density=dk,
                                   xt0=xt)
    assert dk2 is dk and calls[-1] == "b5"
    vp = tcg.xsph_cell(spec, xp, vt, mt, active, nbr, nbr_ok, dp,
                       ts.viscosity, ts.support_radius, x0)
    assert torch.equal(vk, vp)


def test_kernel_route_of_the_step_equals_plain_route(monkeypatch):
    """The step's kernel branch, with each kernel stood in by its plain
    version, equals the plain step, and launches 5 + 5 + 1 a step."""
    from positionbaseddynamics_tpu_torch.fluids import model as tm

    js, ts, _ = _dam("boundary")
    calls = _emulate_kernels(monkeypatch, ts)
    block = DAMS["boundary"][0]
    s = tm.FluidState.create(block_positions((D, D, D), block, D),
                             device="cpu")
    a = b = s
    for _ in range(3):
        a = tm._cell_step(a, ts, kernels=True)
        b = tm.fluid_step_reference(b, ts)
    assert calls == (["b3", "b4"] * 5 + ["b5"]) * 3
    for f in ("x", "v", "old_x", "last_x", "time", "dt", "overflow"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
