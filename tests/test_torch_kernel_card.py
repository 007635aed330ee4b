"""The CUDA cloth, tet and PBF kernels against their plain PyTorch
versions, on the card.

These tests import only torch and the port, so they run on a machine with
the card (``python -m pytest tests/test_torch_kernel_card.py``); without a
CUDA device they skip, since the kernel has no CPU mode. Tolerance 1e-5
over 5 steps, the repo's kernel-against-stencil bar (``bench.py --check``):
the kernel contracts products into FMAs where the plain version rounds
each operation."""
import pytest
import torch

from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc


def _build(n, m, device):
    b = SceneBuilder()
    tm = b.add_regular_triangle_model(n, m, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + n - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("shape,iters", [((40, 37), 2), ((67, 53), 1),
                                         ((40, 37), 6)])
def test_kernel_matches_plain_version_on_card(cuda, shape, iters):
    ts, tc = _build(*shape, device=cuda)
    g = tc.grid_cloths[0]
    step = gcc.make_cloth_step(
        g, ts.particles.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend, dt=0.005,
        substeps=5, max_iterations=iters, damping=0.01, n_steps=5)
    x, v = step(ts.particles.x, ts.particles.v)
    xr, vr = ts.particles.x, ts.particles.v
    for _ in range(25):
        xr, vr = gcc.cloth_substep_reference(
            g, xr, vr, ts.particles.inv_mass, h=1e-3, max_iterations=iters,
            damping=0.01)
    assert (x - xr).abs().max().item() <= 1e-5


@pytest.mark.parametrize("iters,launches_per_substep", [
    (1, 1), (gcc.FUSED_ITERATIONS + 1, 2)])
def test_step_fn_takes_the_kernel_on_card(cuda, iters, launches_per_substep):
    """More iterations than one launch holds stay on the kernel route, as
    several launches a substep with λ carried between them."""
    cfg = StepConfig(max_iterations=iters)
    ts, tc = _build(33, 33, device=cuda)
    fn = make_step_fn(tc, cfg, device=cuda)
    assert fn.path == "cuda_kernel"
    before = gcc.cloth_substep_cuda.launches
    out = fn(fn(ts))
    assert (gcc.cloth_substep_cuda.launches - before
            == 2 * cfg.substeps * launches_per_substep)
    ref = make_step_fn(tc.to("cpu"), cfg, device="cpu")
    cpu = ref(ref(ts.to("cpu")))
    for f in ("x", "old_x", "last_x"):
        dev = getattr(out.particles, f).cpu() - getattr(cpu.particles, f)
        assert dev.abs().max().item() <= 1e-5, f
    assert abs(out.time.item() - cpu.time.item()) <= 1e-7


def test_batched_state_with_own_inverse_masses_on_card(cuda):
    """A ``(B, N, 3)`` state whose rollouts pin different particles: the
    kernel reads each rollout's own inverse-mass plane."""
    import dataclasses

    ts, tc = _build(35, 18, device=cuda)
    p = ts.particles
    inv_mass = torch.stack([p.inv_mass, p.inv_mass.clone()])
    inv_mass[1, 35 * 17] = 0.0                 # pin a top corner in one
    batched = dataclasses.replace(ts, particles=dataclasses.replace(
        p, **{f: torch.stack([getattr(p, f)] * 2)
              for f in ("x", "v", "old_x", "last_x", "x0")},
        inv_mass=inv_mass))
    fn = make_step_fn(tc, StepConfig(), device=cuda)
    assert fn.path == "cuda_kernel"
    ref = make_step_fn(tc.to("cpu"), StepConfig(), device="cpu")
    out, cpu = batched, batched.to("cpu")
    for _ in range(3):
        out, cpu = fn(out), ref(cpu)
    dev = (out.particles.x.cpu() - cpu.particles.x).abs().max().item()
    assert dev <= 1e-5
    x0 = p.x[35 * 17]
    assert torch.equal(out.particles.x[1, 35 * 17], x0)
    assert not torch.equal(out.particles.x[0, 35 * 17], x0)


def _bar(dims, device, stiffness=1e5):
    b = SceneBuilder()
    tm = b.add_regular_tet_model(*dims, scale=(2.0, 0.5, 0.5))
    for j in range(dims[1]):
        for k in range(dims[2]):
            b.set_mass(tm.offset + j * dims[2] + k, 0.0)
    b.add_solid_constraints(tm, method=3, stiffness=stiffness,
                            poisson_ratio=0.3)
    return b.build(device=device)


# The 5-iteration case runs 4 steps: at more than one iteration the
# reference's own trajectory jumps by orders of magnitude at step 6 at
# this size (tests/test_torch_tet_step.py), and two runs past that point
# agree to no tolerance.
@pytest.mark.parametrize("dims,iters,damping,stiffness,steps", [
    ((13, 7, 5), 1, 0.0, 1e5, 10), ((13, 7, 5), 5, 0.01, 1e5, 4),
    ((9, 4, 6), 2, 0.0, 1e5, 3), ((13, 7, 5), 1, 0.0, 0.0, 10)],
    ids=["13x7x5", "13x7x5_it5_damped", "9x4x6_it2", "stiffness0"])
def test_tet_kernel_matches_plain_version_on_card(cuda, dims, iters, damping,
                                                  stiffness, steps):
    ts, tc = _bar(dims, cuda, stiffness)
    g, p = tc.grid_tets[0], ts.particles
    step = gtc.make_tet_step(g, p.inv_mass, dt=0.005, substeps=5,
                             max_iterations=iters, damping=damping,
                             n_steps=steps)
    x, v = step(p.x, p.v)
    xr, vr = p.x, p.v
    for _ in range(5 * steps):
        xr, vr = gtc.tet_substep_reference(g, xr, vr, p.inv_mass, h=1e-3,
                                           max_iterations=iters,
                                           damping=damping)
    assert torch.isfinite(x).all() and torch.isfinite(v).all()
    assert (x - xr).abs().max().item() <= (1e-6 if stiffness == 0 else 1e-5)
    n_pin = dims[1] * dims[2]
    assert torch.equal(x[:n_pin], p.x[:n_pin])
    assert torch.equal(v[:n_pin], p.v[:n_pin])


@pytest.mark.parametrize("iters", [1, 3])
def test_tet_step_fn_takes_the_kernel_on_card(cuda, iters):
    cfg = StepConfig(max_iterations=iters)
    ts, tc = _bar((11, 5, 6), cuda)
    fn = make_step_fn(tc, cfg, device=cuda)
    assert fn.path == "cuda_kernel"
    before = gtc.tet_substep_cuda.launches
    out = fn(fn(ts))
    assert (gtc.tet_substep_cuda.launches - before
            == 2 * cfg.substeps * 2 * iters)
    ref = make_step_fn(tc.to("cpu"), cfg, device="cpu")
    cpu = ref(ref(ts.to("cpu")))
    for f in ("x", "v", "old_x", "last_x"):
        dev = getattr(out.particles, f).cpu() - getattr(cpu.particles, f)
        tol = 1e-5 if f != "v" else 2e-5 / 1e-3
        assert dev.abs().max().item() <= tol, f
    assert out.time.item() == cpu.time.item()


def _fluid_dam(cuda, block=(12, 10, 8), hi=(1.4, 1.1, 0.5), cap=12,
               squeeze=0.85, boundary=True):
    """A small dam on the card with positions squeezed below the lattice
    spacing and jittered (seeded), so every pass does work; its tables."""
    import numpy as np

    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    d = 0.05
    fluid = fm.block_positions((d, d, d), block, d)
    bnd = (fm.box_boundary((0, 0, 0), hi, d) if boundary
           else np.zeros((0, 3), np.float32))
    scene = fm.FluidScene.create(len(fluid), bnd, cap_per_cell=cap,
                                 domain=((0, 0, 0), hi), device=cuda)
    rng = np.random.default_rng(11)
    x = (d + squeeze * (fluid - d) + rng.uniform(-0.0075, 0.0075, fluid.shape)
         - np.float32([0.0, 0.01, 0.0])).astype(np.float32)
    tables = fcg.build_fluid_tables(scene.cellgrid,
                                    torch.tensor(x, device=cuda), scene.mass)
    v = torch.tensor(rng.normal(0, 0.5, fluid.shape).astype(np.float32),
                     device=cuda)
    return scene, tables, v


# ρ within 1e-5 relative and Δx, Δv within 1e-6: the kernels add each
# cell's terms in another order than torch.sum and contract into FMAs;
# their pair sets equal the plain versions' exactly.
@pytest.mark.parametrize("kw", [
    {}, {"block": (6, 8, 6), "hi": (1.2, 0.5, 0.4), "cap": 40,
         "squeeze": 0.61}, {"boundary": False}],
    ids=["12x10x8", "cap40", "no_boundary"])
def test_pbf_kernels_match_plain_versions_on_card(cuda, kw):
    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc

    scene, (slot, kept, xt, mt, active, nbr, nbr_ok, ov), v = _fluid_dam(
        cuda, **kw)
    spec, d0, h = scene.cellgrid, scene.density0, scene.support_radius
    count = fcg.occupied_count(mt)
    if "cap" in kw:
        assert count.max().item() > 32
    params = fcc.kernel_params(d0, h, scene.viscosity)
    act = active.long()
    lam_t, dens_t = torch.zeros_like(mt), torch.zeros_like(mt)
    fcc.density_lambda_cuda(spec, xt, xt, mt, count, active, nbr, nbr_ok,
                            lam_t, dens_t, params)
    lam_r, dens_r = fcc.density_lambda_reference(spec, xt, xt, mt, active,
                                                 nbr, nbr_ok, d0, h)
    torch.cuda.synchronize()
    assert (lam_r < 0).any()
    assert ((dens_t[act] - dens_r).abs().max()
            <= 1e-5 * dens_r.abs().max())
    assert (lam_t[act] - lam_r).abs().max() <= 1e-5 * lam_r.abs().max()

    x_out = xt.clone()
    fcc.corrections_cuda(spec, xt, xt, mt, count, lam_t, active, nbr,
                         nbr_ok, x_out, params)
    corr = fcc.corrections_reference(spec, xt, xt, mt, lam_t, active, nbr,
                                     nbr_ok, d0, h)
    x_ref = xt.index_add(1, act, corr)
    assert (x_ref - xt).abs().max().item() > 1e-4
    assert (x_out - x_ref).abs().max().item() <= 1e-6

    # the main path's second iteration: positions moved by the first B4,
    # the pair set still frozen at xt
    lam2, dens2 = torch.zeros_like(mt), torch.zeros_like(mt)
    fcc.density_lambda_cuda(spec, x_out, xt, mt, count, active, nbr, nbr_ok,
                            lam2, dens2, params)
    lam2_r, dens2_r = fcc.density_lambda_reference(spec, x_out, xt, mt,
                                                   active, nbr, nbr_ok, d0, h)
    torch.cuda.synchronize()
    assert (lam2_r < 0).any()
    assert ((dens2[act] - dens2_r).abs().max()
            <= 1e-5 * dens2_r.abs().max())
    assert (lam2[act] - lam2_r).abs().max() <= 1e-5 * lam2_r.abs().max()
    x_out2 = x_out.clone()
    fcc.corrections_cuda(spec, x_out, xt, mt, count, lam2, active, nbr,
                         nbr_ok, x_out2, params)
    corr2 = fcc.corrections_reference(spec, x_out, xt, mt, lam2, active,
                                      nbr, nbr_ok, d0, h)
    x2_ref = x_out.index_add(1, act, corr2)
    assert (x2_ref - x_out).abs().max().item() > 0.0
    assert (x_out2 - x2_ref).abs().max().item() <= 1e-6

    nslots = spec.n_cells * spec.cap
    vt = fcg.scatter_planes(v, slot, kept, nslots, mt.shape)
    v_out = vt.clone()
    # positions moved by the corrections, pair set frozen at xt
    fcc.xsph_cuda(spec, x_out, xt, vt, mt, count, dens_t, active, nbr,
                  nbr_ok, v_out, params)
    v_ref = fcg.xsph_cell(spec, x_out, vt, mt, active, nbr, nbr_ok, dens_t,
                          scene.viscosity, h, xt)
    assert (v_ref - vt).abs().max().item() > 1e-4
    assert (v_out - v_ref).abs().max().item() <= 1e-6


def test_pbf_kernels_refuse_what_they_do_not_take(cuda):
    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc

    scene, (_, _, xt, mt, active, nbr, nbr_ok, _), _ = _fluid_dam(cuda)
    spec = scene.cellgrid
    count = fcg.occupied_count(mt)
    params = fcc.kernel_params(scene.density0, scene.support_radius)
    lam_t, dens_t = torch.zeros_like(mt), torch.zeros_like(mt)
    before = fcc.density_lambda_cuda.launches
    with pytest.raises(ValueError, match="nbr"):
        fcc.density_lambda_cuda(spec, xt, xt, mt, count, active,
                                nbr.to(torch.int64), nbr_ok, lam_t, dens_t,
                                params)
    with pytest.raises(ValueError, match="CUDA"):
        fcc.density_lambda_cuda(spec, xt.cpu(), xt.cpu(), mt.cpu(),
                                count.cpu(), active.cpu(), nbr.cpu(),
                                nbr_ok.cpu(), lam_t.cpu(), dens_t.cpu(),
                                params)
    with pytest.raises(ValueError, match="x_out"):
        fcc.corrections_cuda(spec, xt, xt, mt, count, lam_t, active, nbr,
                             nbr_ok, xt, params)
    assert fcc.density_lambda_cuda.launches == before


def test_fluid_step_fn_takes_the_kernels_on_card(cuda):
    """5 density and 5 correction launches and one XSPH launch a step, and
    the same trajectory as the plain step on the CPU."""
    import numpy as np

    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    d = 0.05
    fluid = fm.block_positions((d, d, d), (12, 10, 8), d)
    hi = (1.4, 1.1, 0.5)
    bnd = fm.box_boundary((0, 0, 0), hi, d)
    scene = fm.FluidScene.create(len(fluid), bnd, domain=((0, 0, 0), hi),
                                 device=cuda)
    fn = fm.make_fluid_step_fn(scene, device=cuda)
    assert fn.path == "cuda_kernel"
    ref = fm.make_fluid_step_fn(scene.to("cpu"), device="cpu")
    s, r = (fm.FluidState.create(fluid, device=cuda),
            fm.FluidState.create(fluid, device="cpu"))
    wrappers = (fcc.density_lambda_cuda, fcc.corrections_cuda, fcc.xsph_cuda)
    before = [w.launches for w in wrappers]
    for _ in range(5):
        s, r = fn(s), ref(r)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [25, 25, 5]
    assert s.overflow.item() == 0.0 and r.overflow.item() == 0.0
    assert np.isfinite(s.x.cpu().numpy()).all()
    assert (s.x.cpu() - r.x).abs().max().item() <= 1e-4
    assert abs(s.time.item() - r.time.item()) <= 1e-5 * r.time.item()
