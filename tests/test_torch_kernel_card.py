"""The CUDA cloth, tet and PBF kernels against their plain PyTorch
versions, on the card.

These tests import only torch, the port and ``chip_smoke.py``'s
neighbourhood counts, so they run on a machine with the card
(``python -m pytest tests/test_torch_kernel_card.py``); without a
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
from positionbaseddynamics_tpu_torch.utils import telemetry


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


# one case for each iteration count a launch holds (one template instance
# each), more than a launch holds (two launches a substep), and a grid
# smaller than one tile
@pytest.mark.parametrize("shape,iters", [((40, 37), 2), ((67, 53), 1),
                                         ((40, 37), 6), ((40, 37), 1),
                                         ((40, 37), 3), ((40, 37), 4),
                                         ((40, 37), 5), ((5, 3), 1),
                                         ((5, 3), 4)])
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
    before = telemetry.launches("cloth_substep")
    out = fn(fn(ts))
    assert (telemetry.launches("cloth_substep") - before
            == 2 * cfg.substeps * launches_per_substep)
    ref = make_step_fn(tc.to("cpu"), cfg, device="cpu")
    cpu = ref(ref(ts.to("cpu")))
    for f in ("x", "old_x", "last_x"):
        dev = getattr(out.particles, f).cpu() - getattr(cpu.particles, f)
        assert dev.abs().max().item() <= 1e-5, f
    assert abs(out.time.item() - cpu.time.item()) <= 1e-7


def _unstructured(kind, device):
    """The unstructured route's scenes: a 24×24 cloth (XPBD distance and
    isometric bending batches) or a 6×4×4 tet bar (the FEM-tet batch with
    its inversion select, whose SVD takes the Jacobi form on the card),
    its last six particles pulled 0.3 down out of the rest shape, so that
    the first steps have large corrections and tets start inverted."""
    import dataclasses

    b = SceneBuilder(use_structured_grid=False)
    if kind == "cloth":
        tm = b.add_regular_triangle_model(24, 24, scale=(2.0, 2.0))
        b.set_mass(tm.offset, 0.0)
        b.set_mass(tm.offset + 23, 0.0)
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        b.add_bending_constraints(tm, method=3, stiffness=0.05)
    else:
        tm = b.add_regular_tet_model(6, 4, 4, scale=(1.0, 0.5, 0.5))
        for k in range(16):
            b.set_mass(tm.offset + k, 0.0)
        b.add_solid_constraints(tm, method=3, stiffness=1e4,
                                poisson_ratio=0.3)
    state, cset = b.build(device=device)
    p = state.particles
    x = p.x.clone()
    x[-6:, 1] -= 0.3
    return dataclasses.replace(state, particles=dataclasses.replace(
        p, x=x, old_x=x.clone(), last_x=x.clone())), cset


@pytest.mark.parametrize("kind,mode", [("cloth", "jacobi"),
                                       ("cloth", "gauss_seidel"),
                                       ("tet", "jacobi")])
def test_unstructured_route_on_card_matches_cpu(cuda, kind, mode):
    """The particle batches on the card (``index_add_`` by atomics, the
    Jacobi SVD) against the same route on the CPU over 10 steps, within
    the 1e-5 bar; no kernel launches; pinned rows exact."""
    cfg = StepConfig(solver_mode=mode)
    ts, tc = _unstructured(kind, cuda)
    fn = make_step_fn(tc, cfg, device=cuda)
    assert fn.path == "torch_unstructured"
    before = (telemetry.launches("cloth_substep"),
              telemetry.launches("tet_substep"))
    ref = make_step_fn(tc.to("cpu"), cfg, device="cpu")
    out, cpu = ts, ts.to("cpu")
    for _ in range(10):
        out, cpu = fn(out), ref(cpu)
    assert (telemetry.launches("cloth_substep"),
            telemetry.launches("tet_substep")) == before
    for f in ("x", "old_x", "last_x"):
        dev = getattr(out.particles, f).cpu() - getattr(cpu.particles, f)
        assert dev.abs().max().item() <= 1e-5, f
    pinned = ts.particles.inv_mass == 0
    assert torch.equal(out.particles.x[pinned], ts.particles.x[pinned])
    assert torch.isfinite(out.particles.x).all()


def test_kernel_plan_refuses_a_grid_cloth_with_an_extra_batch(cuda):
    """A structured cloth that B1 would take, plus one distance constraint
    on its own particles: the step takes the PyTorch route, which solves
    both, and matches the CPU."""
    from positionbaseddynamics_tpu_torch.solver.step import kernel_plan

    def build(device):
        b = SceneBuilder()
        tm = b.add_regular_triangle_model(33, 33, scale=(2.0, 2.0))
        b.set_mass(tm.offset, 0.0)
        b.set_mass(tm.offset + 32, 0.0)
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        b.add_bending_constraints(tm, method=3, stiffness=0.05)
        b.add_distance_constraint(33 * 32, 33 * 33 - 1, stiffness=1e3,
                                  xpbd=True)
        return b.build(device=device)

    ts, tc = build(cuda)
    assert len(tc.grid_cloths) == 1 and tc.distance is not None
    assert kernel_plan(tc, StepConfig()) is None
    fn = make_step_fn(tc, StepConfig(), device=cuda)
    assert fn.path == "torch_unstructured"
    before = telemetry.launches("cloth_substep")
    out = fn(fn(ts))
    assert telemetry.launches("cloth_substep") == before
    ref = make_step_fn(tc.to("cpu"), StepConfig(), device="cpu")
    cpu = ref(ref(ts.to("cpu")))
    dev = (out.particles.x.cpu() - cpu.particles.x).abs().max().item()
    assert dev <= 1e-5


def _own_inverse_masses(cuda, n_roll):
    """A ``(n_roll, N, 3)`` state of a 35x18 cloth whose last rollout pins
    a top corner too; the kernel reads each rollout's own inverse-mass
    plane. Three steps on the card against the plain route on the CPU."""
    import dataclasses

    ts, tc = _build(35, 18, device=cuda)
    p = ts.particles
    inv_mass = torch.stack([p.inv_mass] * n_roll).clone()
    inv_mass[-1, 35 * 17] = 0.0                # pin a top corner in one
    batched = dataclasses.replace(ts, particles=dataclasses.replace(
        p, **{f: torch.stack([getattr(p, f)] * n_roll)
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
    assert torch.equal(out.particles.x[-1, 35 * 17], x0)
    for r in range(n_roll - 1):
        assert not torch.equal(out.particles.x[r, 35 * 17], x0)


def test_batched_state_with_own_inverse_masses_on_card(cuda):
    _own_inverse_masses(cuda, 2)


def test_four_rollouts_with_own_inverse_masses_on_card(cuda):
    _own_inverse_masses(cuda, 4)


def _64_rollouts(cuda):
    ts, tc = _build(64, 64, device=cuda)
    g, p = tc.grid_cloths[0], ts.particles
    step = gcc.make_cloth_step(
        g, p.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend, dt=0.005, substeps=5,
        n_batch=64, n_steps=10)
    return g, p, step, torch.Generator(device=cuda).manual_seed(3)


def test_kernel_at_64_rollouts_matches_plain_version_on_card(cuda):
    """The planner's shape: 64 rollouts of a 64×64 cloth that differ as a
    planner's do, by smooth motions (each its own seeded translation and
    uniform velocity), 10 steps against the plain version; the two pinned
    corners stay exactly where they were."""
    g, p, step, gen = _64_rollouts(cuda)
    shift = 0.05 * torch.randn((64, 1, 3), generator=gen, device=cuda)
    x = (p.x + shift).contiguous()
    v = (0.2 * torch.randn((64, 1, 3), generator=gen, device=cuda)
         ).expand(64, *p.v.shape).contiguous()
    before = telemetry.launches("cloth_substep")
    xk, _ = step(x, v)
    assert telemetry.launches("cloth_substep") - before == 50
    xr, vr = x, v
    for _ in range(50):
        xr, vr = gcc.cloth_substep_reference(g, xr, vr, p.inv_mass, h=1e-3)
    assert (xk - xr).abs().max().item() <= 1e-5
    assert torch.isfinite(xk).all()
    pinned = [0, 63]
    assert torch.equal(xk[:, pinned], x[:, pinned])
    assert (xk[0] - xk[1]).abs().max().item() > 1e-4


def test_kernel_at_64_rollouts_equals_each_rollout_alone_on_card(cuda):
    """Each of 64 rollouts, each from its own seeded 1 cm jitter of every
    free particle and random velocities, comes out of the batched launch
    bit for bit as out of a launch of its own over 10 steps: the batch
    axis only selects the rollout's planes. (Against the plain version
    this jitter is no bar: the stiff cloth amplifies the kernel's FMA
    rounding to ~3e-5 over these 10 steps.)"""
    g, p, step, gen = _64_rollouts(cuda)
    free = (p.inv_mass > 0).to(torch.float32)[:, None]
    x = p.x + 1e-2 * free * torch.randn((64,) + tuple(p.x.shape),
                                        generator=gen, device=cuda)
    v = 0.1 * free * torch.randn((64,) + tuple(p.v.shape), generator=gen,
                                 device=cuda)
    xk, vk = step(x, v)
    one = gcc.make_cloth_step(
        g, p.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend, dt=0.005, substeps=5,
        n_steps=10)
    for r in range(64):
        xs, vs = one(x[r], v[r])
        assert torch.equal(xk[r], xs) and torch.equal(vk[r], vs), r
    assert torch.equal(xk[:, [0, 63]], x[:, [0, 63]])


def test_fused_kernel_at_64_rollouts_on_card(cuda):
    """The fused mode at the planner's shape: the 64 smoothly moving
    rollouts of the 64×64 cloth (512 items, more than an H100 holds
    blocks at once, so blocks take several a pass), 10 steps of one
    cooperative launch each, bit for bit the per-substep launches and
    within 1e-5 of the plain version; a rollout launched alone (8 items)
    bit for bit its place in the batch."""
    g, p, step, gen = _64_rollouts(cuda)
    shift = 0.05 * torch.randn((64, 1, 3), generator=gen, device=cuda)
    x = (p.x + shift).contiguous()
    v = (0.2 * torch.randn((64, 1, 3), generator=gen, device=cuda)
         ).expand(64, *p.v.shape).contiguous()
    fused = gcc.make_cloth_step(
        g, p.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend, dt=0.005, substeps=5,
        n_batch=64, n_steps=10, fuse_substeps=True)
    before = telemetry.launches("cloth_fused")
    wide = telemetry.counters().get("kernel.cloth_substep.wide_launches", 0)
    xf, vf = fused(x, v)
    assert telemetry.launches("cloth_fused") - before == 10
    assert telemetry.counters().get(
        "kernel.cloth_substep.wide_launches", 0) == wide
    assert gcc.cloth_fused_cuda.grid == min(512, gcc.fused_capacity())
    xk, vk = step(x, v)
    assert torch.equal(xf, xk) and torch.equal(vf, vk)
    xr, vr = x, v
    for _ in range(50):
        xr, vr = gcc.cloth_substep_reference(g, xr, vr, p.inv_mass, h=1e-3)
    assert (xf - xr).abs().max().item() <= 1e-5
    one = gcc.make_cloth_step(
        g, p.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend, dt=0.005, substeps=5,
        n_steps=10, fuse_substeps=True)
    xs, vs = one(x[17], v[17])
    assert gcc.cloth_fused_cuda.grid == 8
    assert torch.equal(xf[17], xs) and torch.equal(vf[17], vs)


def _wide_launches():
    return telemetry.counters().get("kernel.cloth_substep.wide_launches", 0)


def _tile_substep(wide, xp, vp, w, icd, icb, params):
    """One substep at one iteration on the wide (``pbd_cloth_wide``) or the
    small tile (``pbd_cloth_substep``), whatever the wrapper's rule would
    take."""
    from positionbaseddynamics_tpu_torch import _build

    lib = _build.load("grid_cloth_step")
    fn = gcc._bind(lib)
    b, _, h, wd = xp.shape
    xo, vo = torch.empty_like(xp), torch.empty_like(vp)
    w_bstride = 0 if w.dim() == 2 else h * wd
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    if wide:
        err = lib.pbd_cloth_wide(
            xp.data_ptr(), vp.data_ptr(), xo.data_ptr(), vo.data_ptr(),
            w.data_ptr(), w_bstride, icd.data_ptr(), icb.data_ptr(),
            params.ctypes.data, b, h, wd, stream)
    else:
        err = fn(xp.data_ptr(), vp.data_ptr(), None, None, xo.data_ptr(),
                 vo.data_ptr(), None, w.data_ptr(), w_bstride,
                 icd.data_ptr(), icb.data_ptr(), params.ctypes.data, b, h,
                 wd, 1, 0, h, stream)
    assert err == 0, lib.pbd_error_string(err).decode()
    return xo, vo


# the planner's 320x320 cloth at 64 and 256 rollouts, a grid whose sides are
# no multiple of the wide tile, each rollout's own inverse masses, damping 0
# and 0.01
@pytest.mark.parametrize("shape,n_batch,own_w,damping", [
    ((320, 320), 64, False, 0.0), ((320, 320), 256, False, 0.01),
    ((68, 52), 256, False, 0.0), ((68, 52), 256, True, 0.01),
    ((320, 320), 256, True, 0.0)],
    ids=["320_k64", "320_k256_damped", "68x52_k256", "68x52_k256_own_w",
         "320_k256_own_w"])
def test_wide_tile_equals_small_tile_on_card(cuda, shape, n_batch, own_w,
                                             damping):
    """10 substeps of rollouts that each start from their own seeded 1 cm
    jitter of the free particles and random velocities: the wide tile and
    the wrapper come out of every substep bit for bit as the small tile,
    the wrapper counts a wide launch where ``takes_wide`` says so, the
    pinned particles stay exactly where they were, and no launch writes
    its inputs."""
    ts, tc = _build(*shape, device=cuda)
    g, p = tc.grid_cloths[0], ts.particles
    hgt, wid = g.height, g.width
    gen = torch.Generator(device=cuda).manual_seed(11)
    w = p.inv_mass.reshape(hgt, wid).contiguous()
    if own_w:
        w = w.expand(n_batch, hgt, wid).clone()
        r = torch.arange(n_batch, device=cuda)
        w[r, (5 * r) % hgt, (7 * r) % wid] = 0.0    # pin one more in each
    pinned = (w == 0).expand(n_batch, hgt, wid)
    free = (p.inv_mass > 0).to(torch.float32)[:, None]
    x = p.x + 1e-2 * free * torch.randn((n_batch,) + tuple(p.x.shape),
                                        generator=gen, device=cuda)
    v = 0.1 * free * torch.randn((n_batch,) + tuple(p.v.shape),
                                 generator=gen, device=cuda)
    x0 = gcc.to_planes(x, hgt, wid)
    icd = g.inv_cnt_dist.reshape(hgt, wid).contiguous()
    icb = g.inv_cnt_bend.reshape(hgt, wid).contiguous()
    params = gcc.kernel_params(g, h=1e-3, damping=damping)
    args = (w, icd, icb, params)
    xt, vt = x0, gcc.to_planes(v, hgt, wid)
    xw, vw = xt, vt
    xc, vc = xt, vt
    takes = gcc.takes_wide(n_batch, hgt, wid, 1, 0, hgt, gcc.wide_capacity())
    before = _wide_launches()
    for s in range(10):
        ins = (xt, vt, xw, vw, xc, vc)
        saved = [a.clone() for a in ins]
        xt, vt = _tile_substep(False, xt, vt, *args)
        xw, vw = _tile_substep(True, xw, vw, *args)
        xc, vc = gcc.cloth_substep_cuda(xc, vc, *args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ins, saved)), s
        assert torch.equal(xw, xt) and torch.equal(vw, vt), s
        assert torch.equal(xc, xt) and torch.equal(vc, vt), s
    assert torch.isfinite(xt).all()
    assert _wide_launches() - before == (10 if takes else 0)
    assert not torch.equal(xt, x0)
    for q in range(3):
        assert torch.equal(xw[:, q][pinned], x0[:, q][pinned])


def test_wide_tile_leaves_its_inputs_on_card(cuda):
    """A wide launch reads its inputs and writes only its outputs."""
    ts, tc = _build(68, 52, device=cuda)
    g, p = tc.grid_cloths[0], ts.particles
    hgt, wid = g.height, g.width
    gen = torch.Generator(device=cuda).manual_seed(12)
    n_batch = 64
    xp = gcc.to_planes(p.x + 1e-2 * torch.randn(
        (n_batch,) + tuple(p.x.shape), generator=gen, device=cuda), hgt, wid)
    vp = gcc.to_planes(0.1 * torch.randn(
        (n_batch,) + tuple(p.v.shape), generator=gen, device=cuda), hgt, wid)
    w = p.inv_mass.reshape(hgt, wid).contiguous()
    icd = g.inv_cnt_dist.reshape(hgt, wid).contiguous()
    icb = g.inv_cnt_bend.reshape(hgt, wid).contiguous()
    params = gcc.kernel_params(g, h=1e-3)
    saved = [a.clone() for a in (xp, vp, w, icd, icb)]
    xo, vo = _tile_substep(True, xp, vp, w, icd, icb, params)
    torch.cuda.synchronize()
    for a, b in zip((xp, vp, w, icd, icb), saved):
        assert torch.equal(a, b)
    assert not torch.equal(xo, xp)


@pytest.mark.parametrize("n_batch", [1, 256])
def test_step_fn_counts_wide_launches_on_card(cuda, n_batch):
    """A ``make_step_fn`` step of the 320x320 cloth, one rollout or the
    planner's 256 (``mpc.planners._expand_state``): 5 launches, each wide
    exactly where ``takes_wide`` says, so 0 of 5 at one rollout and 5 of 5
    at 256 on an H100."""
    from positionbaseddynamics_tpu_torch.mpc.planners import _expand_state

    ts, tc = _build(320, 320, device=cuda)
    fn = make_step_fn(tc, StepConfig(), device=cuda)
    assert fn.path == "cuda_kernel"
    state = ts if n_batch == 1 else _expand_state(ts, n_batch)
    takes = gcc.takes_wide(n_batch, 320, 320, 1, 0, 320,
                           gcc.wide_capacity())
    assert takes is (n_batch == 256)
    telemetry.reset()
    out = fn(state)
    torch.cuda.synchronize()
    assert telemetry.launches("cloth_substep") == 5
    assert _wide_launches() == (5 if takes else 0)
    assert torch.isfinite(out.particles.x).all()


def test_mppi_update_kernel_route_matches_stencil_route_on_card(cuda):
    """One MPPI update with fed noise on ``bench.py --mpc``'s scene at
    32×32, K 16, h 3, its cost plus the free corner's distance to the
    target each step (``bench.py``'s cost reads only what the command sets,
    never the kernel's output): the kernel route on the card against the
    stencil route on the CPU, costs within 1e-5 relative, the nominal and
    every rollout's final positions within 1e-5."""
    import bench_torch
    from positionbaseddynamics_tpu_torch import mpc

    k, hz = 16, 3
    sk, seq_k, mcfg = bench_torch.make_mpc(k, hz, cuda, free_weight=0.1)
    sp, seq_p, _ = bench_torch.make_mpc(k, hz, torch.device("cpu"),
                                        free_weight=0.1)
    assert seq_k.path == "cuda_kernel" and seq_p.path == "torch_stencil"
    gen = torch.Generator(device="cpu").manual_seed(5)
    eps = mcfg.sigma * torch.randn((k, hz, 3), generator=gen)
    nominal = 0.3 * torch.randn((hz, 3), generator=gen)
    before = telemetry.launches("cloth_substep")
    nk, ck = mpc.mppi_update(sk, nominal.to(cuda), seq_k, mcfg,
                             eps=eps.to(cuda))
    assert telemetry.launches("cloth_substep") - before == hz * 2
    npl, cpl = mpc.mppi_update(sp, nominal, seq_p, mcfg, eps=eps)
    assert ((ck.cpu() - cpl).abs().max() / cpl.abs().max()).item() <= 1e-5
    assert (nk.cpu() - npl).abs().max().item() <= 1e-5
    _, fk = seq_k(sk, (nominal + eps).to(cuda))
    _, fp = seq_p(sp, nominal + eps)
    xk, xp = fk.particles.x.cpu(), fp.particles.x
    assert xk.shape == (k, 32 * 32, 3)
    assert (xk - xp).abs().max().item() <= 1e-5


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
# agree to no tolerance. The grids smaller than one of the kernel's vertex
# boxes, 21x11x45 (a depth past the bar's 36) and 17x19x9 (sides that are
# no multiple of a box side) reach the boxes' clipped edges.
@pytest.mark.parametrize("dims,iters,damping,stiffness,steps", [
    ((13, 7, 5), 1, 0.0, 1e5, 10), ((13, 7, 5), 5, 0.01, 1e5, 4),
    ((9, 4, 6), 2, 0.0, 1e5, 3), ((13, 7, 5), 1, 0.0, 0.0, 10),
    ((21, 11, 45), 1, 0.0, 1e5, 10), ((17, 19, 9), 3, 0.01, 1e5, 4)],
    ids=["13x7x5", "13x7x5_it5_damped", "9x4x6_it2", "stiffness0",
         "21x11x45", "17x19x9_it3_damped"])
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
    before = telemetry.launches("tet_substep")
    out = fn(fn(ts))
    # one launch per iteration of each substep, over two steps
    assert (telemetry.launches("tet_substep") - before
            == 2 * cfg.substeps * iters)
    ref = make_step_fn(tc.to("cpu"), cfg, device="cpu")
    cpu = ref(ref(ts.to("cpu")))
    for f in ("x", "v", "old_x", "last_x"):
        dev = getattr(out.particles, f).cpu() - getattr(cpu.particles, f)
        tol = 1e-5 if f != "v" else 2e-5 / 1e-3
        assert dev.abs().max().item() <= tol, f
    assert out.time.item() == cpu.time.item()


@pytest.mark.parametrize("iters", [1, 3])
def test_tet_kernel_leaves_its_inputs_on_card(cuda, iters):
    """A substep writes fresh buffers, leaves its inputs as they were, and
    refuses what it does not take without launching."""
    ts, tc = _bar((17, 19, 9), cuda)
    g, p = tc.grid_tets[0], ts.particles
    dims = (g.width, g.height, g.depth)
    params = gtc.kernel_params(g, h=1e-3)
    w, ic = p.inv_mass.contiguous(), g.inv_cnt.reshape(-1).contiguous()
    xp, vp = gtc.to_planes(p.x), gtc.to_planes(p.v)
    x0, v0, w0, ic0 = xp.clone(), vp.clone(), w.clone(), ic.clone()
    before = telemetry.launches("tet_substep")
    xo, vo = gtc.tet_substep_cuda(xp, vp, w, ic, params, dims, iters)
    torch.cuda.synchronize()
    assert telemetry.launches("tet_substep") - before == iters
    ptrs = {t.data_ptr() for t in (xp, vp, w, ic)}
    assert xo.data_ptr() not in ptrs and vo.data_ptr() not in ptrs
    for t, t0 in ((xp, x0), (vp, v0), (w, w0), (ic, ic0)):
        assert torch.equal(t, t0)
    assert not torch.equal(xo, xp) and not torch.equal(vo, vp)
    xr, vr = gtc.tet_substep_reference(g, p.x, p.v, p.inv_mass, h=1e-3,
                                       max_iterations=iters)
    assert (gtc.from_planes(xo) - xr).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="inv_cnt"):
        gtc.tet_substep_cuda(xp, vp, w, ic[:-1], params, dims, iters)
    with pytest.raises(ValueError, match="x"):
        gtc.tet_substep_cuda(xp, vp, w, ic, params, (17, 19, 8), iters)
    assert telemetry.launches("tet_substep") - before == iters


def _fluid_dam(device, block=(12, 10, 8), hi=(1.4, 1.1, 0.5), cap=12,
               squeeze=0.85, boundary=True, extra=()):
    """A small dam with positions squeezed below the lattice spacing and
    jittered (seeded), so every pass does work, plus the particles
    ``extra`` as they are; its tables and seeded velocities."""
    import numpy as np

    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    d = 0.05
    fluid = fm.block_positions((d, d, d), block, d)
    bnd = (fm.box_boundary((0, 0, 0), hi, d) if boundary
           else np.zeros((0, 3), np.float32))
    rng = np.random.default_rng(11)
    x = (d + squeeze * (fluid - d) + rng.uniform(-0.0075, 0.0075, fluid.shape)
         - np.float32([0.0, 0.01, 0.0])).astype(np.float32)
    x = np.concatenate([x, np.asarray(extra, np.float32).reshape(-1, 3)])
    scene = fm.FluidScene.create(len(x), bnd, cap_per_cell=cap,
                                 domain=((0, 0, 0), hi), device=device)
    tables = fcg.build_fluid_tables(scene.cellgrid,
                                    torch.tensor(x, device=device), scene.mass)
    v = torch.tensor(rng.normal(0, 0.5, x.shape).astype(np.float32),
                     device=device)
    return scene, tables, v


def _kernel_edges(scene, tables, stage=None):
    """Which edges of B3, B4 and B5's design the tables reach: cells of
    more than 32 particles (several lane rounds), cells of one particle (32
    lanes on it), such a cell whose neighbourhood holds no other fluid (B5
    walks no pair for it) and one whose neighbourhood holds boundary
    candidates besides, and, given ``stage`` (the fluid and boundary
    candidates a warp stages at once), a neighbourhood that holds more."""
    from chip_smoke import neighbourhood_counts

    _, _, _, mt, active, nbr, nbr_ok, _ = tables
    own, fluid, bnd = neighbourhood_counts(scene.cellgrid, mt, active, nbr,
                                           nbr_ok)
    out = {"over_32": bool((own > 32).any()),
           "single": bool((own == 1).any()),
           "alone": bool(((own == 1) & (fluid == 1)).any()),
           "boundary_only": bool(((own == 1) & (fluid == 1)
                                  & (bnd > 0)).any())}
    if stage is not None:
        out["fluid_chunks"] = bool((fluid > stage[0]).any())
        out["boundary_chunks"] = bool((bnd > stage[1]).any())
    return out


_CAP40 = {"block": (6, 8, 6), "hi": (1.2, 0.5, 0.4), "cap": 40,
          "squeeze": 0.61}
# name: (arguments of _fluid_dam, the kernel edges its tables must reach)
PBF_CASES = {
    "12x10x8": ({}, ("fluid_chunks", "boundary_chunks")),
    "cap40": (_CAP40, ("fluid_chunks", "over_32")),
    "no_boundary": ({"boundary": False}, ("fluid_chunks",)),
    # two full fluid chunks in the densest neighbourhoods, cells of 40
    "cap40_chunks": ({"block": (8, 8, 8), "hi": (1.2, 0.6, 0.5), "cap": 40,
                      "squeeze": 0.6}, ("fluid_chunks", "over_32")),
    # lone particles on the floor, by a wall and in the open beside the
    # squeezed block
    "lone_particles": (dict(_CAP40, extra=((1.0, 0.04, 0.2),
                                           (1.15, 0.3, 0.2),
                                           (0.7, 0.3, 0.2))),
                       ("single", "alone", "boundary_only", "over_32")),
}


@pytest.mark.parametrize("name", list(PBF_CASES))
def test_pbf_card_cases_reach_the_kernel_edges(name):
    """On the CPU: no particle or cell is crowded out of each card case's
    tables, and they reach the edges it is there for that do not depend on
    the staging sizes (the card test checks the rest with the sizes of the
    built kernel)."""
    kw, edges = PBF_CASES[name]
    scene, tables, _ = _fluid_dam("cpu", **kw)
    assert int(tables[-1]) == 0
    reached = _kernel_edges(scene, tables)
    assert all(reached[e] for e in edges if e in reached), reached


# ρ within 1e-5 relative and Δx, Δv within 1e-6: the kernels add each
# cell's terms in another order than torch.sum and contract into FMAs;
# their pair sets equal the plain versions' exactly.
@pytest.mark.parametrize("name", list(PBF_CASES))
def test_pbf_kernels_match_plain_versions_on_card(cuda, name):
    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc

    kw, edges = PBF_CASES[name]
    scene, tables, v = _fluid_dam(cuda, **kw)
    slot, kept, xt, mt, active, nbr, nbr_ok, ov = tables
    reached = _kernel_edges(scene, tables, fcc.stage_capacity())
    assert all(reached[e] for e in edges), reached
    spec, d0, h = scene.cellgrid, scene.density0, scene.support_radius
    count = fcg.occupied_count(mt)
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
    # rows outside `active` are left as they were, and a second launch
    # gives the same bits (sums in a fixed order)
    lam_s, dens_s = (torch.full_like(mt, float("nan")),
                     torch.full_like(mt, float("nan")))
    fcc.density_lambda_cuda(spec, xt, xt, mt, count, active, nbr, nbr_ok,
                            lam_s, dens_s, params)
    outside = torch.ones(mt.shape[0], dtype=torch.bool, device=cuda)
    outside[act] = False
    assert torch.isnan(lam_s[outside]).all()
    assert torch.isnan(dens_s[outside]).all()
    assert torch.equal(lam_s[act], lam_t[act])
    assert torch.equal(dens_s[act], dens_t[act])

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
    # B5 leaves the rows outside `active` as they were, and a second launch
    # gives the same bits
    v_s = torch.full_like(vt, float("nan"))
    fcc.xsph_cuda(spec, x_out, xt, vt, mt, count, dens_t, active, nbr,
                  nbr_ok, v_s, params)
    assert torch.isnan(v_s[:, outside]).all()
    assert torch.equal(v_s[:, act], v_out[:, act])


def test_pbf_kernels_refuse_what_they_do_not_take(cuda):
    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc

    scene, (_, _, xt, mt, active, nbr, nbr_ok, _), _ = _fluid_dam(cuda)
    spec = scene.cellgrid
    count = fcg.occupied_count(mt)
    params = fcc.kernel_params(scene.density0, scene.support_radius)
    lam_t, dens_t = torch.zeros_like(mt), torch.zeros_like(mt)
    before = telemetry.launches("pbf_density_lambda")
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
    assert telemetry.launches("pbf_density_lambda") == before


def test_fluid_step_fn_takes_the_kernels_on_card(cuda):
    """5 density and 5 correction launches and one XSPH launch a step, and
    the same trajectory as the plain step on the CPU."""
    import numpy as np

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
    kernels = ("pbf_density_lambda", "pbf_corrections", "pbf_xsph")
    before = [telemetry.launches(k) for k in kernels]
    for _ in range(5):
        s, r = fn(s), ref(r)
    assert [telemetry.launches(k) - b for k, b in zip(kernels, before)] == [25, 25, 5]
    assert s.overflow.item() == 0.0 and r.overflow.item() == 0.0
    assert np.isfinite(s.x.cpu().numpy()).all()
    assert (s.x.cpu() - r.x).abs().max().item() <= 1e-4
    assert abs(s.time.item() - r.time.item()) <= 1e-5 * r.time.item()


# ---------------------------------------------------------------------------
# Collision (no kernel of the port on its path: plain PyTorch on the card)
# ---------------------------------------------------------------------------


def _pile(device, n=12):
    import bench_torch

    return bench_torch.pile_scene(n, device)


def test_pile_step_on_card_matches_cpu(cuda):
    """The batched broad phase on a 12-body pile: 20 steps on the card
    against the port on the CPU within 1e-4 (``BASELINE.md``'s end-to-end
    bar), the same active contact count each step, overflow 0."""
    ts, tc, tp = _pile(cuda)
    cs, cc, cp = _pile(torch.device("cpu"))
    fn = make_step_fn(tc, StepConfig(), device=cuda, pipeline=tp)
    ref = make_step_fn(cc, StepConfig(), device="cpu", pipeline=cp)
    for _ in range(20):
        na = int(tp.detect_rigid(ts.rigid).mask.sum().item())
        nb = int(cp.detect_rigid(cs.rigid).mask.sum().item())
        assert na == nb
        ts, cs = fn(ts), ref(cs)
    assert (ts.rigid.x.cpu() - cs.rigid.x).abs().max().item() <= 1e-4
    assert ts.overflow.item() == 0.0


def test_collision_step_never_syncs_the_host(cuda):
    """One step of the pile and one of the two bars (particle–tet
    contacts) under CUDA's sync debug mode "error", after a warm-up
    step."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder as B

    def bars():
        b = B()
        bottom = b.add_regular_tet_model(6, 2, 2, scale=(1.2, 0.25, 0.4))
        for i in range(bottom.mesh.n_vertices):
            b.set_mass(bottom.offset + i, 0.0)
        top = b.add_regular_tet_model(6, 2, 2, translation=(0.05, 0.2, 0.0),
                                      scale=(1.0, 0.25, 0.3))
        b.add_solid_constraints(top, method=3, stiffness=1e5)
        for h in (bottom, top):
            b.set_particle_collider(h, restitution=0.0)
            b.set_tet_collider(h, restitution=0.0, grid_resolution=16)
        state, cset = b.build(device=cuda)
        return state, cset, b.build_collision_pipeline(device=cuda)

    for state, cset, pipe in (_pile(cuda), bars()):
        fn = make_step_fn(cset, StepConfig(), device=cuda, pipeline=pipe)
        state = fn(state)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = fn(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(state.particles.x).all()


def test_pile_rollouts_on_card_equal_each_alone(cuda):
    """K 3 rollouts of the pile with their own start velocities as one
    batched state, against each alone, 10 steps: within 1e-6."""
    import dataclasses

    from positionbaseddynamics_tpu_torch.mpc.planners import _expand_state

    ts, tc, tp = _pile(cuda)
    fn = make_step_fn(tc, StepConfig(), device=cuda, pipeline=tp)
    g = torch.Generator(device=cuda).manual_seed(0)
    kick = 0.5 * torch.randn((3,) + tuple(ts.rigid.v.shape), generator=g,
                             device=cuda)
    batch = _expand_state(ts, 3)
    batch = dataclasses.replace(batch, rigid=dataclasses.replace(
        batch.rigid, v=batch.rigid.v + kick))
    alone = [dataclasses.replace(ts, rigid=dataclasses.replace(
        ts.rigid, v=ts.rigid.v + kick[k])) for k in range(3)]
    for _ in range(10):
        batch = fn(batch)
        alone = [fn(a) for a in alone]
    for k in range(3):
        assert (batch.rigid.x[k] - alone[k].rigid.x).abs().max().item() \
            <= 1e-6


# ---------------------------------------------------------------------------
# B2 at a rollout axis (fault C-1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("own_w", [False, True], ids=["shared_w", "own_w"])
def test_tet_kernel_at_3_rollouts_on_card(cuda, own_w):
    """B2 with the rollout a launch-grid dimension on a 13×7×5 bar, K 3
    seeded jittered rollouts (inverse masses shared, or each rollout's
    own): 5 steps against the plain version within 1e-5, each rollout bit
    for bit equal to itself launched alone, and ``make_step_fn`` on the
    batched state takes the kernel, one launch per substep."""
    ts, tc = _bar((13, 7, 5), cuda)
    g, p = tc.grid_tets[0], ts.particles
    dims = (g.width, g.height, g.depth)
    params = gtc.kernel_params(g, h=1e-3)
    ic = g.inv_cnt.reshape(-1).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(3)
    free = (p.inv_mass > 0)[:, None]
    x0 = p.x + torch.where(free, 0.01 * torch.randn(
        (3,) + tuple(p.x.shape), generator=gen, device=cuda), 0.0)
    w = (torch.stack([p.inv_mass, 0.5 * p.inv_mass, 2.0 * p.inv_mass])
         if own_w else p.inv_mass).contiguous()

    def steps(x, ww, n=5):
        xp, vp = gtc.to_planes(x), gtc.to_planes(torch.zeros_like(x))
        xp, vp, _, _ = gtc.run_substeps(xp, vp, ww, ic, params, dims, 1,
                                        5 * n)
        return gtc.from_planes(xp, x.shape[:-2])

    x = steps(x0, w)
    xr, vr = x0, torch.zeros_like(x0)
    for _ in range(25):
        xr, vr = gtc.tet_substep_reference(
            g, xr, vr, w if own_w else p.inv_mass, h=1e-3)
    assert (x - xr).abs().max().item() <= 1e-5
    for k in range(3):
        assert torch.equal(steps(x0[k], w[k] if own_w else w), x[k])
    if not own_w:
        import dataclasses

        fn = make_step_fn(tc, StepConfig(), device=cuda)
        batched = dataclasses.replace(ts, particles=dataclasses.replace(
            p, x=x0, v=torch.zeros_like(x0), old_x=x0.clone(),
            last_x=x0.clone()))
        before = telemetry.launches("tet_substep")
        out = fn(batched)
        assert fn.path == "cuda_kernel"
        assert telemetry.launches("tet_substep") - before == 5
        ref = make_step_fn(tc.to("cpu"), StepConfig(), device="cpu")
        cpu = ref(batched.to("cpu"))
        assert (out.particles.x.cpu() - cpu.particles.x).abs().max() <= 1e-5


# ---------------------------------------------------------------------------
# B2's multi-substep mode: one cooperative launch a step
# ---------------------------------------------------------------------------


# the steps stop before the reference's own breakdown past one iteration
# (see the 5-iteration case above); 21x11x45 and 17x19x9 reach the boxes'
# clipped edges, and 9 rollouts of 21x11x45 (288 items) are more items
# than an H100 holds blocks at once (264), so blocks take several a pass
@pytest.mark.parametrize("dims,iters,damping,k,steps", [
    ((13, 7, 5), 1, 0.0, 1, 10), ((13, 7, 5), 2, 0.01, 1, 4),
    ((17, 19, 9), 3, 0.01, 1, 4), ((21, 11, 45), 1, 0.0, 9, 5),
    ((17, 19, 9), 2, 0.0, 3, 4)],
    ids=["13x7x5", "13x7x5_it2_damped", "17x19x9_it3_damped",
         "21x11x45_k9", "17x19x9_it2_k3"])
def test_tet_fused_equals_per_iteration_on_card(cuda, dims, iters, damping,
                                                k, steps):
    """The multi-substep launch against the per-iteration launches, bit for
    bit in x and v, one launch a step, and against the plain version
    within 1e-5; rollout r starts at rest with its free vertices moving at
    (0, −0.1 r, 0.05 r) m/s, as ``chip_smoke.py``'s rollouts do."""
    ts, tc = _bar(dims, cuda)
    g, p = tc.grid_tets[0], ts.particles
    dims = (g.width, g.height, g.depth)
    params = gtc.kernel_params(g, h=1e-3, damping=damping)
    ic = g.inv_cnt.reshape(-1).contiguous()
    free = (p.inv_mass > 0)[:, None]
    r = torch.arange(k, device=cuda, dtype=torch.float32)
    vel = torch.stack([torch.zeros_like(r), -0.1 * r, 0.05 * r], -1)
    v0 = torch.where(free, vel[:, None, :], 0.0)
    x0 = p.x.expand(k, -1, -1).contiguous()
    if k == 1:
        x0, v0 = x0[0], v0[0]
    w = p.inv_mass.contiguous()
    xf, vf = xs, vs = gtc.to_planes(x0), gtc.to_planes(v0)
    scratch = gtc.FusedScratch()
    before = telemetry.launches("tet_fused")
    for _ in range(steps):
        xf, vf = gtc.tet_fused_cuda(xf, vf, w, ic, params, dims, iters, 5,
                                    scratch)
    xs, vs, _, _ = gtc.run_substeps(xs, vs, w, ic, params, dims, iters,
                                    5 * steps)
    torch.cuda.synchronize()
    assert telemetry.launches("tet_fused") - before == steps
    boxes = -(-dims[0] // 12) * -(-dims[1] // 6) * -(-dims[2] // 6)
    assert 1 <= gtc.tet_fused_cuda.grid <= boxes * k
    assert torch.equal(xf, xs) and torch.equal(vf, vs)
    xr, vr = x0, v0
    for _ in range(5 * steps):
        xr, vr = gtc.tet_substep_reference(g, xr, vr, p.inv_mass, h=1e-3,
                                           max_iterations=iters,
                                           damping=damping)
    lead = () if k == 1 else (k,)
    assert (gtc.from_planes(xf, lead) - xr).abs().max().item() <= 1e-5


def test_tet_fused_leaves_its_inputs_on_card(cuda):
    """A fused launch writes fresh buffers, leaves its inputs as they were,
    reuses its scratch between launches, and refuses what it does not take
    without launching; ``make_tet_step`` launches once a step."""
    ts, tc = _bar((17, 19, 9), cuda)
    g, p = tc.grid_tets[0], ts.particles
    dims = (g.width, g.height, g.depth)
    params = gtc.kernel_params(g, h=1e-3)
    w, ic = p.inv_mass.contiguous(), g.inv_cnt.reshape(-1).contiguous()
    xp, vp = gtc.to_planes(p.x), gtc.to_planes(p.v)
    x0, v0 = xp.clone(), vp.clone()
    scratch = gtc.FusedScratch()
    before = telemetry.launches("tet_fused")
    xo, vo = gtc.tet_fused_cuda(xp, vp, w, ic, params, dims, 2, 5, scratch)
    bufs = scratch.bufs
    xo2, _ = gtc.tet_fused_cuda(xp, vp, w, ic, params, dims, 2, 5, scratch)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(bufs, scratch.bufs))
    assert torch.equal(xo, xo2)
    ptrs = {t.data_ptr() for t in (xp, vp, w, ic)}
    assert xo.data_ptr() not in ptrs and vo.data_ptr() not in ptrs
    assert torch.equal(xp, x0) and torch.equal(vp, v0)
    with pytest.raises(ValueError, match="inv_cnt"):
        gtc.tet_fused_cuda(xp, vp, w, ic[:-1], params, dims, 1, 5)
    with pytest.raises(ValueError, match="substeps"):
        gtc.tet_fused_cuda(xp, vp, w, ic, params, dims, 1, 0)
    assert telemetry.launches("tet_fused") - before == 2
    step = gtc.make_tet_step(g, p.inv_mass, dt=0.005, substeps=5, n_steps=3)
    before = (telemetry.launches("tet_fused"), telemetry.launches("tet_substep"))
    step(p.x, p.v)
    assert (telemetry.launches("tet_fused") - before[0],
            telemetry.launches("tet_substep") - before[1]) == (3, 0)


# ---------------------------------------------------------------------------
# An active particle–rigid contact on the card (fault C-2), and the rods
# (slice 7: no kernel of the port on their path, plain PyTorch on the card)
# ---------------------------------------------------------------------------


def test_cloth_on_sphere_on_card_matches_cpu(cuda):
    """The cloth laid flat over the sphere (``torch_collision_scenes.
    cloth_on_sphere`` at height 0.63, its first contact at step 14): 20
    steps on the card against the CPU within 1e-4, the same active
    particle–rigid row count at every step, rows at the last steps."""
    import numpy as np
    import torch_collision_scenes as scenes

    from positionbaseddynamics_tpu_torch.models import SceneBuilder as B

    def build(dev):
        flat = scenes.FLAT
        b = B()
        tm = b.add_regular_triangle_model(12, 12, translation=(-1.0, 0.63,
                                                               -1.0),
                                          rotation=flat, scale=(2.0, 2.0))
        b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        b.add_bending_constraints(tm, method=3, stiffness=0.05)
        sph = b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
        b.add_collision_sphere(sph, 0.6, restitution=0.0, friction=0.2,
                               verts=np.zeros((1, 3), np.float32))
        b.set_particle_collider(tm, restitution=0.0, friction=0.2)
        state, cset = b.build(device=dev)
        return state, cset, b.build_collision_pipeline(tolerance=0.02,
                                                       device=dev)

    ts, tc, tp = build(cuda)
    cs, cc, cp = build(torch.device("cpu"))
    fn = make_step_fn(tc, StepConfig(), device=cuda, pipeline=tp)
    ref = make_step_fn(cc, StepConfig(), device="cpu", pipeline=cp)
    rows = []
    for _ in range(20):
        na = int(tp.detect_particles(ts.particles.x, ts.particles.v,
                                     ts.particles.inv_mass, ts.rigid)
                 .mask.sum().item())
        nb = int(cp.detect_particles(cs.particles.x, cs.particles.v,
                                     cs.particles.inv_mass, cs.rigid)
                 .mask.sum().item())
        assert na == nb
        rows.append(na)
        ts, cs = fn(ts), ref(cs)
    assert rows[-1] > 0, rows
    assert (ts.particles.x.cpu() - cs.particles.x).abs().max().item() <= 1e-4
    assert ts.overflow.item() == 0.0


def test_rod_rollout_on_card_matches_cpu(cuda):
    """4 lattice rods of ``bench.py --rods``' shape: 10 steps on the card
    against the CPU within 1e-4, a step that never syncs the host."""
    import bench_torch

    ts, tc = bench_torch.rod_scene(4, cuda)
    cs, cc = bench_torch.rod_scene(4, torch.device("cpu"))
    fn = make_step_fn(tc, StepConfig(), device=cuda)
    ref = make_step_fn(cc, StepConfig(), device="cpu")
    assert fn.path == "torch_rods" and tc.rod_lattices
    for _ in range(10):
        ts, cs = fn(ts), ref(cs)
    assert (ts.particles.x.cpu() - cs.particles.x).abs().max() <= 1e-4
    assert (ts.orientations.q.cpu() - cs.orientations.q).abs().max() <= 1e-4
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts = fn(ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(ts.particles.x).all()


def test_tree_rollout_on_card_matches_cpu(cuda):
    """A 31-segment random stiff-rod tree on the scheduled elimination: 10
    steps on the card against the CPU within 1e-4, a step that never
    syncs the host."""
    import bench_torch

    ts, tc = bench_torch.tree_scene(31, cuda)
    cs, cc = bench_torch.tree_scene(31, torch.device("cpu"))
    assert tc.direct_rods[0].uses_tree
    fn = make_step_fn(tc, StepConfig(), device=cuda)
    ref = make_step_fn(cc, StepConfig(), device="cpu")
    for _ in range(10):
        ts, cs = fn(ts), ref(cs)
    assert (ts.rigid.x.cpu() - cs.rigid.x).abs().max() <= 1e-4
    assert (ts.rigid.q.cpu() - cs.rigid.q).abs().max() <= 1e-4
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts = fn(ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(ts.rigid.x).all()
