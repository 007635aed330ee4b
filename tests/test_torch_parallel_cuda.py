"""The cloth kernel's fused-substep and row-window modes against their
plain PyTorch versions, and the ``parallel/`` modules at world size 1
through NCCL, on the card.

These tests import only torch and the port, so they run on a machine with
the card (``python -m pytest tests/test_torch_parallel_cuda.py``); without
a CUDA device they skip, since the kernel has no CPU mode. Bars: 1e-5
against the plain versions over 5 steps, the repo's kernel-against-stencil
bar (``bench.py --check``; the kernel contracts products into FMAs where
the plain version rounds each); the fused kernel against the per-substep
kernel x 2e-6 and v 2e-4, JAX's bar for its fused kernel against its
per-substep one (``tests/test_grid_cloth_pallas.py:80-103``); windows
stitched together against the unsharded fused kernel 1e-6, the JAX
package's bar for its sharded kernel (``tests/test_intra_sharding.py``)."""
import pytest
import torch
import torch.distributed as dist

from positionbaseddynamics_tpu_torch import parallel as par
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
from positionbaseddynamics_tpu_torch.solver.grid_window import (
    window_substeps_reference)
from positionbaseddynamics_tpu_torch.utils import telemetry


DT = 0.005


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


def _steps(g, w, substeps, iters, fuse, n_batch=1, **kw):
    return gcc.make_cloth_step(
        g, w, g.inv_cnt_dist, g.inv_cnt_bend, dt=DT, substeps=substeps,
        max_iterations=iters, damping=0.01, n_batch=n_batch, n_steps=5,
        fuse_substeps=fuse, **kw)


# (substeps, iterations): one launch a step at 5 passes, and 3 launches of
# 2, 2 and 1 substeps at two iterations
@pytest.mark.parametrize("substeps,iters,launches", [(5, 1, 1), (3, 1, 1),
                                                     (5, 2, 3)])
@pytest.mark.parametrize("n_batch", [1, 3])
def test_fused_kernel_matches_plain_and_per_substep_on_card(
        cuda, substeps, iters, launches, n_batch):
    ts, tc = _build(40, 37, cuda)
    g, p = tc.grid_cloths[0], ts.particles
    x = p.x.expand(n_batch, *p.x.shape).clone()
    x[-1] += 0.01 * torch.sin(x[-1, :, :1] * 3.0)
    x = x if n_batch > 1 else x[0]
    v = torch.zeros_like(x)
    before = telemetry.launches("cloth_fused")
    xf, vf = _steps(g, p.inv_mass, substeps, iters, True, n_batch)(x, v)
    assert telemetry.launches("cloth_fused") - before == 5 * launches
    xs, vs = _steps(g, p.inv_mass, substeps, iters, False, n_batch)(x, v)
    assert (xf - xs).abs().max().item() <= 2e-6
    assert (vf - vs).abs().max().item() <= 2e-4
    xr, vr = x, v
    for _ in range(5 * substeps):
        xr, vr = gcc.cloth_substep_reference(
            g, xr, vr, p.inv_mass, h=DT / substeps, max_iterations=iters,
            damping=0.01)
    assert (xf - xr).abs().max().item() <= 1e-5
    assert torch.equal(xf[..., [0, 39], :], x[..., [0, 39], :])


# the cooperative fused launch against the per-substep launches: 40×37 is
# 6 tiles, so 64 rollouts are 384 items, more than an H100 holds blocks at
# once (264), and blocks take several a pass
@pytest.mark.parametrize("substeps,iters", [(5, 1), (2, 2)],
                         ids=["5x1", "2x2"])
@pytest.mark.parametrize("damping", [0.0, 0.01])
@pytest.mark.parametrize("n_batch", [1, 4, 64])
def test_fused_launch_equals_per_substep_launches_on_card(
        cuda, substeps, iters, damping, n_batch):
    """Over 3 steps, one launch a step, bit for bit in x and v; its grid is
    ``fused_grid``'s, one block an item up to the card's capacity."""
    ts, tc = _build(40, 37, cuda)
    g, p = tc.grid_cloths[0], ts.particles
    x = p.x.expand(n_batch, *p.x.shape).clone()
    x += 0.01 * torch.sin(x[..., :1] * 3.0
                          + torch.arange(n_batch, device=cuda)[:, None, None])
    x[:, [0, 39]] = p.x[[0, 39]]
    v = torch.zeros_like(x)
    if n_batch == 1:
        x, v = x[0], v[0]

    def steps(fuse):
        return gcc.make_cloth_step(
            g, p.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend, dt=DT,
            substeps=substeps, max_iterations=iters, damping=damping,
            n_batch=n_batch, n_steps=3, fuse_substeps=fuse)

    before = telemetry.launches("cloth_fused")
    xf, vf = steps(True)(x, v)
    assert telemetry.launches("cloth_fused") - before == 3
    xs, vs = steps(False)(x, v)
    torch.cuda.synchronize()
    assert torch.equal(xf, xs) and torch.equal(vf, vs)
    assert (xf - x).abs().max().item() > 1e-4
    assert gcc.cloth_fused_cuda.grid == gcc.fused_grid(
        n_batch, 37, 40, gcc.fused_capacity())


def test_fused_launch_leaves_its_inputs_on_card(cuda):
    """A fused launch writes fresh buffers, leaves its inputs as they were,
    keeps its scratch between launches (the same result from the same
    input), and reports the runtime's resources of its kernel."""
    ts, tc = _build(40, 37, cuda)
    g, p = tc.grid_cloths[0], ts.particles
    params = gcc.kernel_params(g, h=DT / 2, damping=0.01)
    w = p.inv_mass.reshape(37, 40)
    icd = g.inv_cnt_dist.reshape(37, 40).contiguous()
    icb = g.inv_cnt_bend.reshape(37, 40).contiguous()
    xp = gcc.to_planes(torch.stack([p.x, p.x + 0.01]), 37, 40)
    vp = torch.rand_like(xp)
    x0, v0 = xp.clone(), vp.clone()
    scratch = gcc.FusedScratch()
    xo, vo = gcc.cloth_fused_cuda(xp, vp, w, icd, icb, params, 2, 2, scratch)
    bufs = dict(scratch.bufs)
    xo2, vo2 = gcc.cloth_fused_cuda(xp, vp, w, icd, icb, params, 2, 2,
                                    scratch)
    torch.cuda.synchronize()
    assert all(scratch.bufs[k] is t for k, t in bufs.items())
    assert torch.equal(xo, xo2) and torch.equal(vo, vo2)
    ptrs = {t.data_ptr() for t in (xp, vp, w, icd, icb)}
    assert xo.data_ptr() not in ptrs and vo.data_ptr() not in ptrs
    assert torch.equal(xp, x0) and torch.equal(vp, v0)
    res = gcc.kernel_resources(fused=True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert res["threads"] == 864 and res["blocks_per_sm"] >= 1
    assert gcc.fused_capacity() == res["blocks_per_sm"] * sms


# windows at the grid's top (row_offset < 0), at its bottom and inside
# it, at one iteration and at two (the anchors just beyond a window's inner
# edge carry λ between passes)
@pytest.mark.parametrize("off,iters", [(-8, 1), (22, 1), (6, 1), (-8, 2),
                                       (22, 2)])
def test_row_windows_at_the_edges_on_card(cuda, off, iters):
    """A window of 26 rows of a 40-row cloth at ``off``: the fused window
    launch equals the per-substep launches of the same window bit for
    bit, its plain version within 1e-5, and the unsharded fused step on
    the rows more than the step's reach (3·iterations·substeps) from the
    window's inner edges, within 1e-6."""
    ts, tc = _build(32, 40, cuda)
    g, p = tc.grid_cloths[0], ts.particles
    h, w, rows, sub = g.height, g.width, 26, 2
    params = gcc.kernel_params(g, h=DT / sub)
    planes = [a.reshape(h, w, 1) for a in (p.inv_mass, g.inv_cnt_dist,
                                           g.inv_cnt_bend)]
    xg = p.x.reshape(h, w, 3) + 0.01 * torch.sin(
        torch.arange(h * w, device=cuda, dtype=torch.float32)).reshape(
            h, w, 1)
    xg[0] = p.x.reshape(h, w, 3)[0]
    vg = torch.zeros_like(xg)
    we, icde, icbe = (_cut(a, off, rows, h).contiguous() for a in planes)
    xe, ve = _cut(xg, off, rows, h), _cut(vg, off, rows, h)
    xp, vp = gcc.to_planes(xe, rows, w), gcc.to_planes(ve, rows, w)
    args = (we[..., 0], icde[..., 0], icbe[..., 0], params)
    xk, vk = gcc.cloth_window_cuda(xp, vp, *args, iters, sub, off, h)
    xs, vs = xp, vp
    for _ in range(sub):
        xs, vs = gcc.cloth_substep_cuda(xs, vs, *args, iters, off, h)
    torch.cuda.synchronize()
    assert torch.equal(xk, xs) and torch.equal(vk, vs)
    xk = xk.permute(0, 2, 3, 1)[0]
    xr, _ = window_substeps_reference(params, xe, ve, we, icde, icbe,
                                      row_offset=off, global_height=h,
                                      max_iterations=iters, n=sub)
    assert (xk - xr).abs().max().item() <= 1e-5
    full = gcc.make_cloth_step(g, p.inv_mass, g.inv_cnt_dist,
                               g.inv_cnt_bend, dt=DT, substeps=sub,
                               max_iterations=iters, fuse_substeps=True)
    xu = full(xg.reshape(-1, 3), vg.reshape(-1, 3))[0].reshape(h, w, 3)
    reach = 3 * iters * sub
    lo = max(off, 0) if off <= 0 else off + reach
    hi = min(off + rows, h) if off + rows >= h else off + rows - reach
    assert hi - lo >= 4, (lo, hi)
    assert (xk[lo - off:hi - off] - xu[lo:hi]).abs().max().item() <= 1e-6


def _cut(a, off, rows, h):
    """Rows ``off .. off + rows`` of ``a`` (..., h, W, k), zeros beyond."""
    out = a.new_zeros(a.shape[:-3] + (rows,) + a.shape[-2:])
    lo, hi = max(off, 0), min(off + rows, h)
    out[..., lo - off:hi - off, :, :] = a[..., lo:hi, :, :]
    return out


def test_window_kernel_matches_plain_and_stitches_on_card(cuda):
    """Four windows of 10 + 2·8 rows of a 40-row cloth at offsets
    10r − 8, each stepped by the fused window kernel (2 substeps a step),
    re-cut from the stitched rows after every step: the window against
    its plain version, and the kept rows against the unsharded fused
    kernel, over 5 steps."""
    ts, tc = _build(32, 40, cuda)
    g, p = tc.grid_cloths[0], ts.particles
    h, w = g.height, g.width
    r_loc, exch, sub = 10, 8, 2
    params = gcc.kernel_params(g, h=DT / sub)
    planes = {"w": p.inv_mass.reshape(h, w, 1),
              "icd": g.inv_cnt_dist.reshape(h, w, 1),
              "icb": g.inv_cnt_bend.reshape(h, w, 1)}
    full = gcc.make_cloth_step(g, p.inv_mass, g.inv_cnt_dist,
                               g.inv_cnt_bend, dt=DT, substeps=sub,
                               fuse_substeps=True)
    xg, vg = p.x.reshape(h, w, 3), p.v.reshape(h, w, 3)
    xu, vu = p.x, p.v
    before = telemetry.launches("cloth_window")
    for _ in range(5):
        kept_x, kept_v = [], []
        for r in range(h // r_loc):
            off = r * r_loc - exch
            cut = {k: _cut(a, off, r_loc + 2 * exch, h).contiguous()
                   for k, a in planes.items()}
            xe, ve = _cut(xg, off, r_loc + 2 * exch, h), _cut(
                vg, off, r_loc + 2 * exch, h)
            xk, vk = gcc.cloth_window_cuda(
                gcc.to_planes(xe, r_loc + 2 * exch, w),
                gcc.to_planes(ve, r_loc + 2 * exch, w), cut["w"][..., 0],
                cut["icd"][..., 0], cut["icb"][..., 0], params, 1, sub, off,
                h)
            xk, vk = xk.permute(0, 2, 3, 1)[0], vk.permute(0, 2, 3, 1)[0]
            xr, _ = window_substeps_reference(
                params, xe, ve, cut["w"], cut["icd"], cut["icb"],
                row_offset=off, global_height=h, n=sub)
            assert (xk - xr).abs().max().item() <= 1e-5
            kept_x.append(xk[exch:exch + r_loc])
            kept_v.append(vk[exch:exch + r_loc])
        xg, vg = torch.cat(kept_x), torch.cat(kept_v)
        xu, vu = full(xu, vu)
    assert telemetry.launches("cloth_window") - before == 5 * 4
    assert (xg.reshape(-1, 3) - xu).abs().max().item() <= 1e-6
    assert (xu - p.x).abs().max().item() > 1e-3


@pytest.fixture
def nccl_world_1(cuda):
    """A one-rank NCCL group in this process (an in-process HashStore)."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield par.make_group(device=cuda)
    finally:
        dist.destroy_process_group()


def test_modules_at_world_size_one_on_card(cuda, nccl_world_1):
    group = nccl_world_1
    ts, tc = _build(48, 48, cuda)
    g, p = tc.grid_cloths[0], ts.particles
    cfg = StepConfig(dt=DT, substeps=5)
    # intra_cuda against make_cloth_step(fuse_substeps=True)
    fn = par.make_cuda_intra_step_fn(g, p.inv_mass, cfg, group)
    ref = gcc.make_cloth_step(g, p.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend,
                              dt=DT, substeps=5, fuse_substeps=True)
    before = telemetry.launches("cloth_window")
    x, v, xr, vr = p.x, p.v, p.x, p.v
    for _ in range(5):
        x, v = fn(x, v)
        xr, vr = ref(xr, vr)
    assert telemetry.launches("cloth_window") - before == 5
    assert (x - xr).abs().max().item() <= 1e-6
    # intra_grid against make_step_fn's structured route
    fn = par.make_grid_intra_step_fn(g, p.inv_mass, cfg, group)
    step = make_step_fn(tc, cfg)
    x, v, st = p.x, p.v, ts
    for _ in range(5):
        x, v = fn(x, v)
        st = step(st)
    assert (x - st.particles.x).abs().max().item() <= 2e-5
    # the rollout shard at world size 1 is the batched step itself
    batch = par.replicate_scene(ts, 4)
    sharded = par.make_sharded_step_fn(tc, cfg, group)
    out = par.gather_batch(sharded(par.shard_batch(batch, group)), group)
    assert torch.equal(out.particles.x, step(batch).particles.x)
