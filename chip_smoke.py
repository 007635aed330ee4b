#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. the card: its name, and its power limit as ``nvidia-smi`` reports it;
2. build every CUDA kernel of the port from ``csrc/`` (``nvcc``, sm_90a);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: the fused cloth substep at 320×320 over
   10 steps (single rollout and 4 rollouts), and on a 67×53 grid with 3
   iterations and damping and with 6 iterations (two launches a substep);
   the fused tet substep on the 80×36×36 bench bar over 10 steps, at 5
   iterations on the bar and on a 13×7×5 grid with damping, and at
   stiffness 0;
4. the main paths through the public entry points, each with every
   kernel's launch count set to 0 just before it and read just after:
   the 320×320 bench cloth and the 80×36×36 bench bar, each built by
   ``SceneBuilder`` on the card, ``make_step_fn`` → 200 steps; then each
   path's steps/s and the card's busy share;
5. timings: each kernel per launch beside its plain version and its
   bound, and ``make_cloth_step`` at 1 and 4 rollouts in steps/s.

Every steps/s figure is the median of ``N_WINDOWS`` windows of at least
``WINDOW_S`` seconds on the host clock, printed with the lowest and the
highest window.

Prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
GRID = 320                      # the bench cloth (bench.py defaults)
BAR = (80, 36, 36)              # the bench bar (bench.py --bar defaults)
STEPS_MAIN = 200
CHECK_TOL = 1e-5                # bench.py --check bar, kernel vs plain
BATCH_TOL = 1e-6                # a batch's rollout vs the single rollout
WINDOW_S = 1.0                  # least length of one timed window
N_WINDOWS = 5                   # timed windows per rate

# fp32 operations of one particle per substep, counted from
# csrc/grid_cloth_step.cu: integrate 12; per iteration, per anchor, the 3
# distance solves 3 x 24 and the 3 bending solves 3 x 50, the distance
# gather 8 terms x 3 components x 2 plus 6 and the bending gather 20 terms
# x 7 plus 6; velocity update and damping 9. Halo cells that a block
# recomputes are not counted: they are not work the function needs.
FLOPS_FIXED = 12 + 9
FLOPS_PER_ITERATION = 3 * 24 + 3 * 50 + 8 * 3 * 2 + 6 + 20 * 7 + 6

# fp32 operations of the tet substep, counted from csrc/grid_tet_step.cu
# (solve_tet): per tet and iteration, edge vectors 9, F 45, strain 39,
# trace 2 + 1, stress input 12, stress 45, energy 17 + 4 + 1, gradients
# 63, C 3, denominator 30, delta-lambda 11, corrections 28; per cell and
# iteration the vertex pass adds each of its 24 sums once; per vertex and
# iteration x + inv_cnt * dx, 6; per vertex and substep the integration 12
# and the velocity update 6. Integrations that a cell pass repeats for
# the corners it reads are not counted: they are not work the function
# needs.
TET_FLOPS_PER_TET = 9 + 45 + 39 + 3 + 12 + 45 + 22 + 63 + 3 + 30 + 11 + 28
TET_FLOPS_PER_CELL = 5 * TET_FLOPS_PER_TET + 24
TET_FLOPS_PER_VERTEX = 6
TET_FLOPS_FIXED = 12 + 6


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cloth_scene(width, height, device):
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    b = SceneBuilder()
    tm = b.add_regular_triangle_model(width, height, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + width - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(device=device)


def kernel_counters():
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    return {"cloth_substep": gcc.cloth_substep_cuda,
            "tet_substep": gtc.tet_substep_cuda}


def reset_counts():
    for wrapper in kernel_counters().values():
        wrapper.launches = 0


def read_counts():
    return {k: w.launches for k, w in kernel_counters().items()}


def plain_steps(gc, x, v, inv_mass, n_sub, h, **kw):
    from positionbaseddynamics_tpu_torch.solver.grid_cloth_cuda import (
        cloth_substep_reference)

    for _ in range(n_sub):
        x, v = cloth_substep_reference(gc, x, v, inv_mass, h=h, **kw)
    return x, v


def max_dev(a, b) -> float:
    return (a - b).abs().max().item()


def check_kernel_against_plain(dev):
    """Phase 3: the cloth kernel against its plain version. Returns the
    deviation at the main path's shape and the 320x320 plain result."""
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
    from positionbaseddynamics_tpu_torch.solver.grid_cloth_cuda import (
        make_cloth_step)

    h = 0.005 / 5
    state, cset = cloth_scene(GRID, GRID, dev)
    gc, p = cset.grid_cloths[0], state.particles

    def factory(**kw):
        return make_cloth_step(gc, p.inv_mass, gc.inv_cnt_dist,
                               gc.inv_cnt_bend, dt=0.005, substeps=5,
                               n_steps=10, device=dev, **kw)

    x, v = factory()(p.x, p.v)
    xr, vr = plain_steps(gc, p.x, p.v, p.inv_mass, 50, h)
    torch.cuda.synchronize()
    dev320 = max_dev(x, xr)
    log(f"check 320x320 10 steps: max|dx| kernel vs plain = {dev320!r} "
        f"(max|dv| {max_dev(v, vr)!r})")
    assert torch.isfinite(x).all() and torch.isfinite(v).all()
    assert dev320 <= CHECK_TOL, dev320

    xb = torch.stack([p.x] * 4)
    xb[3] += 1e-3
    vb = torch.stack([p.v] * 4)
    xk, _ = factory(n_batch=4)(xb, vb)
    xbr, _ = plain_steps(gc, xb, vb, p.inv_mass, 50, h)
    torch.cuda.synchronize()
    dev_b = max_dev(xk, xbr)
    same = max(max_dev(xk[r], x) for r in range(3))
    moved = max_dev(xk[3], x)
    log(f"check 320x320 x4 rollouts: kernel vs plain {dev_b!r}, "
        f"unperturbed vs single {same!r}, perturbed vs single {moved!r}")
    assert dev_b <= CHECK_TOL, dev_b
    assert same <= BATCH_TOL, same
    assert moved > CHECK_TOL, moved

    s2, c2 = cloth_scene(67, 53, dev)
    g2, p2 = c2.grid_cloths[0], s2.particles
    kw = dict(max_iterations=3, damping=0.01)
    x2, _ = make_cloth_step(g2, p2.inv_mass, g2.inv_cnt_dist,
                            g2.inv_cnt_bend, dt=0.005, substeps=5,
                            n_steps=10, device=dev, **kw)(p2.x, p2.v)
    x2r, _ = plain_steps(g2, p2.x, p2.v, p2.inv_mass, 50, h, **kw)
    torch.cuda.synchronize()
    dev2 = max_dev(x2, x2r)
    log(f"check 67x53, 3 iterations, damping 0.01: kernel vs plain {dev2!r}")
    assert dev2 <= CHECK_TOL, dev2

    # more iterations than one launch holds: each substep takes two
    kw = dict(max_iterations=gcc.FUSED_ITERATIONS + 2)
    before = gcc.cloth_substep_cuda.launches
    x3, _ = make_cloth_step(g2, p2.inv_mass, g2.inv_cnt_dist,
                            g2.inv_cnt_bend, dt=0.005, substeps=5,
                            n_steps=10, device=dev, **kw)(p2.x, p2.v)
    split = gcc.cloth_substep_cuda.launches - before
    x3r, _ = plain_steps(g2, p2.x, p2.v, p2.inv_mass, 50, h, **kw)
    torch.cuda.synchronize()
    dev3 = max_dev(x3, x3r)
    log(f"check 67x53, {kw['max_iterations']} iterations in {split} "
        f"launches: kernel vs plain {dev3!r}")
    assert split == 100, split
    assert dev3 <= CHECK_TOL, dev3
    return max(dev320, dev_b), xr


def run_main_path(dev, x_plain10):
    """Phase 4: SceneBuilder -> make_step_fn -> 200 steps on the card."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    cfg = StepConfig()
    state, cset = cloth_scene(GRID, GRID, dev)
    fn = make_step_fn(cset, cfg)
    log(f"main path: {GRID}x{GRID} cloth, {state.particles.n} particles, "
        f"route {fn.path}")
    assert fn.path == "cuda_kernel", fn.path
    x0 = state.particles.x.clone()

    s10 = state
    for _ in range(10):
        s10 = fn(s10)
    dev10 = max_dev(s10.particles.x, x_plain10)
    log(f"main path 10 steps vs plain version: max|dx| = {dev10!r}")
    assert dev10 <= CHECK_TOL, dev10

    torch.cuda.synchronize()
    reset_counts()
    s = state
    for _ in range(STEPS_MAIN):
        s = fn(s)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["cloth_substep"]
    log(f"main path {GRID}x{GRID} cloth: launch counts {counts}")

    x = s.particles.x
    assert torch.isfinite(x).all() and torch.isfinite(s.particles.v).all()
    pinned = [0, GRID - 1]
    assert torch.equal(x[pinned], x0[pinned]), "pinned corners moved"
    free = GRID * GRID - 1
    fall = (x0[free, 1] - x[free, 1]).item()
    assert fall > 0.1, f"free corner fell only {fall}"
    t_expect = np.float32(0.0)
    for _ in range(STEPS_MAIN):
        t_expect = np.float32(t_expect + np.float32(cfg.dt))
    assert s.time.item() == float(t_expect), (s.time.item(), t_expect)
    assert abs(s.time.item() - STEPS_MAIN * cfg.dt) < 1e-4
    assert launches == STEPS_MAIN * cfg.substeps, launches
    log(f"main path {STEPS_MAIN} steps: launches {launches}, "
        f"free corner fell {fall!r}, time {s.time.item()!r}")

    st = [s]

    def one_step():
        st[0] = fn(st[0])

    rate = rate_windows(one_step, 1)
    assert torch.isfinite(st[0].particles.x).all()
    log(f"main path steps/s: {rate}")

    # device busy share of the main path: kernel time over wall time
    busy = profile_busy(fn, st[0], 400, "main path")
    return launches, rate, busy


def rate_windows(run, units_per_call):
    """Host-clock rate of ``run()`` in units/s: ``N_WINDOWS`` windows of at
    least ``WINDOW_S`` s each, the card synchronised at both ends of each.
    Returns the median, the lowest and highest window, and the shortest
    window's seconds."""
    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 0.2 * WINDOW_S:   # calibrate
        run()
        torch.cuda.synchronize()
        calls += 1
    # a window runs batches of ~1/4 of its length until it is long enough
    batch = max(1, math.ceil(calls * 1.25))
    rates, secs = [], []
    for _ in range(N_WINDOWS):
        torch.cuda.synchronize()
        t0, calls, elapsed = time.perf_counter(), 0, 0.0
        while elapsed < WINDOW_S:
            for _ in range(batch):
                run()
            calls += batch
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        secs.append(elapsed)
        rates.append(calls * units_per_call / elapsed)
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "window_s": min(secs), "windows": N_WINDOWS}


def cuda_time_ms(fn, n):
    """Mean device time of ``fn()`` over ``n`` calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n, kernel_name):
    """Mean device time of the kernel ``kernel_name`` per launch, read from
    ``torch.profiler`` over ``n`` calls of ``fn``; None when the profiler
    records no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def bar_scene(dims, device, stiffness=1e5, scale=(4.0, 1.0, 1.0)):
    """The bench bar (``bench.py::bench_bar``): a regular tet grid with its
    i = 0 face pinned, XPBD FEM tets (method 3), Poisson ratio 0.3."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    w, h, d = dims
    b = SceneBuilder()
    tm = b.add_regular_tet_model(w, h, d, scale=scale)
    for j in range(h):
        for k in range(d):
            b.set_mass(tm.offset + j * d + k, 0.0)
    b.add_solid_constraints(tm, method=3, stiffness=stiffness,
                            poisson_ratio=0.3)
    return b.build(device=device)


def tet_kernel_vs_plain(scene, steps, iters=1, damping=0.0, label=""):
    """``make_tet_step`` one step at a time against the plain version.
    Returns the max|dx| after each step, the plain version's largest
    displacement after each step, and the final plain positions."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    state, cset = scene
    gt, p = cset.grid_tets[0], state.particles
    f = gtc.make_tet_step(gt, p.inv_mass, dt=0.005, substeps=5,
                          max_iterations=iters, damping=damping,
                          device=p.x.device)
    x, v, xr, vr = p.x, p.v, p.x, p.v
    devs, moved = [], []
    for _ in range(steps):
        x, v = f(x, v)
        for _ in range(5):
            xr, vr = gtc.tet_substep_reference(gt, xr, vr, p.inv_mass,
                                               h=0.001, max_iterations=iters,
                                               damping=damping)
        devs.append(max_dev(x, xr))
        moved.append((xr - p.x).abs().max().item())
    torch.cuda.synchronize()
    assert torch.isfinite(x).all() and torch.isfinite(v).all()
    n_pin = gt.height * gt.depth
    assert torch.equal(x[:n_pin], p.x[:n_pin]), "pinned face moved"
    assert torch.equal(v[:n_pin], p.v[:n_pin]), "pinned face got velocity"
    log(f"check tet {label}: max|dx| kernel vs plain per step {devs!r}; "
        f"plain version's largest displacement per step {moved!r}")
    return devs, moved, xr


def check_tet_kernel_against_plain(dev, bar):
    """Phase 3, tet: the tet kernel against its plain version. Returns the
    deviation at the main path's shape and configuration, the 10-step
    plain positions, and the 5-iteration record."""
    devs, _, x10 = tet_kernel_vs_plain(bar, 10, label="80x36x36 10 steps")
    assert max(devs) <= CHECK_TOL, devs
    # At more than one iteration the reference's own trajectory jumps by
    # orders of magnitude after a few steps (its lambda accumulates the
    # XPBD multiplier step divided by C, so the alpha * lambda term of the
    # later iterations is 1/C too large; tests/test_torch_tet_step.py);
    # the kernel is held to the bar over the steps before that point and
    # the rest of the 10 steps are recorded.
    d5, m5, _ = tet_kernel_vs_plain(bar, 10, iters=5,
                                    label="80x36x36 5 iterations")
    assert max(d5[:5]) <= CHECK_TOL, d5
    small = bar_scene((13, 7, 5), dev, scale=(2.0, 0.5, 0.5))
    ds, ms, _ = tet_kernel_vs_plain(small, 10, iters=5, damping=0.01,
                                    label="13x7x5 5 iterations damping 0.01")
    assert max(ds[:4]) <= CHECK_TOL, ds
    free = bar_scene((13, 7, 5), dev, stiffness=0.0, scale=(2.0, 0.5, 0.5))
    d0, _, _ = tet_kernel_vs_plain(free, 10, label="13x7x5 stiffness 0")
    assert max(d0) <= 1e-6, d0
    record = {"bar_it5_dev": d5, "bar_it5_plain_moved": m5,
              "small_it5_dev": ds, "small_it5_plain_moved": ms,
              "stiffness0_dev": max(d0)}
    return max(devs), x10, record


def profile_busy(fn, state, n_prof, label):
    """Steps ``n_prof`` times under ``torch.profiler``; returns the card's
    busy share of the wall time and logs the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    s = state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            s = fn(s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(ev, "self_device_time_total", 0.0)
                  for ev in prof.key_averages())
    top = sorted(prof.key_averages(),
                 key=lambda ev: -getattr(ev, "self_device_time_total", 0.0))
    for ev in top[:5]:
        log(f"  {label} device time: {ev.key[:60]!r} "
            f"{getattr(ev, 'self_device_time_total', 0.0) / n_prof!r} us/step "
            f"x{ev.count}")
    busy = busy_us / 1e6 / wall
    log(f"{label} under profiler: {n_prof / wall!r} steps/s, device busy "
        f"{busy!r} of wall time")
    return busy


def run_tet_main_path(dev, x_plain10):
    """Phase 4, tet: SceneBuilder -> make_step_fn -> 200 steps of the bench
    bar on the card."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    cfg = StepConfig()
    state, cset = bar_scene(BAR, dev)
    fn = make_step_fn(cset, cfg)
    n = state.particles.n
    log(f"main path: {BAR} bar, {n} particles, route {fn.path}")
    assert fn.path == "cuda_kernel", fn.path
    x0 = state.particles.x.clone()

    s10 = state
    for _ in range(10):
        s10 = fn(s10)
    dev10 = max_dev(s10.particles.x, x_plain10)
    log(f"main path bar 10 steps vs plain version: max|dx| = {dev10!r}")
    assert dev10 <= CHECK_TOL, dev10

    torch.cuda.synchronize()
    reset_counts()
    s = state
    for _ in range(STEPS_MAIN):
        s = fn(s)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["tet_substep"]
    log(f"main path bar: launch counts {counts}")

    x = s.particles.x
    assert torch.isfinite(x).all() and torch.isfinite(s.particles.v).all()
    n_pin = BAR[1] * BAR[2]
    assert torch.equal(x[:n_pin], x0[:n_pin]), "pinned face moved"
    fall = (x0[n_pin:, 1].mean() - x[n_pin:, 1].mean()).item()
    assert fall > 0.01, f"free end fell only {fall}"
    t_expect = np.float32(0.0)
    for _ in range(STEPS_MAIN):
        t_expect = np.float32(t_expect + np.float32(cfg.dt))
    assert s.time.item() == float(t_expect), (s.time.item(), t_expect)
    per_step = 2 * cfg.substeps * cfg.max_iterations
    assert launches == STEPS_MAIN * per_step, launches
    log(f"main path bar {STEPS_MAIN} steps: launches {launches}, "
        f"mean fall of the free vertices {fall!r}, time {s.time.item()!r}")

    st = [s]

    def one_step():
        st[0] = fn(st[0])

    rate = rate_windows(one_step, 1)
    assert torch.isfinite(st[0].particles.x).all()
    log(f"main path bar steps/s: {rate}")
    busy = profile_busy(fn, st[0], 200, "main path bar")
    return launches, rate, busy, dev10


def time_tet_kernel(dev, bar):
    """Phase 5, tet: each kernel per launch and the substep (both), the
    plain version per substep and the bound, at the main path's shape."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    state, cset = bar
    gt, p = cset.grid_tets[0], state.particles
    dims = (gt.width, gt.height, gt.depth)
    params = gtc.kernel_params(gt, h=0.001)
    w = p.inv_mass.contiguous()
    ic = gt.inv_cnt.reshape(-1).contiguous()
    buf = [gtc.to_planes(p.x), gtc.to_planes(p.v)]

    def launch():
        buf[:] = gtc.tet_substep_cuda(buf[0], buf[1], w, ic, params, dims)

    out = {"interval_ms": cuda_time_ms(launch, 500)}
    for key, name in (("cell_ms", "tet_cell_kernel"),
                      ("vertex_ms", "tet_vertex_kernel")):
        out[key] = device_ms(launch, 200, name)
    if out["cell_ms"] is None or out["vertex_ms"] is None:
        out["ms"], out["ms_source"] = out["interval_ms"], "cuda events"
    else:
        out["ms"] = out["cell_ms"] + out["vertex_ms"]
        out["ms_source"] = "profiler"
    xs = [p.x, p.v]

    def plain():
        xs[:] = gtc.tet_substep_reference(gt, xs[0], xs[1], p.inv_mass,
                                          h=0.001)

    out["plain_ms"] = cuda_time_ms(plain, 20)
    n_vert = p.n
    n_cells = (dims[0] - 1) * (dims[1] - 1) * (dims[2] - 1)
    bytes_moved = 4 * 14 * n_vert        # 6 planes + w + inv_cnt in, 6 out
    flops = (TET_FLOPS_PER_CELL * n_cells
             + (TET_FLOPS_PER_VERTEX + TET_FLOPS_FIXED) * n_vert)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    out["bound_ms"] = max(t_bytes, t_ops)
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    out["bound_bytes_ms"], out["bound_ops_ms"] = t_bytes, t_ops
    for k, v in out.items():
        log(f"timing tet {k}: {v!r}")
    return out


def time_cloth_kernel(dev):
    """Phase 5: the substep kernel per launch, its plain version per
    substep and its bound, at the main path's shape; then make_cloth_step
    at 1 and 4 rollouts."""
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    state, cset = cloth_scene(GRID, GRID, dev)
    gc, p = cset.grid_cloths[0], state.particles
    h = 0.005 / 5
    params = gcc.kernel_params(gc, h=h)
    w = p.inv_mass.reshape(GRID, GRID)
    icd = gc.inv_cnt_dist.reshape(GRID, GRID).contiguous()
    icb = gc.inv_cnt_bend.reshape(GRID, GRID).contiguous()
    out = {}
    for nb in (1, 4):
        buf = [gcc.to_planes(torch.stack([p.x] * nb), GRID, GRID),
               gcc.to_planes(torch.stack([p.v] * nb), GRID, GRID)]

        def launch():
            buf[:] = gcc.cloth_substep_cuda(buf[0], buf[1], w, icd, icb,
                                            params)

        # events time the stream between launches, host overhead included;
        # the profiler gives the kernel's own device time
        out[f"interval_ms_b{nb}"] = cuda_time_ms(launch, 500)
        kms = device_ms(launch, 200, "cloth_substep_kernel")
        out[f"ms_b{nb}"] = out[f"interval_ms_b{nb}"] if kms is None else kms
        out[f"ms_source_b{nb}"] = "cuda events" if kms is None else "profiler"
        n_part = nb * GRID * GRID
        # per rollout 6 state planes in and 6 out; w, icd and icb are read
        # once, since the rollouts share them (w has one plane here)
        shared_planes = 3 if w.dim() == 2 else nb + 2
        bytes_moved = 4 * (12 * n_part + shared_planes * GRID * GRID)
        flops = (FLOPS_FIXED + FLOPS_PER_ITERATION) * n_part
        t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FP32_FLOPS * 1e3
        out[f"bound_ms_b{nb}"] = max(t_bytes, t_ops)
        out[f"bound_by_b{nb}"] = "bytes" if t_bytes >= t_ops else "operations"

    xs = [p.x, p.v]

    def plain():
        xs[:] = gcc.cloth_substep_reference(gc, xs[0], xs[1], p.inv_mass,
                                            h=h)

    out["plain_ms"] = cuda_time_ms(plain, 50)

    for nb in (1, 4):
        f = gcc.make_cloth_step(gc, p.inv_mass, gc.inv_cnt_dist,
                                gc.inv_cnt_bend, dt=0.005, substeps=5,
                                n_batch=nb, n_steps=20, device=dev)
        xv = [p.x, p.v] if nb == 1 else [torch.stack([p.x] * nb),
                                         torch.stack([p.v] * nb)]

        def call():
            xv[:] = f(*xv)

        out[f"steps_per_s_b{nb}"] = rate_windows(call, 20)
        assert torch.isfinite(xv[0]).all()
    for k, v in out.items():
        log(f"timing {k}: {v!r}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from positionbaseddynamics_tpu_torch import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev)
    smi = nvidia_smi_line()
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0!r} s")
    for stem, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    err, x_plain10 = check_kernel_against_plain(dev)
    t0 = time.perf_counter()
    bar = bar_scene(BAR, dev)
    log(f"built the {BAR} bar in {time.perf_counter() - t0!r} s")
    tet_err, bar_plain10, tet_record = check_tet_kernel_against_plain(dev,
                                                                      bar)
    launches, main_rate, busy = run_main_path(dev, x_plain10)
    tet_launches, tet_rate, tet_busy, tet_main_dev = run_tet_main_path(
        dev, bar_plain10)
    t = time_cloth_kernel(dev)
    tt = time_tet_kernel(dev, bar)

    kernels = [{
        "name": "cloth_substep",
        "route": "cuda",
        "source": "positionbaseddynamics_tpu_torch/csrc/grid_cloth_step.cu",
        "replaces": "positionbaseddynamics_tpu/solver/grid_cloth_pallas.py:240",
        "launches": launches,
        "max_abs_err": err,
        "ms": t["ms_b1"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms_b1"],
        "bound_by": t["bound_by_b1"],
        "library_ms": None,
        "ms_source": t["ms_source_b1"],
        "interval_ms": t["interval_ms_b1"],
        "ms_b4": t["ms_b4"],
        "interval_ms_b4": t["interval_ms_b4"],
        "bound_ms_b4": t["bound_ms_b4"],
        "main_path_steps_per_s": main_rate,
        "main_path_device_busy": busy,
        "steps_per_s_b1": t["steps_per_s_b1"],
        "steps_per_s_b4": t["steps_per_s_b4"],
    }, {
        "name": "tet_substep",
        "route": "cuda",
        "source": "positionbaseddynamics_tpu_torch/csrc/grid_tet_step.cu",
        "replaces": "positionbaseddynamics_tpu/solver/grid_tet_pallas.py:99",
        "launches": tet_launches,
        "max_abs_err": tet_err,
        "ms": tt["ms"],
        "plain_ms": tt["plain_ms"],
        "bound_ms": tt["bound_ms"],
        "bound_by": tt["bound_by"],
        "library_ms": None,
        "ms_source": tt["ms_source"],
        "cell_ms": tt["cell_ms"],
        "vertex_ms": tt["vertex_ms"],
        "interval_ms": tt["interval_ms"],
        "bound_bytes_ms": tt["bound_bytes_ms"],
        "bound_ops_ms": tt["bound_ops_ms"],
        "main_path_max_abs_err": tet_main_dev,
        "main_path_steps_per_s": tet_rate,
        "main_path_device_busy": tet_busy,
        **tet_record,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
