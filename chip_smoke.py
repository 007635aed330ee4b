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
   bound, and ``make_cloth_step`` at 1 and 4 rollouts in steps/s;
6. the fluid path, the 100k PBF breaking dam of ``bench.py --fluid``
   (80×50×25 particles in its boundary box), built by ``FluidScene.create``
   on the card: the three PBF kernels (density and λ, corrections, XSPH)
   against their plain versions for one pass each at the dam's shapes and
   on a cap-40 dam without boundary, and the kernel step against the plain
   step over 10 steps; then ``make_fluid_step_fn`` → 100 steps with the
   launch counts set to 0 just before and read just after (5/5/1 a step),
   ``overflow`` 0 and every position finite; steps/s, the card's busy
   share and its peak memory; each kernel per launch beside its plain
   version and its bound, logged beside the recorded times of their
   first design (``RECORDED_FIRST_DESIGN_MS``); the staging and lane use
   that the dam's tables give B3 and B4; and that a step never syncs the
   host.

The build log's ``-Xptxas -v`` lines are printed per ``__global__``
(registers, shared memory, spills), and for the PBF kernels the
registers, shared memory and resident blocks an SM that the CUDA runtime
reports (``cellgrid_cuda.kernel_resources``).

Every steps/s figure is the median of ``N_WINDOWS`` windows of at least
``WINDOW_S`` seconds on the host clock, printed with the lowest and the
highest window.

Prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
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

DAM = (80, 50, 25)              # the bench dam (bench.py --fluid defaults)
FLUID_STEPS_MAIN = 100
FLUID_CHECK_STEPS = 10
FLUID_STEP_TOL = 1e-4           # kernel step vs plain step over 10 steps
FLUID_PASS_TOL = 1e-6           # one pass: max|dx|, max|dv|
FLUID_RHO_RTOL = 1e-5           # one pass: max|d rho| / max rho
FLUID_LAM_RTOL = 1e-4           # one pass: max|d lambda| / max|lambda|
PLAIN_CHUNK = 2048              # active cells per piece of the plain passes
# B3-B5 per launch at the 100k dam in their first design (one warp per
# active cell, one lane per slot, neighbour rows read from global memory),
# as PERF.md records them: chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W. Kernel times held within 3% between calls. Only logged beside
# this run's times, as recorded figures; no result is computed from them.
RECORDED_FIRST_DESIGN_MS = {"pbf_density_lambda": 0.3036,
                            "pbf_corrections": 0.2917, "pbf_xsph": 0.2629}

# fp32 operations counted from csrc/pbf_cells.cu. Per candidate pair (an
# occupied slot of a neighbour cell) the frozen test: the mass or psi
# compare 1, three differences 3, the rounded r0^2 5, and the range
# compares 2 (fluid) or 1 (boundary). Per pair inside the radius: the
# displacement 3, r^2 5, sqrt 1, then W 10 (divide, min, compare, 7 of the
# cubic) and the grad W coefficient 11 (divide, min, compare, 4 of the
# polynomial, multiply, max, divide, compare) as each pass needs them:
# B3 W with m W 2, the coefficient with gc 3, gc^2 r^2 3 and three gc d
# sums 6; B4 the coefficient with gc 3, its factor 2 (lambda_i + lambda_j,
# times gc; boundary 1) and three sums 6; B5 W, its factor 3 (max,
# divide, multiply), v_i - v_j 3 and three sums 6. Per occupied slot the
# closing arithmetic: B3 15 (density, grad C_i, lambda), B4 and B5 6.
PBF_TEST_OPS = {"fluid": 11, "boundary": 10}
PBF_PAIR_OPS = {"pbf_density_lambda": {"fluid": 44, "boundary": 44},
                "pbf_corrections": {"fluid": 31, "boundary": 30},
                "pbf_xsph": {"fluid": 31, "boundary": 0}}
PBF_SLOT_OPS = {"pbf_density_lambda": 15, "pbf_corrections": 6,
                "pbf_xsph": 6}


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(logs):
    """``{kernel: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}}`` from ``nvcc -Xptxas -v`` output (``{source stem:
    text}``), and the lines it read, each prefixed with its kernel."""
    out, lines = {}, []
    for stem, text in logs.items():
        name = None
        for line in text.splitlines():
            m = re.search(r"(?:entry function|Function properties for) "
                          r"'?(\S+?)'?(?: |$)", line)
            if m:
                # the kernels' names hold no digits; a mangled name puts
                # digits (a length, a file hash) before each part
                short = re.search(r"[a-z][a-z_]*_kernel", m.group(1))
                name = short.group(0) if short else m.group(1)
                out.setdefault(name, {})
                continue
            if name is None or not ("registers" in line or "spill" in line):
                continue
            lines.append(f"{stem} {name}: {line.strip()}")
            for key, pat in (("registers", r"(\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                hit = re.search(pat, line)
                if hit:
                    out[name][key] = int(hit.group(1))
    return out, lines


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
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    return {"cloth_substep": gcc.cloth_substep_cuda,
            "tet_substep": gtc.tet_substep_cuda,
            "pbf_density_lambda": fcc.density_lambda_cuda,
            "pbf_corrections": fcc.corrections_cuda,
            "pbf_xsph": fcc.xsph_cuda}


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
    busy, _ = profile_busy(fn, st[0], 400, "main path")
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


def profile_busy(fn, state, n_prof, label, top=5):
    """Steps ``n_prof`` times under ``torch.profiler``. Returns the card's
    busy share of the wall time and its busy microseconds per step, both
    from the device-side events alone (an aten op's row repeats the device
    time of the kernels it launched), and logs the ``top`` kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            s = fn(s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in device)
    for ev in sorted(device, key=lambda ev: -ev.self_device_time_total)[:top]:
        log(f"  {label} device time: {ev.key[:60]!r} "
            f"{ev.self_device_time_total / n_prof!r} us/step x{ev.count}")
    busy = busy_us / 1e6 / wall
    log(f"{label} under profiler: {n_prof / wall!r} steps/s, device busy "
        f"{busy!r} of wall time, {busy_us / n_prof!r} us/step")
    return busy, busy_us / n_prof


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
    busy, _ = profile_busy(fn, st[0], 200, "main path bar")
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


def dam_scene(dims, device, cap_per_cell=12, boundary=True):
    """The bench dam (``bench.py::bench_fluid``): an nx×ny×nz block of
    particles at spacing 2r in a box of boundary particles 4(nx+2) by
    2(ny+2) by (nz+2) spacings, through ``FluidScene.create`` (None means
    the CUDA card). Returns the scene and the block's positions."""
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    radius = 0.025
    diam = 2 * radius
    nx, ny, nz = dims
    fluid = fm.block_positions((diam, diam, diam), dims, diam)
    lo = (0.0, 0.0, 0.0)
    hi = ((nx + 2) * diam * 4.0, (ny + 2) * diam * 2.0, (nz + 2) * diam)
    bnd = (fm.box_boundary(lo, hi, diam) if boundary
           else np.zeros((0, 3), np.float32))
    scene = fm.FluidScene.create(len(fluid), bnd, particle_radius=radius,
                                 cap_per_cell=cap_per_cell,
                                 domain=(lo, hi), device=device)
    return scene, fluid


def step_tables(scene, state):
    """The tables the next step of ``state`` builds, and its velocities
    after the Euler update."""
    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    a = torch.tensor(scene.gravity, device=state.x.device).expand_as(state.x)
    h = fm.cfl_dt(state.v, a, state.dt, scene)
    v = state.v + h * a
    x = state.x + h * v
    return fcg.build_fluid_tables(scene.cellgrid, x, scene.mass), v


class PassInputs:
    """One step's tables with the kernels' outputs: the main path's first
    two iterations of B3 and B4 (the first at ``x = x0 = xt``, the second
    at the positions the first B4 wrote, ``x = x_out``, on the pair set
    frozen at ``xt``), then B5 (pair set frozen at ``xt``) into
    ``v_out``."""

    def __init__(self, scene, state):
        from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg
        from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc

        self.fcg, self.fcc = fcg, fcc
        (slot, kept, self.xt, self.mt, self.active, self.nbr, self.nbr_ok,
         _), v = step_tables(scene, state)
        self.scene, self.spec = scene, scene.cellgrid
        self.count = fcg.occupied_count(self.mt)
        self.params = fcc.kernel_params(scene.density0, scene.support_radius,
                                        scene.viscosity)
        # per iteration: positions in, λ and density tables, positions out
        self.iters = []
        x = self.xt
        for it in range(2):
            self.iters.append((x, torch.zeros_like(self.mt),
                               torch.zeros_like(self.mt), x.clone()))
            self.b3(it)
            self.b4(it)
            x = self.iters[it][3]
        self.x_out, self.lam_t, self.dens_t = (self.iters[0][3],
                                               self.iters[0][1],
                                               self.iters[0][2])
        nslots = self.spec.n_cells * self.spec.cap
        self.vt = fcg.scatter_planes(v, slot, kept, nslots, self.mt.shape)
        self.v_out = self.vt.clone()
        self.b5()

    def cells(self):
        return (self.active, self.nbr, self.nbr_ok)

    def b3(self, it=0):
        x, lam_t, dens_t, _ = self.iters[it]
        self.fcc.density_lambda_cuda(self.spec, x, self.xt, self.mt,
                                     self.count, *self.cells(), lam_t,
                                     dens_t, self.params)

    def b4(self, it=0):
        x, lam_t, _, x_out = self.iters[it]
        self.fcc.corrections_cuda(self.spec, x, self.xt, self.mt,
                                  self.count, lam_t, *self.cells(), x_out,
                                  self.params)

    def b5(self):
        self.fcc.xsph_cuda(self.spec, self.x_out, self.xt, self.vt, self.mt,
                           self.count, self.dens_t, *self.cells(), self.v_out,
                           self.params)

    def plain_b3(self, it=0):
        sc = self.scene
        return self.fcc.density_lambda_reference(
            self.spec, self.iters[it][0], self.xt, self.mt, *self.cells(),
            sc.density0, sc.support_radius, chunk=PLAIN_CHUNK)

    def plain_b4(self, it=0):
        sc = self.scene
        x, lam_t, _, _ = self.iters[it]
        corr = self.fcc.corrections_reference(
            self.spec, x, self.xt, self.mt, lam_t, *self.cells(),
            sc.density0, sc.support_radius, chunk=PLAIN_CHUNK)
        return x.index_add(1, self.active.long(), corr)

    def plain_b5(self):
        sc = self.scene
        return self.fcg.xsph_cell(self.spec, self.x_out, self.vt, self.mt,
                                  *self.cells(), self.dens_t, sc.viscosity,
                                  sc.support_radius, self.xt,
                                  chunk=PLAIN_CHUNK)


def check_fluid_passes(pi, label, second_moves=True):
    """Each PBF kernel's one pass against its plain version on the same
    inputs: B3 and B4 at the first iteration (``x = x0``) and at the
    second (``x ≠ x0``), B5 once. Returns the deviations; the keys of the
    second iteration end in ``2``. ``second_moves``: the second iteration
    must find compression (λ ≠ 0) and move particles."""
    act = pi.active.long()
    out = {}
    for it, sfx in ((0, ""), (1, "2")):
        x_in, lam_t, dens_t, x_out = pi.iters[it]
        lam_r, dens_r = pi.plain_b3(it)
        x_ref = pi.plain_b4(it)
        torch.cuda.synchronize()
        out.update({
            f"rho{sfx}_max_abs_err": max_dev(dens_t[act], dens_r),
            f"rho{sfx}_scale": dens_r.abs().max().item(),
            f"lam{sfx}_max_abs_err": max_dev(lam_t[act], lam_r),
            f"lam{sfx}_scale": lam_r.abs().max().item(),
            f"x{sfx}_max_abs_err": max_dev(x_out, x_ref),
            f"x{sfx}_moved": max_dev(x_ref, x_in),
        })
    out["x_moved_from_x0"] = max_dev(pi.iters[1][0], pi.xt)
    v_ref = pi.plain_b5()
    torch.cuda.synchronize()
    out.update({
        "v_max_abs_err": max_dev(pi.v_out, v_ref),
        "v_smoothed": max_dev(v_ref, pi.vt),
        "max_count": pi.count.max().item(),
        "active": pi.active.shape[0],
    })
    log(f"check PBF passes {label}: {out}")
    for sfx in ("", "2"):
        assert (out[f"rho{sfx}_max_abs_err"]
                <= FLUID_RHO_RTOL * out[f"rho{sfx}_scale"]), out
        # λ = −max(ρ/ρ0 − 1, 0)/Σ|∇C|²: subtracting 1 at the dam's
        # compression (ρ/ρ0 − 1 ≤ ~0.03) cancels about two of ρ's digits
        assert (out[f"lam{sfx}_max_abs_err"]
                <= FLUID_LAM_RTOL * out[f"lam{sfx}_scale"]), out
        assert out[f"x{sfx}_max_abs_err"] <= FLUID_PASS_TOL, out
        if sfx == "" or second_moves:
            assert min(out[f"lam{sfx}_scale"], out[f"x{sfx}_moved"]) > 0, out
    assert out["v_max_abs_err"] <= FLUID_PASS_TOL, out
    assert min(out["x_moved_from_x0"], out["v_smoothed"]) > 0, out
    return out


def fluid_steps_vs_plain(scene, state, steps, label):
    """``make_fluid_step_fn`` against the plain step on the card, one step
    at a time. Returns the max|dx| after each step, the plain step's
    median seconds and the kernel route's final state."""
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    fn = fm.make_fluid_step_fn(scene)
    assert fn.path == "cuda_kernel", fn.path
    sk = sp = state
    devs, plain_s = [], []
    for _ in range(steps):
        sk = fn(sk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp = fm.fluid_step_reference(sp, scene, chunk=PLAIN_CHUNK)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
        devs.append(max_dev(sk.x, sp.x))
    assert torch.isfinite(sk.x).all() and torch.isfinite(sk.v).all()
    assert sk.overflow.item() == 0.0 and sp.overflow.item() == 0.0
    log(f"check fluid {label}: max|dx| kernel step vs plain step per step "
        f"{devs!r}; plain step {statistics.median(plain_s)!r} s")
    assert max(devs) <= FLUID_STEP_TOL, devs
    return devs, statistics.median(plain_s), sk


def check_fluid_kernels_against_plain(dev):
    """Phase 6a: the PBF kernels against their plain versions on the 100k
    dam (10 steps, then one pass each on the tables of the next step) and
    on a cap-40 dam without boundary whose cells hold more than 32
    particles."""
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    t0 = time.perf_counter()
    scene, fluid = dam_scene(DAM, dev)
    spec = scene.cellgrid
    log(f"built the {DAM} dam in {time.perf_counter() - t0!r} s: "
        f"{scene.n_fluid} fluid and {scene.boundary_x.shape[0]} boundary "
        f"particles, {spec.dims} cells of {spec.cap} slots, capb "
        f"{spec.boundary.capb}, max_active {spec.max_active}")
    devs, plain_step_s, s10 = fluid_steps_vs_plain(
        scene, fm.FluidState.create(fluid, device=dev), FLUID_CHECK_STEPS,
        f"{DAM} {FLUID_CHECK_STEPS} steps")
    passes = check_fluid_passes(PassInputs(scene, s10), f"{DAM} step 11")

    # a 6x8x6 block squeezed to 0.6 of its spacing (up to 36 particles a
    # cell, more than a warp has lanes) with seeded random velocities; the
    # 10 steps start from it squeezed to 0.85, which expands without
    # crowding a cell past 40
    small, block = dam_scene((6, 8, 6), dev, cap_per_cell=40, boundary=False)
    diam = 0.05
    v0 = torch.tensor(np.random.default_rng(0).normal(0.0, 0.05, block.shape),
                      dtype=torch.float32, device=dev)

    def squeezed(f):
        x = (diam + f * (block - diam)).astype(np.float32)
        return dataclasses.replace(fm.FluidState.create(x, device=dev), v=v0)

    # the first correction spreads this block (4.6 times the rest density)
    # below rest density, so its second iteration has λ = 0 everywhere; the
    # dam above and the card test's cap-40 case run it with compression
    small_passes = check_fluid_passes(PassInputs(small, squeezed(0.6)),
                                      "6x8x6 cap 40, no boundary",
                                      second_moves=False)
    assert small.cellgrid.cap == 40 and small_passes["max_count"] > 32
    small_devs, _, _ = fluid_steps_vs_plain(small, squeezed(0.85),
                                            FLUID_CHECK_STEPS,
                                            "6x8x6 cap 40, no boundary")
    return {"step_devs": devs, "plain_step_s": plain_step_s,
            "passes": passes, "cap40_passes": small_passes,
            "cap40_step_devs": small_devs}


def run_fluid_main_path(dev):
    """Phase 6b: FluidScene.create -> make_fluid_step_fn -> 100 steps of
    the 100k dam on the card, through the entry points' defaults."""
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene, fluid = dam_scene(DAM, None)
    state = fm.FluidState.create(fluid)
    fn = fm.make_fluid_step_fn(scene)
    torch.cuda.synchronize()
    peak_build = torch.cuda.max_memory_allocated()
    log(f"main path: {DAM} dam, {scene.n_fluid} particles, route {fn.path}, "
        f"peak device memory of the build {peak_build} B")
    assert fn.path == "cuda_kernel", fn.path

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    s = state
    for _ in range(FLUID_STEPS_MAIN):
        s = fn(s)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"main path dam: launch counts {counts}")
    x = s.x
    assert torch.isfinite(x).all() and torch.isfinite(s.v).all()
    overflow = s.overflow.item()
    assert overflow == 0.0, f"capacity overflow {overflow}"
    x0 = torch.tensor(fluid, device=x.device)
    spread = (x[:, 0].max() - x0[:, 0].max()).item()
    assert spread > 0.0, f"the dam's front did not move: {spread}"
    # the reference ejects the first boundary-side layers at tens of m/s in
    # the first steps (JAX does the same), so the mean height rises
    rise = (x[:, 1].mean() - x0[:, 1].mean()).item()
    vmax = s.v.abs().max().item()
    want = {"pbf_density_lambda": FLUID_STEPS_MAIN * scene.iterations,
            "pbf_corrections": FLUID_STEPS_MAIN * scene.iterations,
            "pbf_xsph": FLUID_STEPS_MAIN}
    for k, n in want.items():
        assert counts[k] == n, (k, counts[k], n)
    log(f"main path dam {FLUID_STEPS_MAIN} steps: simulated time "
        f"{s.time.item()!r} s, last dt {s.dt.item()!r}, front moved "
        f"{spread!r}, mean height {rise:+.6f}, max|v| {vmax!r}, overflow "
        f"{overflow}, peak device memory of the steps {peak} B")

    st = [s]

    def one_step():
        st[0] = fn(st[0])

    rate = rate_windows(one_step, 1)
    assert torch.isfinite(st[0].x).all()
    log(f"main path dam steps/s: {rate}; after the windows: time "
        f"{st[0].time.item()!r}, overflow {st[0].overflow.item()}")
    busy, busy_us = profile_busy(fn, st[0], 50, "main path dam", top=10)

    # a step must not sync the host (after the first, which copies the
    # grid's constants to the card once)
    sync_error = None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st[0] = fn(st[0])
    except RuntimeError as e:
        sync_error = str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"main path dam step under sync debug mode 'error': "
        f"{'no host sync' if sync_error is None else sync_error}")
    return {"launches": counts, "steps_per_s": rate, "device_busy": busy,
            "device_us_per_step": busy_us, "peak_bytes": peak,
            "peak_build_bytes": peak_build,
            "overflow": overflow, "scene": scene,
            "state": st[0], "sync_error": sync_error}


def work_counts(spec, xt0, mt, active, nbr, nbr_ok, support, chunk=None):
    """What one pass over these tables has to do, counted from the data
    (for the kernels' bounds): ``rows`` occupied active cells; ``slots``
    occupied active slots; ``fluid_candidates`` and
    ``boundary_candidates``, per occupied active slot the occupied slots of
    its 27 neighbor cells (the pairs whose frozen test the kernels
    evaluate); ``fluid_pairs`` and ``boundary_pairs``, those that pass
    it."""
    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg

    bt = spec.boundary
    count = fcg.occupied_count(mt).to(torch.float64)
    bcount = None if bt is None else bt.count.to(torch.float64)

    def run(active, nbr, nbr_ok, w):
        p = fcg._Pairs(spec, xt0, xt0, mt, active, nbr, nbr_ok, support, w)
        occ = (p.ma > 0.0).to(torch.float64)
        nb = nbr.to(torch.int64)
        ok = nbr_ok.to(torch.float64)
        rows = [occ, occ * torch.sum(count[nb] * ok, -1)[:, None],
                p.ok.sum(-1).to(torch.float64)]
        if bt is None:
            rows += [torch.zeros_like(occ)] * 2
        else:
            rows += [occ * torch.sum(bcount[nb] * ok, -1)[:, None],
                     p.okb.sum(-1).to(torch.float64)]
        return torch.stack(rows)

    totals = fcg._chunked(run, chunk, mt, active, nbr, nbr_ok).sum(dim=(1, 2))
    names = ("slots", "fluid_candidates", "fluid_pairs",
             "boundary_candidates", "boundary_pairs")
    out = {k: int(v) for k, v in zip(names, totals.tolist())}
    out["rows"] = int((count[active.long()] > 0).sum().item())
    return out


def neighbourhood_counts(spec, mt, active, nbr, nbr_ok):
    """Per occupied active cell: its particles, and the fluid and boundary
    candidates of its 27-cell neighbourhood (the occupied slots of its
    neighbours), the rows B3 and B4 stage."""
    from positionbaseddynamics_tpu_torch.fluids import cellgrid as fcg

    count = fcg.occupied_count(mt).long()
    n = count[active.long()]
    occ = n > 0
    nb_ids, ok = nbr.long()[occ], nbr_ok[occ]
    nf = (count[nb_ids] * ok).sum(-1)
    bt = spec.boundary
    nb = (torch.zeros_like(nf) if bt is None
          else (bt.count.long()[nb_ids] * ok).sum(-1))
    return n[occ], nf, nb


def staging_counts(spec, mt, active, nbr, nbr_ok, stage):
    """How B3 and B4 take these tables, ``stage`` being the fluid and
    boundary candidates a warp stages at a time: per occupied active cell
    its candidates, the staging chunks they need, and the share of the
    warp's lanes that hold a particle, beside the share in the first
    design (one lane per slot, 32 lanes a round)."""
    n, nf, nb = neighbourhood_counts(spec, mt, active, nbr, nbr_ok)
    chunks = torch.maximum(-(-nf // stage[0]), -(-nb // stage[1]))
    g = torch.full_like(n, 32)                  # lanes a particle
    for _ in range(5):
        g = torch.where(n * g > 32, g // 2, g)
    rounds = -(-n * g // 32)
    return {"cells": int(n.numel()),
            "max_fluid_candidates": int(nf.max()),
            "max_boundary_candidates": int(nb.max()),
            "mean_fluid_candidates": nf.double().mean().item(),
            "cells_in_one_chunk": int((chunks == 1).sum()),
            "max_chunks": int(chunks.max()),
            "max_particles": int(n.max()),
            "lane_use": (n * g).sum().item() / (32 * rounds).sum().item(),
            "lane_use_first_design": n.sum().item() / (
                32 * -(-spec.cap // 32) * n.numel())}


def time_fluid_kernels(scene, state):
    """Phase 6c: each PBF kernel per launch, its plain version per pass and
    its bound, on the tables of the next step of ``state`` at the main
    path's shapes."""
    pi = PassInputs(scene, state)
    spec = pi.spec
    work = work_counts(spec, pi.xt, pi.mt, *pi.cells(),
                       scene.support_radius, chunk=PLAIN_CHUNK)
    # bytes the function needs, each read once: per occupied active cell
    # its id, 27 neighbour ids and flags; per neighbour cell of those its
    # occupied count and (B3, B4) its boundary count and occupied boundary
    # slots (x, y, z, psi); per occupied active slot the floats below. The
    # empty slots and unoccupied rows the kernels also touch are not work
    # the function needs.
    nb = torch.unique(pi.nbr[pi.nbr_ok].long())
    common = work["rows"] * (4 + 27 * 4 + 27) + 4 * nb.numel()
    bcount = spec.boundary.count[nb].long()
    boundary_bytes = int((bcount * 16).sum().item()) + 4 * nb.numel()
    sizes = {  # (floats read, floats written per slot, reads the boundary)
        "pbf_density_lambda": (7, 2, True),     # x, x0, m; lambda, rho
        "pbf_corrections": (8, 3, True),        # x, x0, m, lambda; x
        "pbf_xsph": (11, 3, False)}             # x, x0, m, v, rho; v
    runs = {"pbf_density_lambda": (pi.b3, pi.plain_b3),
            "pbf_corrections": (pi.b4, pi.plain_b4),
            "pbf_xsph": (pi.b5, pi.plain_b5)}
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc

    out = {"work": work,
           "staging": staging_counts(spec, pi.mt, *pi.cells(),
                                     fcc.stage_capacity())}
    for name, (kernel, plain) in runs.items():
        r = {"interval_ms": cuda_time_ms(kernel, 200)}
        kms = device_ms(kernel, 100, name + "_kernel")
        r["ms"] = r["interval_ms"] if kms is None else kms
        r["ms_source"] = "cuda events" if kms is None else "profiler"
        r["plain_ms"] = cuda_time_ms(plain, 3)
        n_in, n_out, bnd = sizes[name]
        r["bytes"] = 4 * work["slots"] * (n_in + n_out) + common + (
            boundary_bytes if bnd else 0)
        ops = PBF_PAIR_OPS[name]
        r["ops"] = (PBF_SLOT_OPS[name] * work["slots"]
                    + PBF_TEST_OPS["fluid"] * work["fluid_candidates"]
                    + ops["fluid"] * work["fluid_pairs"])
        if bnd:
            r["ops"] += (PBF_TEST_OPS["boundary"] * work["boundary_candidates"]
                         + ops["boundary"] * work["boundary_pairs"])
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["ops"] / H100_FP32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["bound_bytes_ms"], r["bound_ops_ms"] = t_bytes, t_ops
        out[name] = r
    for key, v in out.items():
        log(f"timing dam {key}: {v!r}")
    for name, ms in RECORDED_FIRST_DESIGN_MS.items():
        log(f"timing dam {name}: {out[name]['ms']!r} ms a launch in this "
            f"run; PERF.md records {ms} ms for its first design (not "
            "measured in this run)")
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
    ptxas, lines = ptxas_report(_build.build_logs)
    for line in lines:
        log(f"  ptxas {line}")
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc
    resources = fcc.kernel_resources()
    for kname, r in resources.items():
        log(f"  runtime {kname}: {r}")

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
    del bar
    fc = check_fluid_kernels_against_plain(dev)
    dam = run_fluid_main_path(dev)
    ft = time_fluid_kernels(dam["scene"], dam["state"])

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
    pbf = {"pbf_density_lambda": ("fluids/cellgrid_pallas.py:94", "rho"),
           "pbf_corrections": ("fluids/cellgrid_pallas.py:125", "x"),
           "pbf_xsph": ("fluids/cellgrid_pallas.py:149", "v")}
    for kname, (replaces, what) in pbf.items():
        r = ft[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "positionbaseddynamics_tpu_torch/csrc/pbf_cells.cu",
            "replaces": "positionbaseddynamics_tpu/" + replaces,
            "launches": dam["launches"][kname],
            "max_abs_err": max(fc["passes"].get(f"{what}{sfx}_max_abs_err",
                                                0.0) for sfx in ("", "2")),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "ms_source": r["ms_source"],
            "interval_ms": r["interval_ms"],
            "bound_bytes_ms": r["bound_bytes_ms"],
            "bound_ops_ms": r["bound_ops_ms"],
            "ops": r["ops"],
            "bytes": r["bytes"],
            "cap40_max_abs_err": max(
                fc["cap40_passes"].get(f"{what}{sfx}_max_abs_err", 0.0)
                for sfx in ("", "2")),
            "step10_max_abs_err": max(fc["step_devs"]),
            "cap40_step10_max_abs_err": max(fc["cap40_step_devs"]),
            "main_path_steps_per_s": dam["steps_per_s"],
            "main_path_device_busy": dam["device_busy"],
            "main_path_device_us_per_step": dam["device_us_per_step"],
            "main_path_peak_bytes": dam["peak_bytes"],
            "build_peak_bytes": dam["peak_build_bytes"],
            "plain_step_s": fc["plain_step_s"],
            "work": ft["work"],
            **({"staging": ft["staging"]} if kname != "pbf_xsph" else {}),
            "ptxas": ptxas.get(kname + "_kernel"),
            "runtime_resources": resources[kname],
        })
    assert dam["sync_error"] is None, dam["sync_error"]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
