#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port, beside ``bench.py`` (the JAX
package's): the same scenes, timed the same way, printing the same
one-line JSON shape with ``bench.py``'s metric names.

    python3 bench_torch.py                       # the 320x320 cloth
    python3 bench_torch.py --batch 4             # the same at 4 rollouts
    python3 bench_torch.py --bar                 # the 80x36x36 FEM-tet bar
    python3 bench_torch.py --fluid               # the 100k PBF breaking dam
    python3 bench_torch.py --mpc                 # MPPI, 32x32 cloth, K 256
    python3 bench_torch.py --mpc-big             # MPPI over K 320x320 cloths
    python3 bench_torch.py --pile-big            # 100 spheres on a box floor
    python3 bench_torch.py --rods                # 1024 Cosserat rods
    python3 bench_torch.py --tree                # a 100-constraint stiff tree
    python3 bench_torch.py --check               # kernels vs plain versions

Every line carries ``metric``, ``value``, ``unit`` and ``vs_baseline``
(the mode's steps/s per rollout, or ``--mpc-big``'s rollout-steps/s, over
the north-star 60 steps/s, as ``bench.py`` computes it), the extra keys that
``bench.py`` prints for the mode, ``"path"`` (``"cuda_per_substep"``: the
fused cloth substep, one launch per substep; ``"cuda_kernel"``: the
bar's and the dam's kernels; a ``"torch_..."`` name for the plain
routes; ``"batched_broadphase"``: ``--pile-big``'s, ``"rod_lattice"``
or ``"unstructured"``: ``--rods``', ``"tree_scheduled"``: ``--tree``'s,
as ``bench.py`` names them), ``"device"`` and ``"card"``, the card's
``nvidia-smi
--query-gpu=name,power.limit`` line (None on the CPU).

The port runs on the card: ``--device`` defaults to ``cuda`` and the
script exits 1 without CUDA. ``--device cpu`` runs the plain PyTorch
versions at whatever size is given, for tests; ``--check`` has nothing to
check there and exits 2. Modes whose slice the port lacks exit 2 and name
it. There is no ``--fuse``: the port's cloth kernel runs one launch per
substep, and fusing substeps into one launch (``bench.py``'s default) is
queued (ROADMAP queue B, B1).

The bench scenes (``cloth_scene``, ``bar_scene``, ``dam_scene``,
``pile_scene``, the planners' cloth) and the cloth kernel's plain steps
live here;
``chip_smoke.py`` and ``scripts/`` import them from this file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

_ARMADILLO = ("scene I/O (slice 8) and the scene file "
              "data/scenes/ArmadilloCollisionScene.json, which the "
              "repository does not hold")
UNPORTED = {
    "pile": "scene I/O (slice 8) and the scene files "
            "data/scenes/PileScene.json and data/sdf/bunny_10k.csdf, which "
            "the repository does not hold",
    "scene": "scene I/O (slice 8)",
    "armadillo_batch": _ARMADILLO,
    "mpc_contact": _ARMADILLO,
}
CHECK_TOL = {"cloth": 1e-5, "tet": 1e-5, "fluid": 1e-4}
PLAIN_CHUNK = 2048      # active cells per piece of the plain fluid passes


def card_line(dev: torch.device):
    """The card's ``nvidia-smi`` name and power limit, None on the CPU."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _record(dev, metric, value, unit, path, per_s=None, **extra):
    """One JSON record; ``vs_baseline`` is ``per_s`` (``value`` when None)
    over 60 steps/s."""
    per_s = value if per_s is None else per_s
    return {"metric": metric, "value": round(value, 2), "unit": unit,
            "vs_baseline": round(per_s / 60.0, 3), **extra, "path": path,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "card": card_line(dev)}


def _timed(dev, call, n):
    """Seconds for ``n`` calls of ``call()``, the card synchronised at both
    ends."""
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    _sync(dev)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# scenes (bench.py's)
# ---------------------------------------------------------------------------


def cloth_scene(width, height, device, structured=True):
    """The bench cloth (``bench.py:748-756``): a width×height grid of scale
    2×2, its two top corners pinned, XPBD distance 1e5 (method 4) and
    isometric bending 0.05 (method 3). ``structured=False`` builds it
    without the grid solver, as particle batches (JAX's r01 scene)."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    b = SceneBuilder(use_structured_grid=structured)
    tm = b.add_regular_triangle_model(width, height, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + width - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(device=device)


def pile_scene(n_bodies, device):
    """``bench.py --pile-big``'s scene (``bench.py:180-227``): ``n_bodies``
    spheres of radius 0.25 (32 surface samples, restitution 0.1, friction
    0.3) on a 10×10 grid in layers of 100 above a static (6, 1, 6) box
    floor, positions jittered from seed 0; the collision pipeline at
    tolerance 0.02 on the batched broad phase. Returns ``(state, cset,
    pipeline)``."""
    from positionbaseddynamics_tpu_torch.collision import sampling
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    rng = np.random.default_rng(0)
    b = SceneBuilder()
    floor = b.add_rigid_body((0.0, -0.5, 0.0), mass=0.0)
    b.add_collision_box(floor, (6.0, 1.0, 6.0))
    r = 0.25
    sv = sampling.sample_sphere(r, 32)
    for i in range(n_bodies):
        gx, gz = i % 10, (i // 10) % 10
        body = b.add_rigid_body(
            (0.55 * gx - 2.5 + 0.02 * rng.standard_normal(),
             0.8 + 0.55 * (i // 100),
             0.55 * gz - 2.5 + 0.02 * rng.standard_normal()),
            mass=1.0, inertia=(0.4 * r * r,) * 3)
        b.add_collision_sphere(body, r, restitution=0.1, friction=0.3,
                               verts=sv)
    state, cset = b.build(device=device)
    pipe = b.build_collision_pipeline(tolerance=0.02, broad_phase="batched",
                                      device=device)
    return state, cset, pipe


def plain_steps(gc, x, v, inv_mass, n_sub, h, **kw):
    """``n_sub`` substeps of the cloth kernel's plain version."""
    from positionbaseddynamics_tpu_torch.solver.grid_cloth_cuda import (
        cloth_substep_reference)

    for _ in range(n_sub):
        x, v = cloth_substep_reference(gc, x, v, inv_mass, h=h, **kw)
    return x, v


def bar_scene(dims, device, stiffness=1e5, scale=(4.0, 1.0, 1.0),
              structured=True):
    """The bench bar (``bench.py::bench_bar``): a regular tet grid with its
    i = 0 face pinned, XPBD FEM tets (method 3), Poisson ratio 0.3.
    ``structured=False`` builds it as the FEM-tet particle batch."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    w, h, d = dims
    b = SceneBuilder(use_structured_grid=structured)
    tm = b.add_regular_tet_model(w, h, d, scale=scale)
    for j in range(h):
        for k in range(d):
            b.set_mass(tm.offset + j * d + k, 0.0)
    b.add_solid_constraints(tm, method=3, stiffness=stiffness,
                            poisson_ratio=0.3)
    return b.build(device=device)


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


def planner_cloth(width, dev, scale):
    """The planners' cloth (``bench.py:30-37, :87-94``): a width×width
    grid of ``bench.py``'s constraints (XPBD distance 1e5, isometric
    bending 0.05) with only its first corner pinned, the one the command
    drags."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    b = SceneBuilder()
    tm = b.add_regular_triangle_model(width, width, scale=scale)
    b.set_mass(tm.offset, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(device=dev)


def cloth_step_fn(gc, inv_mass, cfg, dev, **kw):
    """``make_cloth_step`` for grid cloth ``gc`` under ``StepConfig``
    ``cfg``."""
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    return gcc.make_cloth_step(
        gc, inv_mass, gc.inv_cnt_dist, gc.inv_cnt_bend,
        dt=cfg.dt, substeps=cfg.substeps, max_iterations=cfg.max_iterations,
        gravity=cfg.gravity, damping=cfg.damping, device=dev, **kw)


def rollout_step_fn(gc, inv_mass, cfg, dev, k):
    """One step of ``k`` rollouts ``(k, N, 3)`` of grid cloth ``gc``, the
    kernel at ``n_batch = k`` (at k = 1, ``make_cloth_step``'s ``(N, 3)``
    form)."""
    step = cloth_step_fn(gc, inv_mass, cfg, dev, n_batch=k, n_steps=1)
    if k > 1:
        return step

    def one(x, v):
        x, v = step(x[0], v[0])
        return x[None], v[None]

    return one


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


def bench_cloth(args, dev):
    """The default mode and ``--batch N``: ``make_cloth_step`` over
    ``--steps-per-call`` steps, one warm-up call, then ``--calls`` calls
    (``bench.py:780-814``)."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig

    state, cset = cloth_scene(args.width, args.height, dev)
    cfg = StepConfig()
    step = cloth_step_fn(cset.grid_cloths[0], state.particles.inv_mass, cfg,
                         dev, n_batch=args.batch, n_steps=args.steps_per_call)
    x, v = state.particles.x, state.particles.v
    if args.batch > 1:
        x = x.expand(args.batch, *x.shape).contiguous()
        v = v.expand(args.batch, *v.shape).contiguous()
    xv = list(step(x, v))                                 # warm-up
    _sync(dev)
    if not torch.isfinite(xv[0]).all():
        raise FloatingPointError("cloth warm-up produced non-finite x")

    def call():
        xv[:] = step(*xv)

    dt = _timed(dev, call, args.calls)
    sps = args.calls * args.steps_per_call / dt
    extra = ({"aggregate_steps_per_s": round(sps * args.batch, 2)}
             if args.batch > 1 else {})
    return _record(
        dev, f"xpbd_cloth_{args.width * args.height // 1000}k_steps_per_s"
        + (f"_b{args.batch}" if args.batch > 1 else ""), sps, "steps/s",
        "cuda_per_substep" if dev.type == "cuda" else "torch_plain",
        **extra)


def bench_bar(args, dev):
    """``--bar``: ``make_tet_step`` over ``--steps-per-call`` steps
    (``bench.py:482-580``)."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    w, h, d = args.bar_dims
    state, cset = bar_scene(args.bar_dims, dev)
    cfg = StepConfig()
    step = gtc.make_tet_step(
        cset.grid_tets[0], state.particles.inv_mass, dt=cfg.dt,
        substeps=cfg.substeps, max_iterations=cfg.max_iterations,
        n_steps=args.steps_per_call, device=dev)
    xv = list(step(state.particles.x, state.particles.v))  # warm-up
    _sync(dev)
    if not torch.isfinite(xv[0]).all():
        raise FloatingPointError("bar warm-up produced non-finite x")

    def call():
        xv[:] = step(*xv)

    dt = _timed(dev, call, args.calls)
    sps = args.calls * args.steps_per_call / dt
    return _record(
        dev, f"xpbd_fem_bar_{w * h * d // 1000}k_steps_per_s", sps,
        "steps/s", "cuda_kernel" if dev.type == "cuda" else "torch_plain")


def bench_fluid(args, dev):
    """``--fluid``: ``make_fluid_step_fn`` on the dam, one probe step, then
    ``--calls`` × ``--steps-per-call`` steps (``bench.py:439-480``)."""
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    scene, fluid = dam_scene(args.fluid_dims, dev)
    state = [fm.FluidState.create(fluid, device=dev)]
    fn = fm.make_fluid_step_fn(scene, device=dev)

    def call():
        state[0] = fn(state[0])

    call()                                                # probe
    _sync(dev)
    if not torch.isfinite(state[0].x).all():
        raise FloatingPointError("fluid probe produced non-finite x")
    steps = args.calls * args.steps_per_call
    sps = steps / _timed(dev, call, steps)
    return _record(dev, f"pbf_dam_{len(fluid) // 1000}k_steps_per_s", sps,
                   "steps/s", fn.path,
                   capacity_overflow=state[0].overflow.item(),
                   n_fluid=len(fluid),
                   n_boundary=scene.boundary_x.shape[0])


def bench_pile_big(args, dev):
    """``--pile-big``: the sphere pile through ``make_step_fn(pipeline=)``,
    one probe step, then ``--calls`` × ``--steps-per-call`` steps
    (``bench.py:180-227``)."""
    from positionbaseddynamics_tpu_torch.solver import (StepConfig,
                                                        make_step_fn)

    state, cset, pipe = pile_scene(args.pile_bodies, dev)
    fn = make_step_fn(cset, StepConfig(), dev, pipeline=pipe)
    st = [fn(state)]                                      # probe
    _sync(dev)
    if not torch.isfinite(st[0].rigid.x).all():
        raise FloatingPointError("pile probe produced non-finite x")

    def call():
        st[0] = fn(st[0])

    steps = args.calls * args.steps_per_call
    sps = steps / _timed(dev, call, steps)
    return _record(dev, f"rigid_pile_{args.pile_bodies}body_steps_per_s",
                   sps, "steps/s", "batched_broadphase",
                   capacity_overflow=st[0].overflow.item())


ROD_POINTS = 51          # bench.py --rods: 51 points, 50 segments a rod
TREE_SEGMENTS = 101      # bench.py --rods --tree at --rod-batch >= 512


def rod_scene(n_rods, device, structured=True, n_points=ROD_POINTS):
    """``bench.py --rods``' scene (``bench.py:396-416``): ``n_rods``
    straight rods of ``n_points`` along x at 0.02 spacing in y, each root
    particle and frame pinned, stretch-shear (1, 1, 1) and bend-twist
    (0.5, 0.5, 0.5); the rod lattice unless ``structured`` is False."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    b = SceneBuilder(use_structured_grid=structured)
    for r in range(n_rods):
        pts = np.stack([np.linspace(0.0, 1.0, n_points),
                        np.full(n_points, 0.02 * r), np.zeros(n_points)], 1)
        lm = b.add_line_model(pts)
        b.set_mass(lm.offset, 0.0)
        b.set_quaternion_mass(lm.offset_q, 0.0)
        b.add_rod_constraints(lm, stretch_stiffness=(1.0, 1.0, 1.0),
                              bend_twist_stiffness=(0.5, 0.5, 0.5))
    return b.build(device=device)


def tree_scene(n_seg, device, solver="tree", seed=0):
    """``bench.py --rods --tree``'s scene (``bench.py:336-371``): a random
    tree of ``n_seg`` stiff-rod segments (r 0.05, length 0.3, density
    1000, E = G = 1e6) from ``default_rng(seed)``, segment i hung from a
    random earlier one in a random direction, the root static, its
    solver forced to ``solver``."""
    import dataclasses

    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    rng = np.random.default_rng(seed)
    seg_len, radius, density = 0.3, 0.05, 1000.0
    mass = density * np.pi * radius**2 * seg_len
    ix = 0.5 * mass * radius**2
    iyz = mass * (3 * radius**2 + seg_len**2) / 12.0
    b = SceneBuilder()
    bodies = [b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0,
                               inertia=(ix, iyz, iyz))]
    centers = [np.zeros(3)]
    edges, positions = [], []
    for i in range(1, n_seg):
        parent = int(rng.integers(0, i))
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        joint = centers[parent] + 0.5 * seg_len * d
        c = joint + 0.5 * seg_len * d
        centers.append(c)
        bodies.append(b.add_rigid_body(tuple(c), mass=mass,
                                       inertia=(ix, iyz, iyz)))
        edges.append((parent, i))
        positions.append(tuple(joint))
    b.add_direct_rod_tree(bodies, edges, positions, radius, seg_len, 1e6,
                          1e6)
    state, cset = b.build(device=device)
    db = cset.direct_rods[0]
    return state, dataclasses.replace(cset, direct_rods=(
        dataclasses.replace(db, solver=solver),))


def _bench_steps(args, dev, state, fn, finite):
    """One probe step (its ``finite(state)`` checked), then ``--calls`` ×
    ``--steps-per-call`` steps timed. Returns ``(steps/s, state)``."""
    st = [fn(state)]
    _sync(dev)
    if not finite(st[0]):
        raise FloatingPointError("the probe step produced non-finite values")

    def call():
        st[0] = fn(st[0])

    steps = args.calls * args.steps_per_call
    return steps / _timed(dev, call, steps), st[0]


def bench_rods(args, dev):
    """``--rods``: ``--rod-batch`` Cosserat rods of 51 points stepped as one
    scene (``bench.py:396-435``)."""
    from positionbaseddynamics_tpu_torch.solver import (StepConfig,
                                                        make_step_fn)

    state, cset = rod_scene(args.rod_batch, dev)
    path = "rod_lattice" if cset.rod_lattices else "unstructured"
    fn = make_step_fn(cset, StepConfig(), dev)
    sps, _ = _bench_steps(args, dev, state, fn,
                          lambda s: bool(torch.isfinite(s.particles.x).all()))
    return _record(dev, f"cosserat_rods_x{args.rod_batch}_steps_per_s", sps,
                   "steps/s", path,
                   aggregate_rod_steps_per_s=round(sps * args.rod_batch, 1))


def bench_tree(args, dev):
    """``--tree`` (``bench.py --rods --tree``): the random stiff-rod tree of
    101 segments (``--rod-batch`` segments below 512), solved by the
    scheduled tree elimination (``bench.py:336-393``)."""
    from positionbaseddynamics_tpu_torch.solver import (StepConfig,
                                                        make_step_fn)

    n_seg = args.rod_batch if args.rod_batch < 512 else TREE_SEGMENTS
    state, cset = tree_scene(n_seg, dev)
    fn = make_step_fn(cset, StepConfig(), dev)
    sps, _ = _bench_steps(args, dev, state, fn,
                          lambda s: bool(torch.isfinite(s.rigid.x).all()))
    return _record(dev, f"stiff_rod_tree_{n_seg - 1}c_steps_per_s", sps,
                   "steps/s", "tree_scheduled")


def make_mpc(k, horizon, dev, n=32, free_weight=None):
    """``bench.py --mpc``'s planner (``bench.py:19-50``): an n×n cloth
    (32×32 in ``bench.py``), its first corner pinned and dragged by a
    velocity command (at most 2 m/s), ``StepConfig(dt=0.01, substeps=2,
    damping=0.01)``; cost 1e-3·|u|² a step plus the pin's squared distance
    to a target 0.5 right and up of it. That cost reads only what the
    command sets; ``free_weight`` adds ``free_weight`` times the free
    corner's squared distance to the target each step, so that the cost
    depends on the rollouts' dynamics (for checks; ``bench.py`` has no such
    term). Returns ``(state, seq_cost, mcfg)``."""
    from positionbaseddynamics_tpu_torch import mpc
    from positionbaseddynamics_tpu_torch.solver import StepConfig

    state, cset = planner_cloth(n, dev, scale=(1.0, 1.0))
    cfg = StepConfig(dt=0.01, substeps=2, damping=0.01)
    ctrl = mpc.PinVelocityControl(indices=(0,), max_speed=2.0)
    target = (state.particles.x[0].cpu()
              + torch.tensor([0.5, 0.5, 0.0])).numpy()
    running = mpc.control_effort(1e-3)
    if free_weight is not None:
        running = mpc.combine(running, mpc.as_running(mpc.particle_target(
            [n * n - 1], target, weight=free_weight)))
    seq_cost = mpc.make_sequence_cost(
        cset, cfg, ctrl, running_cost=running,
        terminal_cost=mpc.particle_target([0], target), device=dev)
    mcfg = mpc.MPPIConfig(horizon=horizon, num_samples=k, plan_iters=1)
    return state, seq_cost, mcfg


def bench_mpc(args, dev):
    """``--mpc``: MPPI updates per second × K rollouts
    (``bench.py:19-67``)."""
    from positionbaseddynamics_tpu_torch import mpc

    k, hz = args.mpc_samples, args.mpc_horizon
    state, seq_cost, mcfg = make_mpc(k, hz, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    nominal = [torch.zeros((hz, 3), dtype=torch.float32, device=dev)]

    def call():
        nominal[0] = mpc.mppi_update(state, nominal[0], seq_cost, mcfg,
                                     generator=gen)[0]

    call()                                                # warm-up
    dt = _timed(dev, call, args.calls)
    if not torch.isfinite(nominal[0]).all():
        raise FloatingPointError("MPPI produced a non-finite nominal")
    rps = args.calls * k / dt
    return _record(dev, f"mppi_cloth1k_rollouts_per_s_k{k}_h{hz}", rps,
                   "rollouts/s", seq_cost.path)


class MpcBig:
    """``bench.py --mpc-big``'s planner (``bench.py:70-145``): MPPI whose
    K rollouts of ``horizon`` steps are the fused cloth substep at
    ``n_batch = K`` on a ``width``×``width`` cloth of scale 2×2, its first
    corner pinned and dragged by a velocity command clipped elementwise to
    ±2 m/s (not by norm, as ``bench.py`` does it); cost 1e-3·|u|² a step
    plus the free corner's squared distance to a target 0.5 right and up
    of the pin; σ 1, λ 0.1, softmax weights. ``update(nominal, eps)``
    returns the new nominal, the costs ``(K,)`` and the rollouts' final
    positions ``(K, N, 3)``; ``rollouts(u, step)`` runs any number of
    rollouts of commands ``u`` through a ``step(x, v)`` of one step, so
    that a check can replay them through the plain version."""

    SIGMA, LAM, MAX_SPEED = 1.0, 0.1, 2.0

    def __init__(self, width, k, horizon, dev):
        from positionbaseddynamics_tpu_torch.solver import StepConfig

        state, cset = planner_cloth(width, dev, scale=(2.0, 2.0))
        self.cfg = cfg = StepConfig()
        self.k, self.horizon, self.dev = k, horizon, dev
        self.grid = cset.grid_cloths[0]
        self.inv_mass = state.particles.inv_mass
        self.step = rollout_step_fn(self.grid, self.inv_mass, cfg, dev, k)
        self.x0, self.v0 = state.particles.x, state.particles.v
        self.pin, self.free = 0, width * width - 1
        self.target = self.x0[self.pin] + torch.tensor(
            [0.5, 0.5, 0.0], device=dev)

    def draw(self, generator):
        return self.SIGMA * torch.randn(
            (self.k, self.horizon, 3), generator=generator,
            dtype=torch.float32, device=self.dev)

    def controls(self, nominal, eps):
        return torch.clamp(nominal[None] + eps, -self.MAX_SPEED,
                           self.MAX_SPEED)

    def rollouts(self, u, step):
        """The final positions and costs of ``u.shape[0]`` rollouts."""
        k = u.shape[0]
        # repeat, not expand + contiguous: at k = 1 that is a view of x0,
        # and the pin's update below writes in place
        x = self.x0.repeat(k, 1, 1)
        v = self.v0.repeat(k, 1, 1)
        cost = torch.zeros((k,), dtype=torch.float32, device=self.dev)
        for t in range(self.horizon):
            x[:, self.pin] += u[:, t] * self.cfg.dt
            x, v = step(x, v)
            cost = cost + 1e-3 * torch.sum(u[:, t] ** 2, -1)
        cost = cost + torch.sum((x[:, self.free] - self.target) ** 2, -1)
        return x, cost

    def update(self, nominal, eps):
        x, cost = self.rollouts(self.controls(nominal, eps), self.step)
        w = torch.softmax(-cost / self.LAM, 0)
        return nominal + torch.einsum("k,khd->hd", w, eps), cost, x


def bench_mpc_big(args, dev):
    """``--mpc-big``: planner updates per second at K rollouts of the
    ``--width`` cloth, and the rollout-steps per second they amount to."""
    k, hz = args.mpc_samples, args.mpc_horizon
    planner = MpcBig(args.width, k, hz, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    nominal = [torch.zeros((hz, 3), dtype=torch.float32, device=dev)]

    def call():
        nominal[0] = planner.update(nominal[0], planner.draw(gen))[0]

    call()                                                # warm-up
    ups = args.calls / _timed(dev, call, args.calls)
    if not torch.isfinite(nominal[0]).all():
        raise FloatingPointError("MPPI produced a non-finite nominal")
    return _record(
        dev, f"mppi_cloth{args.width * args.width // 1000}k_planner_updates"
        f"_per_s_k{k}_h{hz}", ups, "planner updates/s",
        "cuda_per_substep" if dev.type == "cuda" else "torch_plain",
        per_s=ups * k * hz, aggregate_steps_per_s=round(ups * k * hz, 1))


def check(args, dev):
    """``--check``: each kernel against its plain version on the card over
    10 steps, at the bench scenes (``bench.py --check``): the cloth (B1) at
    1e-5 max|Δx|, the bar (B2) at 1e-5, the dam's step (B3–B5) at 1e-4.
    Returns the records; ``ok`` is False beyond a bar."""
    from positionbaseddynamics_tpu_torch.fluids import model as fm
    from positionbaseddynamics_tpu_torch.solver import StepConfig
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    out = []

    def record(name, kernel, plain):
        dev_ = (kernel - plain).abs().max().item()
        out.append({"metric": f"{name}_cuda_vs_plain_10step_dev",
                    "value": dev_, "unit": "max |dx|",
                    "tolerance": CHECK_TOL[name],
                    "ok": bool(dev_ <= CHECK_TOL[name]),
                    "device": torch.cuda.get_device_name(dev),
                    "card": card_line(dev)})

    cfg = StepConfig()
    state, cset = cloth_scene(args.width, args.height, dev)
    p, gc = state.particles, cset.grid_cloths[0]
    xk, _ = cloth_step_fn(gc, p.inv_mass, cfg, dev, n_steps=10)(p.x, p.v)
    x, _ = plain_steps(gc, p.x, p.v, p.inv_mass,
                                  10 * cfg.substeps, cfg.dt / cfg.substeps)
    record("cloth", xk, x)

    state, cset = bar_scene(args.bar_dims, dev)
    p, gt = state.particles, cset.grid_tets[0]
    xk, _ = gtc.make_tet_step(gt, p.inv_mass, dt=cfg.dt,
                              substeps=cfg.substeps,
                              max_iterations=cfg.max_iterations, n_steps=10,
                              device=dev)(p.x, p.v)
    x, v = p.x, p.v
    for _ in range(10 * cfg.substeps):
        x, v = gtc.tet_substep_reference(
            gt, x, v, p.inv_mass, h=cfg.dt / cfg.substeps,
            max_iterations=cfg.max_iterations)
    record("tet", xk, x)

    scene, fluid = dam_scene(args.fluid_dims, dev)
    fn = fm.make_fluid_step_fn(scene, device=dev)
    sk = sp = fm.FluidState.create(fluid, device=dev)
    for _ in range(10):
        sk = fn(sk)
        sp = fm.fluid_step_reference(sp, scene, chunk=PLAIN_CHUNK)
    record("fluid", sk.x, sp.x)
    return out


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain "
                         "PyTorch versions")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--steps-per-call", type=int, default=20)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--mpc", action="store_true")
    ap.add_argument("--mpc-big", action="store_true")
    ap.add_argument("--mpc-samples", type=int, default=256)
    ap.add_argument("--mpc-horizon", type=int, default=10)
    ap.add_argument("--bar", action="store_true")
    ap.add_argument("--bar-dims", type=int, nargs=3, default=(80, 36, 36))
    ap.add_argument("--fluid", action="store_true")
    ap.add_argument("--fluid-dims", type=int, nargs=3, default=(80, 50, 25))
    ap.add_argument("--pile-big", action="store_true")
    ap.add_argument("--pile-bodies", type=int, default=100)
    ap.add_argument("--rods", action="store_true")
    ap.add_argument("--rod-batch", type=int, default=1024)
    ap.add_argument("--tree", action="store_true",
                    help="the stiff-rod tree (bench.py --rods --tree)")
    ap.add_argument("--check", action="store_true")
    for name in UNPORTED:
        ap.add_argument("--" + name.replace("_", "-"), action="store_true",
                        help="not ported yet: needs " + UNPORTED[name])
    return ap


def run(argv=None):
    """Parse ``argv`` and run the mode. Returns ``(exit code, records)``;
    a refusal is written to standard error."""
    args = parser().parse_args(argv)
    for name, needs in UNPORTED.items():
        if getattr(args, name):
            print(f"bench_torch: --{name.replace('_', '-')} is not ported "
                  f"yet; it needs {needs}", file=sys.stderr)
            return 2, []
    from positionbaseddynamics_tpu_torch._device import resolve_device

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: CUDA is not available; the port runs on the "
              "card (--device cpu runs the plain versions)", file=sys.stderr)
        return 1, []
    dev = resolve_device(dev)
    if args.check:
        if dev.type != "cuda":
            print("bench_torch: --check holds the CUDA kernels against "
                  "their plain versions; on the CPU there is no kernel",
                  file=sys.stderr)
            return 2, []
        records = check(args, dev)
        return (0 if all(r["ok"] for r in records) else 1), records
    for flag, fn in (("mpc", bench_mpc), ("mpc_big", bench_mpc_big),
                     ("tree", bench_tree), ("rods", bench_rods),
                     ("fluid", bench_fluid), ("bar", bench_bar),
                     ("pile_big", bench_pile_big)):
        if getattr(args, flag):
            return 0, [fn(args, dev)]
    return 0, [bench_cloth(args, dev)]


def main(argv=None) -> int:
    code, records = run(argv)
    for r in records:
        print(json.dumps(r), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
