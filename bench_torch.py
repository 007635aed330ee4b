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
    python3 bench_torch.py --pile [--scene F]    # a scene file, headless
    python3 bench_torch.py --armadillo-batch     # 32 rollouts of the contact
    python3 bench_torch.py --mpc-contact         # MPPI over the contact scene

Every line carries ``metric``, ``value``, ``unit`` and ``vs_baseline``
(the mode's steps/s per rollout, or ``--mpc-big``'s rollout-steps/s, over
the north-star 60 steps/s, as ``bench.py`` computes it), the extra keys that
``bench.py`` prints for the mode, ``"path"`` (``"cuda_fused"``: the cloth
kernel with a step's substeps fused into one launch, ``bench.py``'s
default; ``"cuda_per_substep"``: one launch a substep, ``--no-fuse`` and
``--mpc-big``; ``"cuda_kernel"``: the
bar's and the dam's kernels; a ``"torch_..."`` name for the plain
routes; ``"batched_broadphase"``: ``--pile-big``'s, ``"rod_lattice"``
or ``"unstructured"``: ``--rods``', ``"tree_scheduled"``: ``--tree``'s,
as ``bench.py`` names them; the route ``make_step_fn`` took for the
scene-file modes), ``"device"`` and ``"card"``, the card's
``nvidia-smi
--query-gpu=name,power.limit`` line (None on the CPU).

The port runs on the card: ``--device`` defaults to ``cuda`` and the
script exits 1 without CUDA. ``--device cpu`` runs the plain PyTorch
versions at whatever size is given, for tests; ``--check`` has nothing to
check there and exits 2. The scene-file modes read
``data/scenes/PileScene.json`` and ``ArmadilloCollisionScene.json`` unless
``--scene`` names another file; the shipped files are not in the
repository, so without ``--scene`` they exit 2 and name the missing file.
``write_pile_scene``, ``write_contact_scene`` and ``write_cloth_scene``
write stand-ins of the shipped scenes' structure and size, meshes
included. ``--fuse`` (the default) and ``--no-fuse`` choose the cloth
kernel's mode for the default cloth mode, ``--batch`` and ``--check``, as
in ``bench.py``, and the tet kernel's for ``--bar`` and ``--check``
(``"cuda_fused"``: one launch a step; ``"cuda_per_iteration"``: one
launch an iteration of each substep).

Every option of ``bench.py`` means the same here. ``--max-iterations N``
sets the solver's iterations for the cloth, ``--batch``, the bar and
``--check``, and the bar's metric gains ``_it{N}`` for N ≠ 1, as
``bench.py`` names its kernel route; the port runs the tet kernel at any
N (``bench.py`` sends N > 1 to its XLA path for a fault of its TPU kernel
that the port's does not share: the tet kernel is held to its plain
version at 2 iterations). ``--pallas`` (the default) takes the kernel
routes; ``--no-pallas`` runs the cloth or the bar through the general
stepper, ``solver.rollout(..., kernels=False)`` over ``--steps-per-call``
steps, ``--batch`` > 1 as a leading rollout axis, the path named as
``make_step_fn`` names it; there is no fallback from the kernel route.
On that route ``--timers`` prints ``PhaseTimers``' report on standard
error (batch 1) and ``--profile DIR`` writes a ``torch.profiler`` Chrome
trace of the timed loop into DIR; the kernel route ignores both with a
warning. ``--donate`` warns that PyTorch has no buffer donation. The
default cloth run first prints ``bench.py``'s four secondary lines (the
bar, the 12k dam, the 100-body pile and the contact planner, each under a
watchdog, an error written as ``{"metric", "error"}``), the headline
last, unless ``--no-secondary`` or ``--check`` is given.

The bench scenes (``cloth_scene``, ``bar_scene``, ``dam_scene``,
``pile_scene``, the planners' cloth, the stand-in scene files) and the
cloth kernel's plain steps live here;
``chip_smoke.py`` and ``scripts/`` import them from this file.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

CHECK_TOL = {"cloth": 1e-5, "tet": 1e-5, "fluid": 1e-4}
PLAIN_CHUNK = 2048      # active cells per piece of the plain fluid passes
SECONDARY_BUDGET_S = 700.0      # all secondary lines together (bench.py's)
SECONDARY_EACH_S = 420          # one secondary line's watchdog
SECONDARY_MIN_S = 30.0          # below this much budget a line is skipped
TRACE_FILE = "bench_torch_trace.json"   # --profile's file in DIR


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
# stand-in scenes (the shipped scene files are not in the repository)
# ---------------------------------------------------------------------------

#: where the shipped reference scenes belong, relative to the repository
SHIPPED_SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "scenes")
PILE_SCENE = os.path.join(SHIPPED_SCENES, "PileScene.json")
CONTACT_SCENE = os.path.join(SHIPPED_SCENES, "ArmadilloCollisionScene.json")
SCENE_SDF_RESOLUTION = 14       # bench.py's max_sdf_resolution
CONTACT_DIMS = (20, 8, 8)       # 1,280 vertices, 4,655 tets a stand-in model


def _write_obj(path, verts, faces, uvs=None):
    """An OBJ file; ``faces`` rows of 3 or 4 corners, with ``uvs`` one
    texture coordinate a vertex (``f v/vt``)."""
    with open(path, "w") as f:
        f.write("# generated stand-in mesh\n")
        for v in np.asarray(verts, np.float64).tolist():
            f.write(f"v {v[0]!r} {v[1]!r} {v[2]!r}\n")
        if uvs is not None:
            for t in np.asarray(uvs, np.float64).tolist():
                f.write(f"vt {t[0]!r} {t[1]!r}\n")
        for row in faces:
            f.write("f " + " ".join(
                f"{i + 1}/{i + 1}" if uvs is not None else f"{i + 1}"
                for i in row) + "\n")


def _cube_mesh():
    """The unit cube, half extent 0.5, 12 outward-wound triangles."""
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                  for z in (-0.5, 0.5)])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return v, f


def _cylinder_mesh(segments=32):
    """A closed y-axis cylinder of radius 1 and height 1 (y in ±0.5): the
    side as quads, each cap a fan around its centre, wound outward."""
    a = 2.0 * np.pi * np.arange(segments) / segments
    ring = np.stack([np.cos(a), np.zeros(segments), np.sin(a)], 1)
    v = np.concatenate([ring - [0, 0.5, 0], ring + [0, 0.5, 0],
                        [[0, -0.5, 0], [0, 0.5, 0]]])
    lo, hi, cb, ct = 0, segments, 2 * segments, 2 * segments + 1
    f = []
    for i in range(segments):
        j = (i + 1) % segments
        f.append([lo + i, hi + i, hi + j, lo + j])
        f.append([cb, lo + i, lo + j])
        f.append([ct, hi + j, hi + i])
    return v, f


def _icosphere(subdivisions=3):
    """The unit icosphere: 20·4^s outward-wound faces (1,280 at s = 3)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
         [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
         [-t, 0, -1], [-t, 0, 1]]
    v = [list(np.asarray(p, float) / np.linalg.norm(p)) for p in v]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdivisions):
        mid, nf = {}, []

        def m(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                p = np.asarray(v[i]) + np.asarray(v[j])
                v.append(list(p / np.linalg.norm(p)))
                mid[key] = len(v) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    return np.asarray(v), np.asarray(f)


def _write_tetgen(stem, dims):
    """``stem.node`` / ``stem.ele``, 1-based with comments, of a regular
    tet grid of ``dims`` vertices over the unit box centred at the origin
    (5 tets a cell)."""
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_tet_grid)

    pts, tets = regular_tet_grid(*dims)
    with open(stem + ".node", "w") as f:
        f.write("# generated stand-in tet model\n")
        f.write(f"{len(pts)} 3 0 0\n")
        for i, p in enumerate(pts.tolist()):
            f.write(f"{i + 1} {p[0]!r} {p[1]!r} {p[2]!r}\n")
    with open(stem + ".ele", "w") as f:
        f.write(f"{len(tets)} 4 0\n")
        for i, t in enumerate(tets):
            f.write(f"{i + 1} {t[0] + 1} {t[1] + 1} {t[2] + 1} {t[3] + 1}\n")
        f.write("# generated\n")
    return len(pts), len(tets)


def _scene_dirs(directory):
    scenes = os.path.join(directory, "scenes")
    models = os.path.join(directory, "models")
    os.makedirs(scenes, exist_ok=True)
    os.makedirs(models, exist_ok=True)
    return scenes, models


def _floor(body_id, half_y=0.5, width=20.0):
    """A static box floor from ``cube.obj``, its top at y 0."""
    return {"id": body_id, "geometryFile": "../models/cube.obj",
            "translation": [0.0, -half_y, 0.0],
            "scale": [width, 2 * half_y, width], "isDynamic": 0,
            "density": 1000, "collisionObjectType": 2,
            "collisionObjectScale": [width, 2 * half_y, width],
            "restitution": 0.6, "friction": 0.2}


def write_pile_scene(directory, grid=5, missing=6):
    """PileScene's structure (``tests/test_scene_loader.py:33-52``) written
    into ``directory``: ``scenes/PileScene.json`` and its generated meshes
    under ``models/``. A static box floor, ``grid``² static cylinders
    (``cylinder.obj``, radius 0.3, height 1.5, ``collisionObjectType`` 3),
    two dynamic bodies from a 1,280-face icosphere (radius 0.35,
    ``collisionObjectType`` 5, so that their SDF is baked) dropped onto
    the cylinders, and ``missing`` bodies whose ``armadillo.obj`` is not
    written, so that the loader skips them. ``Simulation``: time step
    0.005, ``maxIter`` 5. Returns the JSON's path."""
    scenes, models = _scene_dirs(directory)
    _write_obj(os.path.join(models, "cube.obj"), *_cube_mesh())
    _write_obj(os.path.join(models, "cylinder.obj"), *_cylinder_mesh())
    _write_obj(os.path.join(models, "sphere.obj"), *_icosphere())
    bodies = [_floor(0)]
    for i in range(grid * grid):
        gx, gz = i % grid, i // grid
        bodies.append({
            "id": len(bodies), "geometryFile": "../models/cylinder.obj",
            "translation": [0.8 * (gx - (grid - 1) / 2), 0.75,
                            0.8 * (gz - (grid - 1) / 2)],
            "scale": [0.3, 1.5, 0.3], "isDynamic": 0, "density": 1000,
            "collisionObjectType": 3, "collisionObjectScale": [0.3, 1.5],
            "restitution": 0.6, "friction": 0.2})
    for i in range(2):
        bodies.append({
            "id": len(bodies), "geometryFile": "../models/sphere.obj",
            "translation": [0.4 * i - 0.2, 1.88 + 0.9 * i, 0.15 * i],
            "rotationAxis": [0, 0, 1], "rotationAngle": 0.3 * i,
            "scale": [0.35, 0.35, 0.35], "isDynamic": 1, "density": 500,
            "collisionObjectType": 5,
            "collisionObjectScale": [1.0, 1.0, 1.0],
            "resolutionSDF": [30, 30, 30], "restitution": 0.4,
            "friction": 0.2})
    for i in range(missing):
        bodies.append({
            "id": len(bodies), "geometryFile": "../models/armadillo.obj",
            "translation": [0.5 * i - 1.25, 4.0, 0.0], "isDynamic": 1,
            "density": 500, "collisionObjectType": 5})
    data = {"Name": "PileScene",
            "Simulation": {"timeStepSize": 0.005, "maxIter": 5,
                           "maxIterVel": 5, "velocityUpdateMethod": 0,
                           "contactTolerance": 0.01},
            "RigidBodies": bodies}
    path = os.path.join(scenes, "PileScene.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return path


def write_contact_scene(directory, dims=CONTACT_DIMS, models_n=3):
    """ArmadilloCollisionScene's structure (``bench.py:267-272``) written
    into ``directory``: ``models_n`` tet models stacked above a static box
    floor, each a ``dims`` regular tet grid read from generated
    ``.node``/``.ele`` files (1,280 vertices and 4,655 tets at 20×8×8,
    close to the armadillo's 1,180 vertices), ``collisionObjectType`` 5 on
    each so that the solid–solid contacts are built, classic FEM tets
    (``tetModelSimulationMethod`` 2). Returns the JSON's path."""
    scenes, models = _scene_dirs(directory)
    _write_obj(os.path.join(models, "cube.obj"), *_cube_mesh())
    _write_tetgen(os.path.join(models, "bar"), dims)
    tets = []
    for i in range(models_n):
        tets.append({
            "id": i, "nodeFile": "../models/bar.node",
            "eleFile": "../models/bar.ele",
            "translation": [-0.5 + 0.1 * i, 0.3 + 0.55 * i, -0.2 + 0.05 * i],
            "rotationAxis": [0, 1, 0], "rotationAngle": 0.4 * i,
            "scale": [1.0, 0.4, 0.4], "collisionObjectType": 5,
            "resolutionSDF": [20, 20, 20], "restitution": 0.1,
            "friction": 0.2})
    data = {"Name": "ArmadilloCollisionScene",
            "Simulation": {"timeStepSize": 0.005, "subSteps": 5,
                           "maxIter": 1, "maxIterVel": 5,
                           "tetModelSimulationMethod": 2,
                           "solid_stiffness": 1.0,
                           "solid_poissonRatio": 0.3,
                           "contactTolerance": 0.01},
            "RigidBodies": [_floor(0)],
            "TetModels": tets}
    path = os.path.join(scenes, "ArmadilloCollisionScene.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return path


def write_cloth_scene(directory, n=51, xpbd=False):
    """ClothOnBunny's structure (``tests/test_scene_loader.py:86-99``)
    written into ``directory``: an n×n-vertex plane OBJ of quads with one
    texture coordinate a vertex as a triangle model, its two corners of
    the first row static, 0.3 above a static body (the 1,280-face
    icosphere at radius 0.8) whose SDF is baked. The cloth takes the
    loader's default methods, FEM triangles and classic isometric bending
    at their default stiffnesses, or with ``xpbd`` XPBD distance (1e5) and
    XPBD isometric bending (0.05), the bench cloth's methods, through the
    ``triangleModel…`` aliases. Returns the JSON's path."""
    scenes, models = _scene_dirs(directory)
    u = np.linspace(0.0, 1.0, n)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([uu.ravel() - 0.5, np.zeros(n * n),
                      vv.ravel() - 0.5], 1)
    idx = np.arange(n * n).reshape(n, n)
    quads = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, 1:],
                      idx[1:, :-1]], -1).reshape(-1, 4)
    _write_obj(os.path.join(models, "plane.obj"), verts, quads,
               uvs=np.stack([uu.ravel(), vv.ravel()], 1))
    _write_obj(os.path.join(models, "sphere.obj"), *_icosphere())
    data = {"Name": "ClothOnBunny",
            "Simulation": dict({"timeStepSize": 0.005, "maxIter": 5,
                                "contactTolerance": 0.02}, **(
                {"triangleModelSimulationMethod": 4,
                 "triangleModelBendingMethod": 3,
                 "cloth_stiffness": 1e5,
                 "cloth_bendingStiffness": 0.05} if xpbd else {})),
            "RigidBodies": [{
                "id": 0, "geometryFile": "../models/sphere.obj",
                "translation": [0.0, 0.0, 0.0], "scale": [0.8, 0.8, 0.8],
                "isDynamic": 0, "collisionObjectType": 5,
                "collisionObjectScale": [1.0, 1.0, 1.0],
                "resolutionSDF": [30, 30, 30], "friction": 0.2}],
            "TriangleModels": [{
                "id": 0, "geometryFile": "../models/plane.obj",
                "translation": [0.1, 0.84, 0.05], "scale": [3.0, 1.0, 3.0],
                "staticParticles": [0, n - 1], "restitution": 0.1,
                "friction": 0.2}]}
    path = os.path.join(scenes, "ClothOnBunny.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


def _warn(msg):
    print(f"warning: {msg}", file=sys.stderr)


def _kernel_route_warnings(args):
    """``bench.py``'s warnings for options that the kernel route ignores
    (``bench.py:795-803``), and why ``--donate`` does nothing here."""
    for flag in ("timers", "profile"):
        if getattr(args, flag):
            _warn(f"--{flag} is ignored on the kernel route (use "
                  "--no-pallas)")
    _donate_warning(args)


def _donate_warning(args):
    if args.donate:
        _warn("--donate does nothing: PyTorch has no buffer donation; the "
              "steps allocate their outputs from the caching allocator")


def bench_general(args, dev, scene, metric, finite):
    """``--no-pallas``: ``solver.rollout(..., kernels=False)`` over
    ``--steps-per-call`` steps of ``scene`` (``(state, cset)``), the
    rollouts a leading axis at ``--batch`` > 1; one warm-up call, then
    ``--calls`` calls timed, under ``torch.profiler`` with ``--profile``;
    ``--timers`` at batch 1 (``bench.py:853-914``). The path is
    ``make_step_fn``'s name for the route."""
    from positionbaseddynamics_tpu_torch.mpc.planners import _expand_state
    from positionbaseddynamics_tpu_torch.solver import (StepConfig,
                                                        make_step_fn, rollout)

    _donate_warning(args)
    state, cset = scene
    cfg = StepConfig(max_iterations=args.max_iterations)
    if args.batch > 1:
        state = _expand_state(state, args.batch)
    st = [rollout(state, cset, cfg, args.steps_per_call,
                  kernels=False)[0]]                       # warm-up
    _sync(dev)
    if not finite(st[0]):
        raise FloatingPointError("the warm-up produced non-finite values")

    def call():
        st[0] = rollout(st[0], cset, cfg, args.steps_per_call,
                        kernels=False)[0]

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            dt = _timed(dev, call, args.calls)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, TRACE_FILE)
        prof.export_chrome_trace(trace)
        print(f"bench_torch: trace of the timed loop in {trace}",
              file=sys.stderr)
    else:
        dt = _timed(dev, call, args.calls)
    sps = args.calls * args.steps_per_call / dt
    extra = ({"aggregate_steps_per_s": round(sps * args.batch, 2)}
             if args.batch > 1 else {})
    path = make_step_fn(cset, cfg, dev, kernels=False).path
    rec = _record(dev, metric + (f"_b{args.batch}" if args.batch > 1
                                 else ""), sps, "steps/s", path, **extra)
    if args.timers and args.batch == 1:
        from positionbaseddynamics_tpu_torch.utils.timing import PhaseTimers

        timers = PhaseTimers(cset, cfg, device=dev)
        timers.measure(st[0], repeats=3)
        print(timers.report(), file=sys.stderr)
    return rec


def bench_cloth(args, dev):
    """The default mode and ``--batch N``: ``make_cloth_step`` over
    ``--steps-per-call`` steps, one warm-up call, then ``--calls`` calls
    (``bench.py:780-814``); ``--no-pallas``: :func:`bench_general`."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig

    metric = f"xpbd_cloth_{args.width * args.height // 1000}k_steps_per_s"
    if args.pallas is False:
        return bench_general(
            args, dev, cloth_scene(args.width, args.height, dev), metric,
            lambda s: bool(torch.isfinite(s.particles.x).all()))
    _kernel_route_warnings(args)
    state, cset = cloth_scene(args.width, args.height, dev)
    cfg = StepConfig(max_iterations=args.max_iterations)
    step = cloth_step_fn(cset.grid_cloths[0], state.particles.inv_mass, cfg,
                         dev, n_batch=args.batch, n_steps=args.steps_per_call,
                         fuse_substeps=args.fuse)
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
        dev, metric + (f"_b{args.batch}" if args.batch > 1 else ""), sps,
        "steps/s",
        ("cuda_fused" if args.fuse else "cuda_per_substep")
        if dev.type == "cuda" else "torch_plain",
        **extra)


def bench_bar(args, dev):
    """``--bar``: ``make_tet_step`` over ``--steps-per-call`` steps
    (``bench.py:482-580``), one launch a step with ``--fuse`` (the
    default), one an iteration with ``--no-fuse``; ``--no-pallas``:
    :func:`bench_general`."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    w, h, d = args.bar_dims
    metric = f"xpbd_fem_bar_{w * h * d // 1000}k_steps_per_s"
    if args.pallas is False:
        return bench_general(
            args, dev, bar_scene(args.bar_dims, dev), metric,
            lambda s: bool(torch.isfinite(s.particles.x).all()))
    _kernel_route_warnings(args)
    state, cset = bar_scene(args.bar_dims, dev)
    cfg = StepConfig(max_iterations=args.max_iterations)
    step = gtc.make_tet_step(
        cset.grid_tets[0], state.particles.inv_mass, dt=cfg.dt,
        substeps=cfg.substeps, max_iterations=cfg.max_iterations,
        n_steps=args.steps_per_call, fuse_substeps=args.fuse, device=dev)
    xv = list(step(state.particles.x, state.particles.v))  # warm-up
    _sync(dev)
    if not torch.isfinite(xv[0]).all():
        raise FloatingPointError("bar warm-up produced non-finite x")

    def call():
        xv[:] = step(*xv)

    dt = _timed(dev, call, args.calls)
    sps = args.calls * args.steps_per_call / dt
    return _record(
        dev, metric + (f"_it{cfg.max_iterations}"
                       if cfg.max_iterations != 1 else ""), sps, "steps/s",
        ("cuda_fused" if args.fuse else "cuda_per_iteration")
        if dev.type == "cuda" else "torch_plain")


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


def _bench_steps(steps, dev, state, fn, finite):
    """One probe step (its ``finite(state)`` checked), then ``steps`` steps
    timed. Returns ``(steps/s, state)``."""
    st = [fn(state)]
    _sync(dev)
    if not finite(st[0]):
        raise FloatingPointError("the probe step produced non-finite values")

    def call():
        st[0] = fn(st[0])

    return steps / _timed(dev, call, steps), st[0]


def bench_rods(args, dev):
    """``--rods``: ``--rod-batch`` Cosserat rods of 51 points stepped as one
    scene (``bench.py:396-435``)."""
    from positionbaseddynamics_tpu_torch.solver import (StepConfig,
                                                        make_step_fn)

    state, cset = rod_scene(args.rod_batch, dev)
    path = "rod_lattice" if cset.rod_lattices else "unstructured"
    fn = make_step_fn(cset, StepConfig(), dev)
    sps, _ = _bench_steps(args.calls * args.steps_per_call, dev, state, fn,
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
    sps, _ = _bench_steps(args.calls * args.steps_per_call, dev, state, fn,
                          lambda s: bool(torch.isfinite(s.rigid.x).all()))
    return _record(dev, f"stiff_rod_tree_{n_seg - 1}c_steps_per_s", sps,
                   "steps/s", "tree_scheduled")


def load_bench_scene(path, dev):
    """``load_scene(path)`` as ``bench.py`` loads its reference scenes: SDF
    bakes capped at ``SCENE_SDF_RESOLUTION`` per axis, in the loader's
    default cache."""
    from positionbaseddynamics_tpu_torch.scene import load_scene

    return load_scene(path, max_sdf_resolution=SCENE_SDF_RESOLUTION,
                      device=dev)


def bench_scene(path, dev, calls, steps_per_call):
    """``--pile [--scene PATH]``: a scene file played headless
    (``bench.py:148-177``), one probe step, then ``calls`` ×
    ``steps_per_call`` steps; metric ``scene_{name}_steps_per_s``, the
    name the file's."""
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    s = load_bench_scene(path, dev)
    name = os.path.splitext(os.path.basename(path))[0]
    fn = make_step_fn(s.cset, s.config, dev, pipeline=s.pipeline)
    sps, st = _bench_steps(
        calls * steps_per_call, dev, s.state, fn,
        lambda st: s.state.rigid is None or bool(
            torch.isfinite(st.rigid.x).all()))
    return _record(dev, f"scene_{name}_steps_per_s", sps, "steps/s",
                   fn.path, capacity_overflow=st.overflow.item())


def armadillo_batch(path, dev, b, calls, steps_per_call, scene=None):
    """``--armadillo-batch``: ``b`` rollouts of the contact scene as a
    leading axis of one state, stepped by one ``make_step_fn`` of the
    whole pipeline (``bench.py:229-265``), steps/s per rollout. Returns
    ``(record, scene, step function, final batch state)``."""
    from positionbaseddynamics_tpu_torch.mpc.planners import _expand_state
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    s = scene or load_bench_scene(path, dev)
    fn = make_step_fn(s.cset, s.config, dev, pipeline=s.pipeline)
    sps, batch = _bench_steps(
        calls * steps_per_call, dev, _expand_state(s.state, b), fn,
        lambda st: bool(torch.isfinite(st.particles.x).all()))
    return _record(dev, f"armadillo_batch{b}_steps_per_s_per_rollout", sps,
                   "steps/s", fn.path,
                   aggregate_steps_per_s=round(sps * b, 1),
                   capacity_overflow=batch.overflow.max().item()), \
        s, fn, batch


class ContactMpc:
    """``bench.py --mpc-contact``'s inline MPPI (``bench.py:267-335``) over
    a contact scene's full step ``fn``: per horizon step the particles of
    ``model`` (a slice) take the control, clipped to ±``MAX_SPEED``, as
    their velocity, then one step; cost ``EFFORT``·|u|² a step plus the
    model's centroid's squared distance to its start + ``TARGET_OFFSET``.
    The K rollouts are a leading axis of one state, each update starts
    from ``state``; weights softmax(−cost/λ)."""

    SIGMA, LAM, MAX_SPEED, EFFORT = 0.5, 0.1, 2.0, 1e-3
    TARGET_OFFSET = (1.5, -0.5, 0.0)

    def __init__(self, state, fn, model, k, horizon, dev):
        self.state, self.fn, self.model = state, fn, model
        self.k, self.horizon, self.dev = k, horizon, dev
        self.target = (state.particles.x[model].mean(0)
                       + torch.tensor(self.TARGET_OFFSET, device=dev))
        # the largest overflow counter of any rollout so far, on the card
        self.overflow = torch.zeros((), device=dev)

    def draw(self, generator):
        return self.SIGMA * torch.randn((self.k, self.horizon, 3),
                                        generator=generator, device=self.dev)

    def rollouts(self, u):
        """Costs and final states of controls ``u (K, h, 3)`` (or one
        rollout's ``(h, 3)``)."""
        import dataclasses

        from positionbaseddynamics_tpu_torch.mpc.planners import (
            _expand_state)

        st = self.state
        if u.dim() == 3:
            st = _expand_state(st, u.shape[0])
        cost = torch.zeros(u.shape[:-2], device=self.dev)
        for t in range(u.shape[-2]):
            ut = u[..., t, :]
            p = st.particles
            v = p.v.clone()
            v[..., self.model, :] = torch.clamp(
                ut, -self.MAX_SPEED, self.MAX_SPEED)[..., None, :]
            st = self.fn(dataclasses.replace(
                st, particles=dataclasses.replace(p, v=v)))
            cost = cost + self.EFFORT * torch.sum(ut * ut, dim=-1)
        d = st.particles.x[..., self.model, :].mean(-2) - self.target
        self.overflow = torch.maximum(self.overflow, st.overflow.max())
        return cost + torch.sum(d * d, dim=-1), st

    def update(self, nominal, eps):
        """One update: ``(new nominal, costs (K,), final states)``."""
        costs, st = self.rollouts(nominal + eps)
        w = torch.softmax(-costs / self.LAM, dim=0)
        return nominal + torch.einsum("k,khd->hd", w, eps), costs, st


def mpc_contact(path, dev, mpc_samples, mpc_horizon, calls, scene=None):
    """``--mpc-contact``: :class:`ContactMpc` at K = max(samples // 32, 4),
    h = max(horizon // 2, 5), one warm-up update, then ``calls`` updates
    timed (``bench.py:267-335``). Returns ``(record, planner)``."""
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    k = max(mpc_samples // 32, 4)
    hz = max(mpc_horizon // 2, 5)
    s = scene or load_bench_scene(path, dev)
    _, h = s.tet_models[0]       # bench.py's n_model: the first model's
    planner = ContactMpc(
        s.state, make_step_fn(s.cset, s.config, dev, pipeline=s.pipeline),
        slice(h.offset, h.offset + h.mesh.n_vertices), k, hz, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cur = [torch.zeros((hz, 3), dtype=torch.float32, device=dev), None]

    def call():
        cur[0], cur[1], _ = planner.update(cur[0], planner.draw(gen))

    call()                                                # warm-up
    upd = calls / _timed(dev, call, calls)
    if not (torch.isfinite(cur[0]).all() and torch.isfinite(cur[1]).all()):
        raise FloatingPointError("MPPI produced non-finite costs")
    return _record(
        dev, f"mppi_contact_scene_updates_per_s_k{k}_h{hz}", upd,
        "planner updates/s", planner.fn.path, per_s=upd * k * hz,
        aggregate_steps_per_s=round(upd * k * hz, 1),
        capacity_overflow=planner.overflow.item(),
        scene=f"{os.path.basename(path)} (full contact pipeline)"), planner


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

    cfg = StepConfig(max_iterations=args.max_iterations)
    state, cset = cloth_scene(args.width, args.height, dev)
    p, gc = state.particles, cset.grid_cloths[0]
    xk, _ = cloth_step_fn(gc, p.inv_mass, cfg, dev, n_steps=10,
                          fuse_substeps=args.fuse)(p.x, p.v)
    x, _ = plain_steps(gc, p.x, p.v, p.inv_mass, 10 * cfg.substeps,
                       cfg.dt / cfg.substeps,
                       max_iterations=cfg.max_iterations)
    record("cloth", xk, x)

    state, cset = bar_scene(args.bar_dims, dev)
    p, gt = state.particles, cset.grid_tets[0]
    xk, _ = gtc.make_tet_step(gt, p.inv_mass, dt=cfg.dt,
                              substeps=cfg.substeps,
                              max_iterations=cfg.max_iterations, n_steps=10,
                              fuse_substeps=args.fuse, device=dev)(p.x, p.v)
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
    ap.add_argument("--max-iterations", type=int, default=1,
                    help="position iterations a substep (the reference's "
                         "maxIterations; default 1) for the cloth, "
                         "--batch, --bar and --check")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--timers", action="store_true",
                    help="with --no-pallas at batch 1: PhaseTimers' average "
                         "times a phase on standard error")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="with --no-pallas: a torch.profiler Chrome trace "
                         f"of the timed loop, DIR/{TRACE_FILE}")
    ap.add_argument("--pallas", dest="pallas", action="store_true",
                    default=None,
                    help="the kernel routes (the default; the name is "
                         "bench.py's)")
    ap.add_argument("--no-pallas", dest="pallas", action="store_false",
                    help="the cloth and the bar through the general "
                         "stepper, solver.rollout(..., kernels=False)")
    ap.add_argument("--donate", action="store_true",
                    help="accepted for bench.py's command lines; PyTorch "
                         "has no buffer donation, so it only warns")
    ap.add_argument("--no-secondary", action="store_true",
                    help="the default run prints the headline cloth line "
                         "alone, without the bar, dam, pile and contact "
                         "planner lines before it")
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
    ap.add_argument("--fuse", dest="fuse", action="store_true", default=True,
                    help="run a step's cloth substeps in one kernel launch, "
                         "and the bar's step in one (default, as bench.py)")
    ap.add_argument("--no-fuse", dest="fuse", action="store_false",
                    help="one cloth kernel launch a substep, one tet launch "
                         "an iteration of each substep")
    ap.add_argument("--pile", action="store_true",
                    help="a scene file played headless (PileScene.json "
                         "under data/scenes/ unless --scene is given)")
    ap.add_argument("--scene", default=None,
                    help="scene JSON for --pile, --armadillo-batch and "
                         "--mpc-contact")
    ap.add_argument("--armadillo-batch", action="store_true",
                    help="--batch rollouts (32 when not > 1) of the "
                         "contact scene (ArmadilloCollisionScene.json "
                         "unless --scene is given)")
    ap.add_argument("--mpc-contact", action="store_true",
                    help="MPPI over the contact scene's full step")
    return ap


def _scene_path(args):
    """The scene file of a scene mode, None for the other modes."""
    if args.pile:
        return args.scene or PILE_SCENE
    if args.armadillo_batch or args.mpc_contact:
        return args.scene or CONTACT_SCENE
    return None


def _scene_mode(args, dev, path):
    """The scene-file modes: ``(exit code, records)``."""
    if args.pile:
        return 0, [bench_scene(path, dev, args.calls, args.steps_per_call)]
    if args.armadillo_batch:
        b = args.batch if args.batch > 1 else 32
        return 0, [armadillo_batch(path, dev, b, args.calls,
                                   args.steps_per_call)[0]]
    return 0, [mpc_contact(path, dev, args.mpc_samples, args.mpc_horizon,
                           args.calls)[0]]


def _contact_line(args, dev):
    """The default run's contact planner line: ``--mpc-contact`` on
    ``--scene`` or the shipped contact scene, which must exist."""
    path = args.scene or CONTACT_SCENE
    if not os.path.exists(path):
        raise FileNotFoundError(f"the scene file {path} does not exist (the "
                                "shipped reference scenes are not in the "
                                "repository)")
    return mpc_contact(path, dev, args.mpc_samples, args.mpc_horizon,
                       args.calls)[0]


def secondary_lines(args, dev):
    """The default run's secondary records (``bench.py:694-731``), in
    ``bench.py``'s order and with its overrides and names: each mode under
    a ``SIGALRM`` watchdog of ``SECONDARY_EACH_S`` s within a
    ``SECONDARY_BUDGET_S`` s budget for all; an error, a timeout or a spent
    budget becomes ``{"metric": name, "error": ...}``."""
    lines = (
        ("xpbd_fem_bar_103k_steps_per_s", bench_bar,
         dict(calls=2, steps_per_call=10, check=False, pallas=None)),
        ("pbf_dam_12k_steps_per_s", bench_fluid,
         dict(fluid_dims=(40, 25, 12), calls=2, steps_per_call=10)),
        ("rigid_pile_100body_steps_per_s", bench_pile_big,
         dict(calls=2, steps_per_call=10, pile_bodies=100)),
        ("mppi_contact_scene_updates_per_s", _contact_line,
         dict(calls=1, mpc_samples=128, mpc_horizon=10)))
    deadline = time.perf_counter() + SECONDARY_BUDGET_S
    out = []
    for name, fn, over in lines:
        left = deadline - time.perf_counter()
        if left < SECONDARY_MIN_S:
            out.append({"metric": name,
                        "error": "skipped: secondary budget exhausted"})
            continue
        budget = int(min(SECONDARY_EACH_S, left))
        a2 = copy.copy(args)
        for k, v in over.items():
            setattr(a2, k, v)

        def alarm(sig, frame, name=name, budget=budget):
            raise TimeoutError(f"{name} exceeded {budget}s")

        old = signal.signal(signal.SIGALRM, alarm)
        signal.alarm(budget)
        try:
            out.append(fn(a2, dev))
        except Exception as e:          # noqa: BLE001 — reported as a line
            out.append({"metric": name, "error": f"{type(e).__name__}: {e}"})
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)
    return out


def run(argv=None):
    """Parse ``argv`` and run the mode. Returns ``(exit code, records)``;
    a refusal is written to standard error."""
    args = parser().parse_args(argv)
    path = _scene_path(args)
    if path is not None and not os.path.exists(path):
        print(f"bench_torch: the scene file {path} does not exist (the "
              "shipped reference scenes are not in the repository; "
              "bench_torch.write_pile_scene / write_contact_scene write "
              "stand-ins of the same structure)", file=sys.stderr)
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
    if path is not None:
        return _scene_mode(args, dev, path)
    for flag, fn in (("mpc", bench_mpc), ("mpc_big", bench_mpc_big),
                     ("tree", bench_tree), ("rods", bench_rods),
                     ("fluid", bench_fluid), ("bar", bench_bar),
                     ("pile_big", bench_pile_big)):
        if getattr(args, flag):
            return 0, [fn(args, dev)]
    records = [] if args.no_secondary else secondary_lines(args, dev)
    return 0, records + [bench_cloth(args, dev)]


def main(argv=None) -> int:
    code, records = run(argv)
    for r in records:
        print(json.dumps(r), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
