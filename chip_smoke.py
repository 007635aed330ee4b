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
   stiffness 0, and at ``n_batch`` 4 (the rollout a launch-grid
   dimension; rollouts set apart by their start velocities, and again by
   a seeded 1 cm jitter) over 10 steps, rollouts 0 and 3 bit for bit
   equal to themselves launched alone, its time a launch at 1 and 4
   rollouts;
4. the main paths through the public entry points, each with every
   kernel's launch count set to 0 just before it and read just after:
   the 320×320 bench cloth and the 80×36×36 bench bar, each built by
   ``SceneBuilder`` on the card, ``make_step_fn`` → 200 steps; then each
   path's steps/s and the card's busy share, and the bar's peak device
   memory over its 200 steps;
5. timings: each kernel per launch beside its plain version and its
   bound (the cloth and tet kernels' logged beside their first designs'
   recorded times, ``RECORDED_FIRST_DESIGN_CLOTH_MS`` and
   ``RECORDED_FIRST_DESIGN_TET_MS``), and ``make_cloth_step`` at 1 and 4
   rollouts in steps/s;
6. the fluid path, the 100k PBF breaking dam of ``bench.py --fluid``
   (80×50×25 particles in its boundary box), built by ``FluidScene.create``
   on the card: the three PBF kernels (density and λ, corrections, XSPH)
   against their plain versions for one pass each at the dam's shapes and
   on a cap-40 dam without boundary (Δx and v under ``one_pass_bar``),
   and the kernel step against the plain step over 10 steps; then
   ``make_fluid_step_fn`` → 100 steps with the
   launch counts set to 0 just before and read just after (5/5/1 a step),
   ``overflow`` 0 and every position finite; steps/s, the card's busy
   share and its peak memory; each kernel per launch beside its plain
   version and its bound, logged beside the recorded times of their
   first design (``RECORDED_FIRST_DESIGN_MS``); the staging and lane use
   that the dam's tables give the three; and that a step never syncs the
   host;
7. the planner (``mpc/``): one MPPI update with fed noise on a 64×64
   cloth at K 64, h 5 through ``mpc.make_sequence_cost`` and
   ``mpc.mppi_update`` on the kernel route (the cloth kernel at
   ``n_batch = K``) against the same update on the stencil route on the
   CPU, with the free corner's distance to the target added to the cost
   (costs within 1e-5 relative, the nominal and positions within 1e-5,
   the pinned rows bit for bit); then ``bench.py --mpc-big`` at full
   width through ``bench_torch.MpcBig`` (320×320, K 256, h 10): 3 updates
   after a warm-up with the launch counts set to 0 just before and read
   just after (150 cloth launches), everything finite and the pinned rows
   exact, the last update's 256 rollouts against the plain version on the
   card within 1e-5 and rollouts 0 and 255 against themselves launched
   alone, bit for bit; then updates/s, rollout-steps/s, the card's busy
   share, the cloth kernel's time a launch at ``n_batch`` 256 beside its
   bound, the copy kernels' share of the device time and the peak device
   memory;
   then one fed-noise MPPI update at K 8, h 5 on a 20×6×6 structured tet
   bar, its tip driven, through the tet kernel at ``n_batch = K`` against
   the stencil route on the CPU (costs within 1e-5 relative, the nominal
   within 1e-5);
   then ``bench_torch.py``'s ``--mpc``, ``--check``, default (fused
   cloth, without its secondary lines) and ``--no-fuse`` modes in this
   process, their JSON lines printed as they come;
8. the unstructured route (slice 4) at full width, no kernel of the port
   on it: U1, the bench cloth, and U2, the bench bar, each built by
   ``SceneBuilder(use_structured_grid=False)`` as particle batches
   (305,921 distance and 304,645 isometric-bending rows; 483,875 FEM
   tets with the inversion select): the build's seconds, the route name,
   10 steps against the kernel route of the structured scene (≤ 1e-4,
   ``U_TOL``) and the spread of two unstructured runs, ``U_STEPS`` steps
   with every launch count 0, finite positions and exact pins, one step
   with no host sync, steps/s, busy share, peak device memory and the top
   five device operations, printed as one ``{"unstructured": ...}`` line
   before the ``kernels`` line;
9. rigid bodies and joints (slice 6a), no kernel of the port on their
   path: R1, MPPI over K 256 rollouts of ``examples/chain_demo.py``'s 8-link
   chain at horizon 10 (``RigidWrenchControl`` on the tip, σ 20, λ 0.05):
   the build's seconds and the route (``torch_rigid``), one rollout on the
   card against the port on the CPU (≤ 1e-4), 4 of an update's 256
   rollouts against the same controls alone (≤ 1e-6), 2 updates with
   every launch count 0, finite, the anchor exact, one step of the 256
   rollouts with no host sync, updates/s and rollout-steps/s, busy share,
   peak device memory and the top five device operations; then
   ``joint_demo.py``, ``sbt_demo.py`` and ``coupling_demo.py`` built on the
   card, 20 steps against the CPU (≤ 1e-4) and ``RIGID_DEMO_STEPS`` (50)
   steps with every launch count 0, each joint's residual at the end;
   printed as one
   ``{"rigid": ...}`` line before the ``kernels`` line;
10. collision (slice 6b), no kernel of the port on its path: P1,
    ``bench.py --pile-big`` at its default (100 spheres on a box floor,
    the batched broad phase) through ``bench_torch.pile_scene`` →
    ``make_step_fn(pipeline=)``: the build's seconds and the route, 20
    steps on the card against the CPU (≤ 1e-4) with the active contact
    count equal at every step, one step with no host sync, ``PILE_STEPS``
    (50) steps with every launch count 0, overflow 0, finite, every centre
    at or above
    the floor top + r − 0.05; steps/s, busy share, device launches and µs
    a step, peak memory and the top five device operations; then the
    three collision examples (cloth, rigid and deformable) built on the
    card, 20 steps against the CPU (≤ 1e-4) and their full length with
    their own checks and overflow 0, and the cloth laid flat over the
    sphere so that it lands on it (20 steps against the CPU with equal
    active particle–rigid rows at every step, rows > 0 from some step on,
    the final minimum radius ≥ 0.6 − 0.02 − 1e-3); then C1, ``bench.py
    --mpc-contact``'s
    inline MPPI (K 8, horizon 5) on the deformable example's two bars:
    3 updates with overflow 0, 2 of the 8 rollouts against themselves
    alone (≤ 1e-6), updates/s and busy share; printed as one
    ``{"collision": ...}`` line before the ``kernels`` line;
11. rods (slice 7), no kernel of the port on their path: ``bench.py
    --rods`` at its default (1024 rods of 51 points on the rod lattice):
    the build's seconds and the route, 10 steps against the same rods as
    the unstructured batches on the card (≤ 2e-5 in positions and in
    sign-folded quaternions) and against the CPU (≤ 1e-4), ``ROD_STEPS``
    (50) steps with every launch count 0, finite, the pinned particles
    exact and the pinned
    frames where their first renormalisation put them, unit quaternions
    (1e-4), one step with no host sync, steps/s, rod-steps/s, busy share,
    device launches and µs a step, peak memory and the top five device
    operations; ``bench.py --rods --tree`` at its default (a random tree of
    101 stiff-rod segments, the scheduled elimination): against the dense
    solve over 20 steps (≤ 2e-4) and against the CPU (≤ 1e-4),
    ``ROD_STEPS`` steps, the same counters; the rod examples (the Cosserat
    helix, the ghost-point rod, the stiff-rod chain and Y-tree, the two
    generic demos with their constraint functions written in torch here),
    each 20 steps against the CPU (≤ 1e-4) and its full length with its
    own check; MPPI at K 64, h 5 over 16 lattice rods, one rod's free end
    driven, rollouts 0, 21, 42 and 63 against themselves alone (≤ 1e-6);
    printed as one ``{"rods": ...}`` line before the ``kernels`` line;
12. scene I/O (slice 8): the three stand-in scenes written and loaded
    (:func:`run_scenes`; the pile and the cloth over ``SCENE_STEPS`` (50)
    counted steps), ``run_scene_torch.py`` and the kernel demos; one
    ``{"scenes": ...}`` line;
13. parallelism (slice 9) and B1's fused and row-window modes
    (:func:`run_parallel`): the fused kernel's runtime resources and
    largest grid; B1 fused (a step's 5 substeps in one cooperative launch)
    at ``n_batch`` 1, 4 and 256 against the per-substep kernel bit for bit
    in x and v at 1 and 2 iterations, with and without damping, over 3
    steps, its grid size against ``fused_grid``, and over 10 steps against
    the per-substep kernel (x 2e-6, v 2e-4, JAX's bar, and whether bit for
    bit) and its plain version (1e-5), one launch a step, its time a
    launch beside 5 per-substep launches and its bound; 4 ranks in this
    process, each a window of 80 + 2·18 rows of the 320×320 cloth at
    ``80r − 18`` stepped by the fused window kernel, the kept rows
    stitched against the unsharded fused step (1e-6) over 10 steps, each
    window against its plain version (1e-5);
    ``make_cloth_step(fuse_substeps=True)`` over 200 steps with the launch
    counts set to 0 before and read after (200 fused launches);
    ``bench_torch.py``'s default cloth and ``--batch 4`` (both fused);
    then at world size 1 through NCCL (an in-process ``HashStore``)
    ``intra_cuda`` against the unsharded fused step (1e-6, 10 steps) and
    over 200 counted steps (200 window launches), ``intra_grid`` against
    ``make_step_fn`` (2e-5, 20 steps), the rollout shard at 256 rollouts
    against the unsharded batched step bit for bit, ``intra`` on the
    unstructured cloth against ``make_step_fn`` (1e-5, 10 steps), and
    steps/s of each; one ``{"parallel": ...}`` line;
14. B2's multi-substep mode (:func:`run_tet_fused`; one cooperative launch
    a step, ``tet_substep_kernel<1>``) on the 80×36×36 bench bar: against
    the per-iteration launches bit for bit in x and v at 1 and 4 rollouts,
    1 and 2 iterations, with and without damping, over 3 steps, and
    against the plain version over 10 steps (1e-5); its grid size and
    runtime resources; a fused launch's time beside 5 per-iteration
    launches in this call at 1 and 4 rollouts, with its bound and its
    plain version's time; ``make_tet_step`` (fused) over 200 steps with
    the launch counts set to 0 before and read after (200 fused
    launches) and its steps/s; then ``bench_torch.py`` in this process:
    ``--bar`` fused and ``--no-fuse``, ``--max-iterations 2`` on the cloth
    and the bar, ``--no-pallas --timers --profile DIR`` on the cloth (the
    trace file written) and the default run, whose secondary lines all
    carry a value but the absent contact scene's; one ``{"tet_fused":
    ...}`` line.

Each phase's seconds are logged as it ends and printed as one
``{"phase_s": ...}`` line before the ``kernels`` line.

The build log's ``-Xptxas -v`` lines are printed per ``__global__`` and
template instance (registers, shared memory, spills), and for the cloth
kernel (each iteration count a launch holds), the tet kernel and the PBF
kernels the registers, shared memory and resident blocks an SM that the
CUDA runtime reports (``grid_cloth_cuda.kernel_resources``,
``grid_tet_cuda.kernel_resources``, ``cellgrid_cuda.kernel_resources``).

Every steps/s figure is the median of ``N_WINDOWS`` windows of at least
``WINDOW_S`` seconds on the host clock, printed with the lowest and the
highest window.

Prints one ``{"unstructured": {...}}`` line (phase 8), one ``{"rigid":
{...}}`` line (phase 9), one ``{"collision": {...}}`` line (phase 10),
one ``{"rods": {...}}`` line (phase 11), one ``{"scenes": {...}}`` line
(phase 12), one ``{"parallel": {...}}`` line (phase 13), one
``{"tet_fused": {...}}`` line (phase 14), the ``{"phase_s": {...}}``
line, one ``{"kernels": [...]}`` JSON line (the cloth kernel's
per-substep, fused and row-window modes as three entries, the tet
kernel's per-iteration and multi-substep modes as two),
the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import bench_torch
from bench_torch import (PLAIN_CHUNK, bar_scene, cloth_scene, dam_scene,
                         plain_steps)

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
GRID = 320                      # the bench cloth (bench.py defaults)
BAR = (80, 36, 36)              # the bench bar (bench.py --bar defaults)
STEPS_MAIN = 200
CHECK_TOL = 1e-5                # bench.py --check bar, kernel vs plain
BATCH_TOL = 1e-6                # a batch's rollout vs the single rollout
WINDOW_S = 1.0                  # least length of one timed window
N_WINDOWS = 3                   # timed windows per rate
U_TOL = 1e-4                    # BASELINE.md end-to-end bar: unstructured
U_CHECK_STEPS = 10              # route vs the kernel route of its scene
U_STEPS = 20                    # phase 8's counted run, steps
# steps under the profiler: reading back a step's tens of thousands of
# events (U2, the tree) takes the host seconds, so two steps a profile
U_PROFILE_STEPS = 2             # phase 8's steps under the profiler
# phase 9, R1: MPPI over the chain demo (bench.py --mpc-samples/--mpc-horizon
# defaults), and the rigid demos
R1_LINKS = 8                    # examples/chain_demo.py --links default
R1_ITERATIONS = 5               # the rigid examples' StepConfig
R1_K = 256
R1_HORIZON = 10
R1_TARGET = (4.0, -4.0, 2.0)
R1_UPDATES = 2                  # counted updates after one warm-up
R1_CPU_TOL = 1e-4               # one rollout, card vs the port on the CPU
R1_SINGLES = 4                  # rollouts replayed alone
R1_SINGLE_TOL = 1e-6            # a rollout of K vs the same one alone
RIGID_DEMO_STEPS = 50
RIGID_DEMO_CHECK = 20           # card vs CPU steps of each demo
RIGID_DEMO_TOL = 1e-4
# phase 10: collision. P1, bench.py --pile-big at its default; the three
# collision demos; C1, bench.py --mpc-contact's inline MPPI on the demo's
# two bars (K = max(256 // 32, 4), horizon max(10 // 2, 5))
PILE_BODIES = 100
PILE_CHECK_STEPS = 20           # card vs CPU steps, bar PILE_TOL
PILE_TOL = 1e-4
PILE_STEPS = 50
PILE_PROFILE_STEPS = 2
PILE_FLOOR_TOP = 0.5            # the (6, 1, 6) box at y -0.5
PILE_RADIUS = 0.25
COLLISION_DEMO_CHECK = 20       # card vs CPU steps of each demo
C1_K = max(256 // 32, 4)
C1_HORIZON = max(10 // 2, 5)
C1_UPDATES = 3
C1_SINGLES = (0, C1_K - 1)      # rollouts replayed alone
# phase 12: scene I/O, the loaded stand-ins (bench_torch.write_*_scene)
SCENE_CHECK_STEPS = 20          # card vs CPU steps, bar SCENE_TOL
SCENE_TOL = 1e-4
SCENE_STEPS = 50
PILE_LOADED, PILE_SKIPPED, PILE_DYNAMIC = 28, 6, 2
PILE_FLOOR_Y = 0.0              # the stand-in's floor top
PILE_BODY_R = 0.35              # its dynamic bodies' radius
CKPT_STEP, CKPT_MORE = 100, 10  # checkpoint at step 100, 10 steps from each
RUN_SCENE_STEPS = 40
ARMADILLO_B = 32                # bench.py --armadillo-batch's default B
ARMADILLO_CALLS, ARMADILLO_STEPS_PER_CALL = 2, 5
CONTACT_UPDATES = 3             # --mpc-contact updates after a warm-up
KERNEL_DEMO_CHECK = 10          # steps against the plain versions
KERNEL_DEMO_TOL = {"cloth_demo": 1e-5, "bar_demo": 1e-5, "fluid_demo": 1e-4}
# launches a step of each demo's kernels at its defaults (5 substeps)
KERNEL_DEMO_LAUNCHES = {
    "cloth_demo": {"cloth_substep": 5},
    "bar_demo": {"tet_substep": 5},
    "fluid_demo": {"pbf_density_lambda": 5, "pbf_corrections": 5,
                   "pbf_xsph": 1}}
# phase 13: parallelism (slice 9) and B1's fused and row-window modes
PAR_STEPS = 10                  # steps of each mode's and module's check
PAR_BATCHES = (1, 4, 256)       # n_batch of the fused checks
PAR_TIMED = {1: 200, 4: 100, 256: 4}   # launches a timing at each n_batch
PAR_BIT_ITERS = (1, 2)          # iterations of the fused bit-for-bit checks
PAR_BIT_DAMPING = (0.0, 0.01)
PAR_BIT_STEPS = 3               # steps of each fused bit-for-bit check
FUSED_TOL = (2e-6, 2e-4)        # fused vs per-substep kernel, x and v: JAX's
#                                 bar, tests/test_grid_cloth_pallas.py:80-103
PAR_PLAIN_CHUNK = 64            # rollouts per piece of the plain replay
WINDOW_RANKS = 4                # in-process row windows of the bench cloth
WINDOW_TOL = 1e-6               # stitched windows vs the unsharded fused step
INTRA_GRID_STEPS = 20
INTRA_GRID_TOL = 2e-5           # tests/test_intra_sharding.py's bar
INTRA_TOL = 1e-5
DP_ROLLOUTS = 256
PAR_MAIN_STEPS = 200            # counted steps of each phase-13 main path
# phase 14: B2's multi-substep mode (one cooperative launch a step) and
# bench_torch.py's remaining options
TET_FUSED_BATCHES = (1, 4)      # rollouts of the fused checks and timings
TET_FUSED_ITERS = (1, 2)        # iterations of the bit-for-bit checks
TET_FUSED_DAMPING = (0.0, 0.01)
TET_FUSED_BIT_STEPS = 3         # steps of each bit-for-bit check (before the
#                                 reference's breakdown past one iteration)
TET_FUSED_TIMED = {1: 200, 4: 100}     # launches a timing at each n_batch
# phase 3, C-1: B2 at a rollout axis
TET_BATCH = 4                   # B2's n_batch check on the bench bar
TET_BATCH_JITTER = 0.01         # seeded jitter of free x, second case
TET_BATCH_SINGLES = (0, TET_BATCH - 1)   # launched alone, bit for bit
# phase 7, C-1: a planner over a structured tet bar on both routes
BAR_PLANNER = ((20, 6, 6), 8, 5)  # bar, rollouts K, horizon
# phase 10, C-2: the cloth laid flat over the sphere, landing on it
SPHERE_CLOTH_STEPS = 250
SPHERE_CLOTH_N = 12
# phase 11: rods (slice 7). bench.py --rods at its default and --rods
# --tree at its default, the rod examples, MPPI over rods
RODS = 1024                     # bench.py --rod-batch default
ROD_UNSTRUCTURED_TOL = 2e-5     # lattice vs the batches, tests/test_grid_rods
ROD_CHECK_STEPS = 10            # lattice vs batches, card vs CPU
ROD_STEPS = 50
ROD_PROFILE_STEPS = 2
TREE_TOL = 2e-4                 # scheduled vs dense, tests/test_stiff_rods
TREE_CHECK_STEPS = 20
ROD_DEMO_CHECK = 20             # card vs CPU steps of each rod demo
ROD_PLANNER = (16, 64, 5)       # rods, rollouts K, horizon
ROD_PLANNER_SINGLES = (0, 21, 42, 63)

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
# iteration the gather adds each of its 24 sums once; per vertex and
# iteration x + inv_cnt * dx, 6; per vertex and substep the integration 12
# and the velocity update 6. The halo cells that a block solves again and
# the halo vertices it integrates again are not counted: they are not
# work the function needs.
TET_FLOPS_PER_TET = 9 + 45 + 39 + 3 + 12 + 45 + 22 + 63 + 3 + 30 + 11 + 28
TET_FLOPS_PER_CELL = 5 * TET_FLOPS_PER_TET + 24
TET_FLOPS_PER_VERTEX = 6
TET_FLOPS_FIXED = 12 + 6

DAM = (80, 50, 25)              # the bench dam (bench.py --fluid defaults)
FLUID_STEPS_MAIN = 100
FLUID_CHECK_STEPS = 10
FLUID_STEP_TOL = 1e-4           # kernel step vs plain step over 10 steps
# one pass: a value of Δx (B4) or v (B5) passes within FLUID_PASS_TOL of
# the plain version's, or within one float32 step of it where the plain
# value's magnitude is FLUID_STEP_FROM or more (one_pass_bar)
FLUID_PASS_TOL = 1e-6
FLUID_STEP_FROM = 8.0
FLUID_RHO_RTOL = 1e-5           # one pass: max|d rho| / max rho
FLUID_LAM_RTOL = 1e-4           # one pass: max|d lambda| / max|lambda|
# the planner: one fed-noise MPPI update (bench.py --mpc's scene at 64x64)
# through the kernel route and through the stencil route on the CPU, then
# bench.py --mpc-big at full width, 3 timed updates after one warm-up
PLANNER_CHECK = (64, 64, 5)     # grid side, rollouts K, horizon
PLANNER_RTOL = 1e-5             # costs, relative; the nominal and x absolute
PLANNER_FREE_WEIGHT = 0.1       # the free corner's term in the route check
MPC_BIG = (GRID, 256, 10)       # grid side, rollouts K, horizon
MPC_BIG_UPDATES = 3
MPC_BIG_PLAIN_CHUNK = 64        # rollouts per piece of the plain replay
# B3-B5 per launch at the 100k dam in their first design (one warp per
# active cell, one lane per slot, neighbour rows read from global memory),
# as PERF.md records them: chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W. Kernel times held within 3% between calls. Only logged beside
# this run's times, as recorded figures; no result is computed from them.
RECORDED_FIRST_DESIGN_MS = {"pbf_density_lambda": 0.3036,
                            "pbf_corrections": 0.2917, "pbf_xsph": 0.2629}
# B1 per launch at 320x320, 1 iteration, at 1 and 4 rollouts in its first
# design (a 32x16 tile of 512 threads, lambda and the Jacobi weights in
# shared memory, the bending stencil from a constant table), as PERF.md
# records them: chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W.
# Logged only, as B1's recorded figures.
RECORDED_FIRST_DESIGN_CLOTH_MS = {1: 0.02602, 4: 0.07495}
# B2 per substep at the 80x36x36 bar, 1 iteration, in its first design (a
# cell pass and a vertex pass an iteration through a (24, cells) scratch
# buffer), as PERF.md records it: chip_smoke.py on an NVIDIA H100 80GB
# HBM3 at 700.00 W. Logged only, as B2's recorded figure.
RECORDED_FIRST_DESIGN_TET_MS = 0.017094

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


EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch")


def _common():
    """``examples/torch/_common.py``, the demos' harness."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    import _common
    return _common


@functools.lru_cache(maxsize=None)
def _example(name):
    return _common().load_example(name)


def demo(name, dev, *argv):
    """``examples/torch/<name>.py``'s scene at the flags ``argv`` (its
    defaults otherwise) built on ``dev`` by the script's own ``build``:
    a ``_common.Demo`` (state, cset, cfg, pipeline, info)."""
    return _common().build_demo(_example(name), argv, dev)


_T0 = time.perf_counter()


def log(*args):
    """Print a log line, stamped with the seconds since the script
    started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(logs):
    """``{kernel: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}}`` from ``nvcc -Xptxas -v`` output (``{source stem:
    text}``), one entry per template instance (``name<args>``), and the
    lines it read, each prefixed with its kernel."""
    out, lines = {}, []
    for stem, text in logs.items():
        name = None
        for line in text.splitlines():
            m = re.search(r"(?:entry function|Function properties for) "
                          r"'?(\S+?)'?(?: |$)", line)
            if m:
                # the kernels' names hold no digits; a mangled name puts
                # digits (a length, a file hash) before each part, and a
                # template instance its integer arguments after the name
                # (I Li1E ... E), kept as name<1,...>
                short = re.search(r"([a-z][a-z_]*_kernel)(I(?:Li\d+E)+E)?",
                                  m.group(1))
                name = m.group(1)
                if short:
                    name = short.group(1)
                    if short.group(2):
                        name += "<" + ",".join(re.findall(
                            r"Li(\d+)E", short.group(2))) + ">"
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


# the name each launch count is logged under, and its kernel's launch
# counter in ``utils.telemetry``
KERNEL_COUNTERS = {"cloth_substep": "cloth_substep",
                   "cloth_substep_fused": "cloth_fused",
                   "cloth_substep_window": "cloth_window",
                   "tet_substep": "tet_substep",
                   "tet_substep_fused": "tet_fused",
                   "pbf_density_lambda": "pbf_density_lambda",
                   "pbf_corrections": "pbf_corrections",
                   "pbf_xsph": "pbf_xsph"}


def launch_count(name: str) -> int:
    """The launches counted so far of ``KERNEL_COUNTERS``' kernel
    ``name``."""
    from positionbaseddynamics_tpu_torch.utils import telemetry

    return telemetry.launches(KERNEL_COUNTERS[name])


def reset_counts():
    from positionbaseddynamics_tpu_torch.utils import telemetry

    telemetry.reset()


def read_counts():
    return {k: launch_count(k) for k in KERNEL_COUNTERS}


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
    before = launch_count("cloth_substep")
    x3, _ = make_cloth_step(g2, p2.inv_mass, g2.inv_cnt_dist,
                            g2.inv_cnt_bend, dt=0.005, substeps=5,
                            n_steps=10, device=dev, **kw)(p2.x, p2.v)
    split = launch_count("cloth_substep") - before
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


# the names of B1's one-iteration kernels: the 32x16 tile's and the wide
# tile's (grid_cloth_cuda.takes_wide chooses between them)
B1_KERNELS = ("cloth_substep_kernel", "cloth_wide_kernel")


def b1_kernel(n_batch, height, width):
    """The kernel a one-iteration ``cloth_substep_cuda`` launch of
    ``n_batch`` whole ``height`` x ``width`` grids runs on this card."""
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    wide = gcc.takes_wide(n_batch, height, width, 1, 0, height,
                          gcc.wide_capacity())
    return B1_KERNELS[wide]


def device_ms(fn, n, kernel_name):
    """Mean device time per launch of the kernel ``kernel_name`` (or of
    any of a tuple of names), read from ``torch.profiler`` over ``n``
    calls of ``fn``; None when the profiler records no device time for
    it."""
    names = (kernel_name,) if isinstance(kernel_name, str) else kernel_name
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
        if any(name in ev.key for name in names):
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def tet_kernel_vs_plain(scene, steps, iters=1, damping=0.0, label=""):
    """``make_tet_step`` in the per-iteration mode one step at a time
    against the plain version. Returns the max|dx| after each step, the
    plain version's largest displacement after each step, and the final
    plain positions."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    state, cset = scene
    gt, p = cset.grid_tets[0], state.particles
    f = gtc.make_tet_step(gt, p.inv_mass, dt=0.005, substeps=5,
                          max_iterations=iters, damping=damping,
                          fuse_substeps=False, device=p.x.device)
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


def check_tet_kernel_batched(dev, bar):
    """Phase 3, C-1: B2 at ``n_batch`` ``TET_BATCH`` on the bench bar.
    Rollout k starts at rest shape with its free vertices moving at
    ``(0, −0.1 k, 0.05 k)`` m/s: 10 steps against the plain version on the
    same rollouts (≤ ``CHECK_TOL``), and rollouts ``TET_BATCH_SINGLES``
    against themselves launched alone, bit for bit. The same with each
    rollout's free vertices jittered by a seeded ``TET_BATCH_JITTER``:
    bit for bit alone, the distance from the plain version logged (a
    rough start makes the stiff bar carry the kernel's FMA roundings
    further, as B1's jittered rollouts do, PERF.md §6). Then B2's
    device time a launch at 1 and at ``TET_BATCH`` rollouts. Returns the
    record."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    state, cset = bar
    gt, p = cset.grid_tets[0], state.particles
    dims = (gt.width, gt.height, gt.depth)
    params = gtc.kernel_params(gt, h=0.001)
    w = p.inv_mass.contiguous()
    ic = gt.inv_cnt.reshape(-1).contiguous()
    free = (p.inv_mass > 0)[:, None]

    def kernel_steps(x, v, n):
        xp, vp = gtc.to_planes(x), gtc.to_planes(v)
        for _ in range(n):
            xp, vp, _, _ = gtc.run_substeps(xp, vp, w, ic, params, dims, 1, 5)
        lead = x.shape[:-2]
        return gtc.from_planes(xp, lead), gtc.from_planes(vp, lead)

    def run(x0, v0):
        devs, x, v, xr, vr = [], x0, v0, x0, v0
        for _ in range(10):
            x, v = kernel_steps(x, v, 1)
            for _ in range(5):
                xr, vr = gtc.tet_substep_reference(gt, xr, vr, p.inv_mass,
                                                   h=0.001)
            devs.append(max_dev(x, xr))
        singles = {}
        for k in TET_BATCH_SINGLES:
            xa, va = kernel_steps(x0[k], v0[k], 10)
            singles[k] = bool(torch.equal(xa, x[k]) and torch.equal(va, v[k]))
        return devs, singles

    ks = torch.arange(TET_BATCH, device=dev, dtype=torch.float32)
    vel = torch.stack([torch.zeros_like(ks), -0.1 * ks, 0.05 * ks], -1)
    v0 = torch.where(free, vel[:, None, :], 0.0)
    x0 = p.x.expand(TET_BATCH, -1, -1).contiguous()
    devs, singles = run(x0, v0)
    gen = torch.Generator(device=dev).manual_seed(11)
    xj = p.x + torch.where(free, TET_BATCH_JITTER * torch.randn(
        (TET_BATCH,) + tuple(p.x.shape), generator=gen, device=dev), 0.0)
    jdevs, jsingles = run(xj, torch.zeros_like(xj))
    torch.cuda.synchronize()
    times = {}
    for nb in (1, TET_BATCH):
        xs = xj[:nb] if nb > 1 else xj[0]
        buf = [gtc.to_planes(xs), gtc.to_planes(torch.zeros_like(xs))]

        def launch():
            buf[:] = gtc.tet_substep_cuda(buf[0], buf[1], w, ic, params, dims)

        times[nb] = device_ms(launch, 200, "tet_substep_kernel")
    out = {"n_batch": TET_BATCH, "max_abs_err_per_step": devs,
           "singles_bitwise": singles, "jitter": TET_BATCH_JITTER,
           "jittered_max_abs_err_per_step": jdevs,
           "jittered_singles_bitwise": jsingles,
           "ms_b1": times[1], f"ms_b{TET_BATCH}": times[TET_BATCH]}
    for nb in (1, TET_BATCH):
        b = tet_bound(dims, nb)
        out[f"bound_ms_b{nb}"], out[f"bound_by_b{nb}"] = b["ms"], b["by"]
    log(f"check tet n_batch {TET_BATCH}: {out}")
    log(f"timing tet_substep at one rollout: {times[1]!r} ms a launch in "
        f"this run; PERF.md records 0.01585 ms for it")
    assert max(devs) <= CHECK_TOL, devs
    assert all(singles.values()) and all(jsingles.values()), (singles,
                                                              jsingles)
    return out


def profile_busy(fn, state, n_prof, label, top=5, top_out=None,
                 stats=None):
    """Steps ``n_prof`` times under ``torch.profiler``. Returns the card's
    busy share of the wall time and its busy microseconds per step, both
    from the device-side events alone (an aten op's row repeats the device
    time of the kernels it launched), and logs the ``top`` kernels (also
    appended to ``top_out`` as ``{"op", "us_per_step", "count"}`` when a
    list is given); ``stats``, when a dict, gets the device launches per
    step."""
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
        if top_out is not None:
            top_out.append({"op": ev.key[:120],
                            "us_per_step": ev.self_device_time_total / n_prof,
                            "count": ev.count})
    busy = busy_us / 1e6 / wall
    log(f"{label} under profiler: {n_prof / wall!r} steps/s, device busy "
        f"{busy!r} of wall time, {busy_us / n_prof!r} us/step")
    if stats is not None:
        stats["launches_per_step"] = sum(ev.count for ev in device) / n_prof
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
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    s = state
    for _ in range(STEPS_MAIN):
        s = fn(s)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = counts["tet_substep"]
    log(f"main path bar: launch counts {counts}, peak device memory of the "
        f"{STEPS_MAIN} steps {peak} B")

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
    per_step = cfg.substeps * cfg.max_iterations      # one a substep's iteration
    assert launches == STEPS_MAIN * per_step, launches
    log(f"main path bar {STEPS_MAIN} steps: launches {launches}, "
        f"mean fall of the free vertices {fall!r}, time {s.time.item()!r}")

    st = [s]

    def one_step():
        st[0] = fn(st[0])

    rate = rate_windows(one_step, 1)
    assert torch.isfinite(st[0].particles.x).all()
    log(f"main path bar steps/s: {rate}")
    busy, busy_us = profile_busy(fn, st[0], 200, "main path bar")
    return {"launches": launches, "steps_per_s": rate, "device_busy": busy,
            "device_us_per_step": busy_us, "max_abs_err": dev10,
            "peak_bytes": peak}


def tet_bound(dims, nb=1, substeps=1, iterations=1):
    """The least time of one tet launch at ``nb`` rollouts of a ``dims``
    grid running ``substeps`` substeps of ``iterations`` iterations (the
    per-iteration mode's launch: 1 and 1, the bound of a substep at one
    iteration): each rollout's 6 state planes read once and written once,
    w and inv_cnt read once for all rollouts, against the operations the
    passes need (``TET_FLOPS_*``). Returns ``{"ms", "by", "bytes_ms",
    "ops_ms"}``."""
    n_vert = dims[0] * dims[1] * dims[2]
    n_cells = (dims[0] - 1) * (dims[1] - 1) * (dims[2] - 1)
    bytes_moved = 4 * (12 * nb + 2) * n_vert
    flops = nb * (substeps * iterations * (TET_FLOPS_PER_CELL * n_cells
                                           + TET_FLOPS_PER_VERTEX * n_vert)
                  + substeps * TET_FLOPS_FIXED * n_vert)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return {"ms": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def time_tet_kernel(dev, bar):
    """Phase 5, tet: the kernel per launch (one substep at one iteration),
    the plain version per substep and the bound, at the main path's
    shape."""
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

    # events time the stream between launches, host overhead included;
    # the profiler gives the kernel's own device time
    out = {"interval_ms": cuda_time_ms(launch, 500)}
    kms = device_ms(launch, 200, "tet_substep_kernel")
    out["ms"] = out["interval_ms"] if kms is None else kms
    out["ms_source"] = "cuda events" if kms is None else "profiler"
    xs = [p.x, p.v]

    def plain():
        xs[:] = gtc.tet_substep_reference(gt, xs[0], xs[1], p.inv_mass,
                                          h=0.001)

    out["plain_ms"] = cuda_time_ms(plain, 20)
    b = tet_bound(dims)
    out["bound_ms"], out["bound_by"] = b["ms"], b["by"]
    out["bound_bytes_ms"], out["bound_ops_ms"] = b["bytes_ms"], b["ops_ms"]
    for k, v in out.items():
        log(f"timing tet {k}: {v!r}")
    log(f"timing tet_substep: {out['ms']!r} ms a substep in this run; "
        f"PERF.md records {RECORDED_FIRST_DESIGN_TET_MS} ms for its first "
        "design (not measured in this run)")
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
        kms = device_ms(launch, 200, B1_KERNELS)
        out[f"ms_b{nb}"] = out[f"interval_ms_b{nb}"] if kms is None else kms
        out[f"kernel_b{nb}"] = b1_kernel(nb, GRID, GRID)
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
    for nb, ms in RECORDED_FIRST_DESIGN_CLOTH_MS.items():
        log(f"timing cloth_substep at {nb} rollouts: {out[f'ms_b{nb}']!r} ms "
            f"a launch in this run; PERF.md records {ms} ms for its first "
            "design (not measured in this run)")

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


def one_pass_bar(kernel, plain, tol=FLUID_PASS_TOL,
                 step_from=FLUID_STEP_FROM):
    """Hold one pass's output to its plain version value by value: a value
    passes within ``tol`` of the plain value or, where the plain value's
    magnitude is ``step_from`` or more, within one float32 step of it. At
    8 m/s and up ``tol`` is at most one float32 step (9.5e-7 from 8, 1.9e-6
    from 16, 3.8e-6 from 32), and a kernel that adds a slot's terms in
    another order than the plain version may round the last bit of
    ``v + (−ν)·dv`` the other way; the dam's particles reach 33 m/s.
    Returns the values under each kind of bar, how many differ at all and
    fail, the largest deviation, the largest plain magnitude among the
    values that differ, and ``ok``."""
    k, p = kernel.float(), plain.float()
    diff = (k - p).abs()
    mag = p.abs()
    step = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
    big = mag >= step_from
    ok = (diff <= tol) | (big & (diff <= step))
    differ = diff > 0
    return {"values_abs": int((~big).sum()), "values_step": int(big.sum()),
            "differ": int(differ.sum()), "fail": int((~ok).sum()),
            "max_abs_err": diff.max().item(),
            "max_magnitude_differing": (mag[differ].max().item()
                                        if bool(differ.any()) else 0.0),
            "ok": bool(ok.all())}


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
            f"x{sfx}_bar": one_pass_bar(x_out, x_ref),
        })
    out["x_moved_from_x0"] = max_dev(pi.iters[1][0], pi.xt)
    v_ref = pi.plain_b5()
    torch.cuda.synchronize()
    out.update({
        "v_max_abs_err": max_dev(pi.v_out, v_ref),
        "v_bar": one_pass_bar(pi.v_out, v_ref),
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
        assert out[f"x{sfx}_bar"]["ok"], out
        if sfx == "" or second_moves:
            assert min(out[f"lam{sfx}_scale"], out[f"x{sfx}_moved"]) > 0, out
    assert out["v_bar"]["ok"], out
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

    stage = fcc.stage_capacity()
    out = {"work": work,
           "staging": staging_counts(spec, pi.mt, *pi.cells(), stage),
           # B5 stages the fluid candidates alone
           "staging_xsph": staging_counts(spec, pi.mt, *pi.cells(),
                                          (stage[0], 2**31 - 1))}
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


def check_planner_routes(dev):
    """Phase 7a: one MPPI update through ``mpc.make_sequence_cost`` and
    ``mpc.mppi_update`` with the same fed noise, on ``bench.py --mpc``'s
    cost plus the free corner's distance to the target each step (the
    bench's cost reads only what the command sets, so alone it would not
    see the kernel), through the kernel route
    (the cloth kernel at ``n_batch = K``) and through the stencil route on
    the CPU: costs within ``PLANNER_RTOL`` relative, the new nominal and
    the rollouts' final positions within ``PLANNER_RTOL``, the pinned rows
    bit for bit."""
    from positionbaseddynamics_tpu_torch import mpc
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    n, k, hz = PLANNER_CHECK
    cpu = torch.device("cpu")
    sk, seq_k, mcfg = bench_torch.make_mpc(k, hz, dev, n=n,
                                           free_weight=PLANNER_FREE_WEIGHT)
    sp, seq_p, _ = bench_torch.make_mpc(k, hz, cpu, n=n,
                                        free_weight=PLANNER_FREE_WEIGHT)
    assert seq_k.path == "cuda_kernel" and seq_p.path == "torch_stencil", (
        seq_k.path, seq_p.path)
    gen = torch.Generator(device=dev).manual_seed(7)
    eps = mcfg.sigma * torch.randn((k, hz, 3), generator=gen, device=dev)
    nominal = 0.3 * torch.randn((hz, 3), generator=gen, device=dev)
    before = launch_count("cloth_substep")
    nk, ck = mpc.mppi_update(sk, nominal, seq_k, mcfg, eps=eps)
    torch.cuda.synchronize()
    launches = launch_count("cloth_substep") - before
    npl, cpl = mpc.mppi_update(sp, nominal.cpu(), seq_p, mcfg, eps=eps.cpu())
    cost_rel = ((ck.cpu() - cpl).abs().max() / cpl.abs().max()).item()
    nom_dev = max_dev(nk.cpu(), npl)
    _, fk = seq_k(sk, nominal + eps)
    _, fp = seq_p(sp, (nominal + eps).cpu())
    xk, xp = fk.particles.x.cpu(), fp.particles.x
    x_dev = max_dev(xk, xp)
    pinned_exact = torch.equal(xk[:, 0], xp[:, 0])
    out = {"grid": n, "rollouts": k, "horizon": hz, "launches": launches,
           "cost_max_rel_err": cost_rel, "nominal_max_abs_err": nom_dev,
           "x_max_abs_err": x_dev, "pinned_exact": pinned_exact,
           "cost_min": cpl.min().item(), "cost_max": cpl.max().item()}
    log(f"planner {n}x{n} K {k} h {hz}, kernel route vs stencil route on "
        f"the CPU: {out}")
    assert launches == hz * 2, launches           # 2 substeps a step
    assert cost_rel <= PLANNER_RTOL, cost_rel
    assert nom_dev <= PLANNER_RTOL, nom_dev
    assert x_dev <= PLANNER_RTOL, x_dev
    assert pinned_exact, "the pinned rows differ between the routes"
    assert torch.isfinite(xk).all() and torch.isfinite(nk).all()
    return out


def bar_planner(dev):
    """A planner over the structured tet bar ``BAR_PLANNER[0]`` (the i = 0
    face pinned): ``mpc.make_sequence_cost`` with the tip vertex driven by
    a ``PinVelocityControl`` (≤ 2 m/s), the control effort (1e-3) and the
    tip's squared distance to a target 0.3 down of it at the end. Returns
    ``(state, seq_cost, MPPIConfig)``."""
    from positionbaseddynamics_tpu_torch import mpc
    from positionbaseddynamics_tpu_torch.solver import StepConfig

    dims, k, hz = BAR_PLANNER
    state, cset = bar_scene(dims, dev, scale=(2.0, 0.5, 0.5))
    tip = state.particles.n - 1
    target = state.particles.x[tip].cpu().numpy() + np.float32(
        [0.0, -0.3, 0.0])
    seq = mpc.make_sequence_cost(
        cset, StepConfig(), mpc.PinVelocityControl(indices=(tip,),
                                                   max_speed=2.0),
        running_cost=mpc.control_effort(1e-3),
        terminal_cost=mpc.particle_target([tip], target), device=dev)
    return state, seq, mpc.MPPIConfig(horizon=hz, num_samples=k, sigma=0.5,
                                      temperature=0.1)


def check_bar_planner_routes(dev):
    """Phase 7a, C-1: one fed-noise MPPI update over the structured bar of
    :func:`bar_planner` through the tet kernel at ``n_batch = K`` and
    through the stencil route on the CPU: costs within ``PLANNER_RTOL``
    relative, the nominal within ``PLANNER_RTOL``."""
    from positionbaseddynamics_tpu_torch import mpc
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    dims, k, hz = BAR_PLANNER
    sk, seq_k, mcfg = bar_planner(dev)
    sp, seq_p, _ = bar_planner(torch.device("cpu"))
    assert seq_k.path == "cuda_kernel" and seq_p.path == "torch_stencil", (
        seq_k.path, seq_p.path)
    gen = torch.Generator(device=dev).manual_seed(12)
    eps = mcfg.sigma * torch.randn((k, hz, 3), generator=gen, device=dev)
    nominal = 0.2 * torch.randn((hz, 3), generator=gen, device=dev)
    before = launch_count("tet_substep")
    nk, ck = mpc.mppi_update(sk, nominal, seq_k, mcfg, eps=eps)
    torch.cuda.synchronize()
    launches = launch_count("tet_substep") - before
    npl, cpl = mpc.mppi_update(sp, nominal.cpu(), seq_p, mcfg,
                               eps=eps.cpu())
    cost_rel = ((ck.cpu() - cpl).abs().max() / cpl.abs().max()).item()
    nom_dev = max_dev(nk.cpu(), npl)
    out = {"bar": dims, "rollouts": k, "horizon": hz, "launches": launches,
           "cost_max_rel_err": cost_rel, "nominal_max_abs_err": nom_dev,
           "cost_min": cpl.min().item(), "cost_max": cpl.max().item()}
    log(f"planner over the {dims} bar, K {k} h {hz}, tet kernel vs stencil "
        f"route on the CPU: {out}")
    assert launches == hz * 5, launches           # 5 substeps a step
    assert cost_rel <= PLANNER_RTOL, cost_rel
    assert nom_dev <= PLANNER_RTOL, nom_dev
    assert torch.isfinite(ck).all() and torch.isfinite(nk).all()
    return out


def run_mpc_big(dev):
    """Phase 7b: ``bench.py --mpc-big`` at full width through
    ``bench_torch.MpcBig``: one warm-up update, then ``MPC_BIG_UPDATES``
    updates with every launch count set to 0 just before and read just
    after (B1: updates × horizon × 5 substeps); every position, cost and
    the nominal finite, the pinned rows exactly where the clipped commands
    put them; the last update's K rollouts replayed through the plain
    version on the card, ``MPC_BIG_PLAIN_CHUNK`` at a time (positions
    within ``CHECK_TOL``, costs within ``PLANNER_RTOL`` relative), and
    rollouts 0 and K - 1 launched alone at ``n_batch`` 1, bit for bit; then
    updates/s, the card's busy share and B1's time a launch
    under the profiler, the copy kernels' share of the device time, and
    the peak device memory of the updates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    width, k, hz = MPC_BIG
    planner = bench_torch.MpcBig(width, k, hz, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    nominal = torch.zeros((hz, 3), dtype=torch.float32, device=dev)
    nominal = planner.update(nominal, planner.draw(gen))[0]      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(MPC_BIG_UPDATES):
        eps = planner.draw(gen)
        u = planner.controls(nominal, eps)
        nominal, cost, x = planner.update(nominal, eps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    pin = planner.x0[planner.pin].expand(k, 3).clone()
    for t in range(hz):
        pin += u[:, t] * planner.cfg.dt
    out = {"launches": counts, "updates_s_unwindowed": MPC_BIG_UPDATES / wall,
           "peak_bytes": peak,
           "pinned_exact": torch.equal(x[:, planner.pin], pin),
           "finite": bool(torch.isfinite(x).all()
                          and torch.isfinite(cost).all()
                          and torch.isfinite(nominal).all())}
    log(f"mpc-big {width}x{width} K {k} h {hz}: {MPC_BIG_UPDATES} updates, "
        f"launch counts {counts}, peak device memory {peak} B, pinned rows "
        f"exact {out['pinned_exact']}, finite {out['finite']}")
    want = MPC_BIG_UPDATES * hz * planner.cfg.substeps
    assert counts["cloth_substep"] == want, (counts, want)
    assert all(v == 0 for kk, v in counts.items() if kk != "cloth_substep")
    assert out["finite"], "mpc-big produced non-finite values"
    assert out["pinned_exact"], "mpc-big moved a pinned row"
    out.update(check_mpc_big_rollouts(planner, u, x, cost))

    st = [nominal]

    def one_update():
        st[0] = planner.update(st[0], planner.draw(gen))[0]

    out["updates_per_s"] = rate_windows(one_update, 1)
    out["aggregate_steps_per_s"] = {
        key: val * k * hz for key, val in out["updates_per_s"].items()
        if key in ("median", "min", "max")}
    log(f"mpc-big updates/s {out['updates_per_s']}, rollout-steps/s "
        f"{out['aggregate_steps_per_s']}")

    n_prof = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one_update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in device)
    # B1 at K rollouts: the 32x16 or the wide tile (grid_cloth_cuda.takes_wide)
    b1 = [ev for ev in device if any(k in ev.key for k in B1_KERNELS)]
    b1_us = sum(ev.self_device_time_total for ev in b1)
    b1_count = sum(ev.count for ev in b1)
    copy_us = sum(ev.self_device_time_total for ev in device
                  if "copy" in ev.key.lower())
    for ev in sorted(device, key=lambda ev: -ev.self_device_time_total)[:8]:
        log(f"  mpc-big device time: {ev.key[:70]!r} "
            f"{ev.self_device_time_total / n_prof!r} us/update x{ev.count}")
    n_part = k * width * width
    bytes_moved = 4 * (12 * n_part + 3 * width * width)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ((FLOPS_FIXED + FLOPS_PER_ITERATION) * n_part
             / H100_FP32_FLOPS * 1e3)
    out.update({
        "device_busy": busy_us / 1e6 / wall,
        "device_us_per_update": busy_us / n_prof,
        "b1_ms": b1_us / b1_count / 1e3 if b1_count else None,
        "b1_launches_profiled": b1_count,
        "b1_share": b1_us / busy_us if busy_us else None,
        "copy_share": copy_us / busy_us if busy_us else None,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    log(f"mpc-big under profiler: device busy {out['device_busy']!r} of wall "
        f"time, {out['device_us_per_update']!r} us a update; B1 "
        f"{out['b1_ms']!r} ms a launch at n_batch {k} beside its bound "
        f"{out['bound_ms']!r} ms ({out['bound_by']}); B1 {out['b1_share']!r}"
        f" and copy kernels {out['copy_share']!r} of the device time")
    return out


def check_mpc_big_rollouts(planner, u, x, cost):
    """The rollouts of one ``MpcBig`` update (commands ``u``, final
    positions ``x``, costs ``cost``) against the same rollouts through the
    plain version, and rollouts 0 and K - 1 against themselves launched
    alone at ``n_batch`` 1."""
    cfg = planner.cfg

    def plain(xc, vc):
        return plain_steps(planner.grid, xc, vc, planner.inv_mass,
                           cfg.substeps, cfg.dt / cfg.substeps,
                           max_iterations=cfg.max_iterations,
                           gravity=cfg.gravity, damping=cfg.damping)

    x_dev, cost_dev = 0.0, 0.0
    for lo in range(0, planner.k, MPC_BIG_PLAIN_CHUNK):
        xp, cp = planner.rollouts(u[lo:lo + MPC_BIG_PLAIN_CHUNK], plain)
        x_dev = max(x_dev, max_dev(x[lo:lo + MPC_BIG_PLAIN_CHUNK], xp))
        cost_dev = max(cost_dev, max_dev(cost[lo:lo + MPC_BIG_PLAIN_CHUNK],
                                         cp))
        del xp, cp
    cost_rel = cost_dev / cost.abs().max().item()
    one = bench_torch.rollout_step_fn(planner.grid, planner.inv_mass, cfg,
                                      planner.dev, 1)
    alone_exact = {}
    for z in (0, planner.k - 1):
        xz, _ = planner.rollouts(u[z:z + 1], one)
        alone_exact[z] = torch.equal(xz[0], x[z])
    torch.cuda.synchronize()
    out = {"plain_x_max_abs_err": x_dev, "plain_cost_max_rel_err": cost_rel,
           "alone_bit_exact": alone_exact}
    log(f"mpc-big last update's {planner.k} rollouts against the plain "
        f"version: max|dx| {x_dev!r}, costs max rel {cost_rel!r}; launched "
        f"alone, bit for bit: {alone_exact}")
    assert x_dev <= CHECK_TOL, x_dev
    assert cost_rel <= PLANNER_RTOL, cost_rel
    assert all(alone_exact.values()), alone_exact
    return out


def run_bench_modes():
    """Phase 7c: ``bench_torch.py``'s ``--mpc``, ``--check`` and default
    modes in this process (the default without its secondary lines, which
    phase 14 runs); each JSON line is printed as it comes."""

    out = {}
    for name, argv in (("mpc", ["--mpc"]), ("check", ["--check"]),
                       ("default", ["--no-secondary"]),
                       ("no_fuse", ["--no-fuse", "--no-secondary"])):
        code, records = bench_torch.run(argv)
        for r in records:
            print(json.dumps(r), flush=True)
        assert code == 0 and records, (name, code)
        assert all(math.isfinite(r["value"]) for r in records), records
        out[name] = records
    return out


def run_unstructured(dev):
    """Phase 8: the unstructured route (slice 4) at full width. U1 is the
    bench cloth and U2 the bench bar, each built by ``SceneBuilder(
    use_structured_grid=False)`` on the card, so that their constraints
    are particle batches: ``make_step_fn`` reports ``torch_unstructured``;
    10 steps against the kernel route of the same structured scene (≤
    ``U_TOL``), with the spread between two runs of the unstructured route
    (atomics do not fix the order of a sum); ``U_STEPS`` steps with every
    kernel's launch count set to 0 just before and read just after (all
    0), finite positions and exact pins; one step under CUDA's sync debug
    mode; steps/s, the card's busy share, peak device memory and the five
    device operations that take the most time. Returns the record of
    ``{"unstructured": ...}``."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    cfg = StepConfig()
    scenes = {
        "U1": ("the bench cloth without the stencil path, "
               f"{GRID}x{GRID}", lambda s: cloth_scene(GRID, GRID, dev,
                                                       structured=s)),
        "U2": (f"the bench bar through the FEM-tet batch, {BAR}",
               lambda s: bar_scene(BAR, dev, structured=s)),
    }
    out = {}
    for name, (what, build) in scenes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cset = build(False)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rows = {n: b.n_rows for n, b in cset.particle_batches()}
        fn = make_step_fn(cset, cfg)
        n = state.particles.n
        log(f"phase 8 {name} ({what}): {n} particles, batches {rows}, "
            f"built in {build_s!r} s, route {fn.path}")
        assert fn.path == "torch_unstructured", fn.path
        assert not cset.grid_cloths and not cset.grid_tets

        ks, kc = build(True)
        kfn = make_step_fn(kc, cfg)
        assert kfn.path == "cuda_kernel", kfn.path
        runs = []
        for f, s in ((fn, state), (fn, state), (kfn, ks)):
            for _ in range(U_CHECK_STEPS):
                s = f(s)
            runs.append(s.particles.x)
        err = max_dev(runs[0], runs[2])
        spread = max_dev(runs[0], runs[1])
        del ks, kc, kfn, runs
        log(f"phase 8 {name}: {U_CHECK_STEPS} steps against the kernel "
            f"route: max|dx| = {err!r} (bar {U_TOL}); two unstructured "
            f"runs differ by {spread!r}")
        assert err <= U_TOL, (name, err)

        x0 = state.particles.x.clone()
        pinned = state.particles.inv_mass == 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        s = state
        t0 = time.perf_counter()
        for _ in range(U_STEPS):
            s = fn(s)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 8 {name}: {U_STEPS} steps in {run_s!r} s, launch "
            f"counts {counts}, peak device memory {peak} B")
        assert all(v == 0 for v in counts.values()), counts
        x = s.particles.x
        assert torch.isfinite(x).all() and torch.isfinite(s.particles.v).all()
        assert torch.equal(x[pinned], x0[pinned]), "pinned rows moved"
        fall = (x0[~pinned, 1].mean() - x[~pinned, 1].mean()).item()
        assert fall > 0.0, f"{name}: free particles rose {fall}"

        sync_error = None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            s = fn(s)
        except RuntimeError as e:
            sync_error = str(e)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log(f"phase 8 {name} step under sync debug mode 'error': "
            f"{'no host sync' if sync_error is None else sync_error}")
        assert sync_error is None, sync_error

        st = [s]

        def one_step():
            st[0] = fn(st[0])

        rate = rate_windows(one_step, 1)
        log(f"phase 8 {name} steps/s: {rate}")
        top = []
        busy, busy_us = profile_busy(fn, st[0], U_PROFILE_STEPS,
                                     f"phase 8 {name}", top_out=top)
        assert torch.isfinite(st[0].particles.x).all()
        out[name] = {"scene": what, "particles": n, "rows": rows,
                     "build_s": build_s, "route": fn.path,
                     "max_abs_err_vs_kernel_route": err,
                     "unstructured_spread": spread, "steps": U_STEPS,
                     "launches": counts, "steps_per_s": rate,
                     "device_busy": busy, "device_us_per_step": busy_us,
                     "peak_bytes": peak, "top_ops": top,
                     "mean_fall": fall}
        del state, cset, fn, s, st
        torch.cuda.empty_cache()
    return out


def rigid_planner(dev):
    """R1: MPPI over ``R1_K`` rollouts of the chain at horizon
    ``R1_HORIZON`` (``bench.py --mpc-samples/--mpc-horizon`` defaults),
    ``RigidWrenchControl`` on the tip, the tip's distance to ``R1_TARGET``
    each step and 10× at the end plus a 1e-6 control effort, σ 20, λ 0.05
    (JAX's ``tests/test_mpc.py:32-42``). Returns ``(state, seq_cost,
    MPPIConfig, build seconds)``."""
    from positionbaseddynamics_tpu_torch import mpc
    from positionbaseddynamics_tpu_torch.solver import StepConfig

    t0 = time.perf_counter()
    chain = demo("chain_demo", dev, "--links", str(R1_LINKS))
    state, cset = chain.state, chain.cset
    tip = R1_LINKS
    seq = mpc.make_sequence_cost(
        cset, StepConfig(max_iterations=R1_ITERATIONS),
        mpc.RigidWrenchControl(body_indices=(tip,), max_force=120.0),
        running_cost=mpc.combine(
            mpc.as_running(mpc.rigid_target(tip, R1_TARGET, weight=1.0)),
            mpc.control_effort(1e-6)),
        terminal_cost=mpc.rigid_target(tip, R1_TARGET, weight=10.0),
        device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mcfg = mpc.MPPIConfig(horizon=R1_HORIZON, num_samples=R1_K, sigma=20.0,
                          temperature=0.05, plan_iters=1)
    return state, seq, mcfg, build_s


def joint_residuals(state, cset, dt):
    """Each joint batch's largest positional and angular residual on
    ``state`` (``JointBatch.residual``), by kind."""
    out = {}
    r = state.rigid
    for jb in cset.joints:
        lin, ang = jb.residual(r.x, r.q, state.time, dt,
                               px=state.particles.x)
        out[jb.kind] = {"gap": lin.max().item(), "angular": ang.max().item()}
    return out


def run_rigid_demos(dev):
    """Phase 9b: ``joint_demo.py``, ``sbt_demo.py`` and ``coupling_demo.py``
    built on the card, ``RIGID_DEMO_CHECK`` steps against the port on the
    CPU (≤ ``RIGID_DEMO_TOL``), then ``RIGID_DEMO_STEPS`` steps with every
    launch count 0: each joint's residual at the end, the anchors exact,
    everything finite."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    cfg = StepConfig(max_iterations=R1_ITERATIONS)
    h = cfg.dt / cfg.substeps
    cpu = torch.device("cpu")
    out = {}
    for name in ("joint_demo", "sbt_demo", "coupling_demo"):
        d = demo(name, dev)
        assert d.cfg == cfg, (name, d.cfg)
        state, cset = d.state, d.cset
        fn = make_step_fn(cset, cfg)
        assert fn.path == "torch_rigid", fn.path
        c = demo(name, cpu)
        cs, cc = c.state, c.cset
        cfn = make_step_fn(cc, cfg, device=cpu)
        a, b = state, cs
        for _ in range(RIGID_DEMO_CHECK):
            a, b = fn(a), cfn(b)
        dx = max(max_dev(a.rigid.x.cpu(), b.rigid.x),
                 max_dev(a.particles.x.cpu(), b.particles.x)
                 if b.particles.n else 0.0)
        dq = max_dev(a.rigid.q.cpu(), b.rigid.q)
        del c, cs, cc, cfn, a, b
        x0 = state.rigid.x.clone()
        static = state.rigid.inv_mass == 0
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        s = state
        for _ in range(RIGID_DEMO_STEPS):
            s = fn(s)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        res = joint_residuals(s, cset, h)
        finite = bool(torch.isfinite(s.rigid.x).all()
                      and torch.isfinite(s.rigid.q).all()
                      and torch.isfinite(s.particles.x).all())
        anchors = torch.equal(s.rigid.x[static], x0[static])
        out[name] = {"bodies": state.rigid.n, "particles": state.particles.n,
                     "joints": {jb.kind: jb.n for jb in cset.joints},
                     "route": fn.path,
                     "check_steps": RIGID_DEMO_CHECK,
                     "card_vs_cpu_max_abs_dx": dx,
                     "card_vs_cpu_max_abs_dq": dq, "steps": RIGID_DEMO_STEPS,
                     "steps_s": run_s, "launches": counts,
                     "residuals": res, "finite": finite,
                     "anchors_exact": anchors}
        log(f"phase 9 {name}: {out[name]}")
        assert dx <= RIGID_DEMO_TOL and dq <= RIGID_DEMO_TOL, (name, dx, dq)
        assert all(v == 0 for v in counts.values()), counts
        assert finite and anchors, name
        del d, state, cset, fn, s
    return out


def run_rigid(dev):
    """Phase 9: slice 6a on the card, no kernel of the port on its path.
    R1 (:func:`rigid_planner`): the build's seconds and the route; one
    rollout of ``R1_HORIZON`` steps on the card against the port on the CPU
    (≤ ``R1_CPU_TOL``); an update's ``R1_K`` rollouts, ``R1_SINGLES`` of
    them against the same controls stepped alone (≤ ``R1_SINGLE_TOL``);
    ``R1_UPDATES`` updates with every launch count 0, finite, the anchor
    exact; one step of the K rollouts under CUDA's sync debug mode;
    updates/s and rollout-steps/s (median of windows), the busy share,
    peak device memory and the top five device operations of one update
    under the profiler. Then the demos (:func:`run_rigid_demos`). Returns
    the record of ``{"rigid": ...}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from positionbaseddynamics_tpu_torch import mpc
    from positionbaseddynamics_tpu_torch.mpc.planners import _expand_state

    cpu = torch.device("cpu")
    state, seq, mcfg, build_s = rigid_planner(dev)
    cstate, cseq, _, _ = rigid_planner(cpu)
    log(f"phase 9 R1: chain of {R1_LINKS} links, K {R1_K}, h {R1_HORIZON}, "
        f"built in {build_s!r} s, route {seq.path}")
    assert seq.path == "torch_rigid", seq.path
    gen = torch.Generator(device=dev).manual_seed(9)
    u1 = mcfg.sigma * torch.randn((R1_HORIZON, 6), generator=gen,
                                  device=dev)
    c1, f1 = seq(state, u1)
    cc1, cf1 = cseq(cstate, u1.cpu())
    cpu_dx = max_dev(f1.rigid.x.cpu(), cf1.rigid.x)
    cpu_dq = max_dev(f1.rigid.q.cpu(), cf1.rigid.q)
    log(f"phase 9 R1 one rollout, card vs CPU: max|dx| {cpu_dx!r}, max|dq| "
        f"{cpu_dq!r}, cost {c1.item()!r} vs {cc1.item()!r}")
    assert cpu_dx <= R1_CPU_TOL and cpu_dq <= R1_CPU_TOL, (cpu_dx, cpu_dq)

    nominal = torch.zeros((R1_HORIZON, 6), dtype=torch.float32, device=dev)
    eps = mcfg.sigma * torch.randn((R1_K, R1_HORIZON, 6), generator=gen,
                                   device=dev)
    costs, fk = seq(state, nominal + eps)
    single_dev = 0.0
    for k in np.linspace(0, R1_K - 1, R1_SINGLES).astype(int).tolist():
        ck, fs = seq(state, nominal + eps[k])
        single_dev = max(single_dev, max_dev(fk.rigid.x[k], fs.rigid.x),
                         max_dev(fk.rigid.q[k], fs.rigid.q),
                         abs(costs[k].item() - ck.item())
                         / max(abs(ck.item()), 1e-30))
    log(f"phase 9 R1 {R1_SINGLES} of {R1_K} rollouts against the same "
        f"controls alone: max dev {single_dev!r}")
    assert single_dev <= R1_SINGLE_TOL, single_dev

    nominal = mpc.mppi_update(state, nominal, seq, mcfg, gen)[0]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(R1_UPDATES):
        eps = mcfg.sigma * torch.randn((R1_K, R1_HORIZON, 6), generator=gen,
                                       device=dev)
        last = nominal
        nominal, costs = mpc.mppi_update(state, nominal, seq, mcfg, eps=eps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _, fin = seq(state, last + eps)          # the last update's rollouts
    finite = bool(torch.isfinite(costs).all() and torch.isfinite(nominal).all()
                  and torch.isfinite(fin.rigid.x).all()
                  and torch.isfinite(fin.rigid.q).all())
    anchor = torch.equal(fin.rigid.x[:, 0],
                         state.rigid.x[0].expand(R1_K, 3))
    log(f"phase 9 R1 {R1_UPDATES} updates in {wall!r} s, launch counts "
        f"{counts}, finite {finite}, "
        f"anchor exact {anchor}, peak device memory {peak} B, cost "
        f"{costs.min().item()!r}..{costs.max().item()!r}")
    assert all(v == 0 for v in counts.values()), counts
    assert finite, "R1 produced non-finite values"
    assert anchor, "R1 moved the static anchor"

    batched = seq.step(_expand_state(state, R1_K))
    sync_error = None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched = seq.step(batched)
    except RuntimeError as e:
        sync_error = str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"phase 9 R1 step of {R1_K} rollouts under sync debug mode 'error': "
        f"{'no host sync' if sync_error is None else sync_error}")
    assert sync_error is None, sync_error

    st = [nominal]

    def one_update():
        st[0] = mpc.mppi_update(state, st[0], seq, mcfg, gen)[0]

    rate = rate_windows(one_update, 1)
    rollout_steps = {key: val * R1_K * R1_HORIZON for key, val in
                     rate.items() if key in ("median", "min", "max")}
    log(f"phase 9 R1 updates/s {rate}, rollout-steps/s {rollout_steps}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_update()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    device = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in device)
    launches = sum(ev.count for ev in device)
    top = [{"op": ev.key[:120], "us_per_update": ev.self_device_time_total,
            "count": ev.count}
           for ev in sorted(device,
                            key=lambda ev: -ev.self_device_time_total)[:5]]
    for t in top:
        log(f"  phase 9 R1 device time: {t}")
    busy = busy_us / 1e6 / pwall
    log(f"phase 9 R1 under profiler: device busy {busy!r} of wall time, "
        f"{busy_us!r} us and {launches} device launches an update")
    out = {"R1": {
        "scene": f"examples/chain_demo.py, {R1_LINKS} links, max_iterations "
                 f"{R1_ITERATIONS}, Gauss-Seidel joints",
        "rollouts": R1_K, "horizon": R1_HORIZON, "build_s": build_s,
        "route": seq.path, "card_vs_cpu_max_abs_dx": cpu_dx,
        "card_vs_cpu_max_abs_dq": cpu_dq,
        "singles_max_dev": single_dev, "launches": counts,
        "updates_s_unwindowed": R1_UPDATES / wall,
        "updates_per_s": rate, "rollout_steps_per_s": rollout_steps,
        "device_busy": busy, "device_us_per_update": busy_us,
        "device_launches_per_update": launches, "peak_bytes": peak,
        "top_ops": top, "finite": finite, "anchor_exact": anchor,
        "sync_free_step": sync_error is None}}
    del state, seq, batched, fin, fk
    torch.cuda.empty_cache()
    out.update(run_rigid_demos(dev))
    return out


def _active(pipe, state):
    """Active rigid contact rows of ``pipe`` on ``state`` (a host read, for
    the checks only)."""
    return int(pipe.detect_rigid(state.rigid).mask.sum().item())


def run_pile(dev):
    """Phase 10, P1: ``bench.py --pile-big`` at its default through
    ``bench_torch.pile_scene`` → ``make_step_fn(pipeline=)``: the build's
    seconds and route; ``PILE_CHECK_STEPS`` steps on the card against the
    port on the CPU (≤ ``PILE_TOL``) with the active contact count equal
    at every step; one step under CUDA's sync debug mode; ``PILE_STEPS``
    steps from the start with every launch count 0, finite, overflow 0,
    every centre at or above the floor top + r − 0.05; steps/s (median of
    windows), busy share, device launches and µs a step, peak memory and
    the top five device operations."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    state, cset, pipe = bench_torch.pile_scene(PILE_BODIES, dev)
    fn = make_step_fn(cset, StepConfig(), dev, pipeline=pipe)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"phase 10 P1: {PILE_BODIES} spheres, built in {build_s!r} s, "
        f"route {fn.path}, broad phase {pipe.broad_phase}, "
        f"{len(pipe.rb_pairs)} ordered pairs")
    cs, cc, cp = bench_torch.pile_scene(PILE_BODIES, cpu)
    cfn = make_step_fn(cc, StepConfig(), cpu, pipeline=cp)
    dx, active, counts_equal, a = _card_vs_cpu(
        fn, cfn, state, cs, PILE_CHECK_STEPS,
        lambda st, card: _active(pipe if card else cp, st))
    log(f"phase 10 P1 {PILE_CHECK_STEPS} steps card vs CPU: max dev {dx!r}, "
        f"active rows per step {active}, equal {counts_equal}")
    assert dx <= PILE_TOL, dx
    assert counts_equal, active
    del cs, cc, cp, cfn

    sync_error = _sync_free(fn, a, "phase 10 P1")
    assert sync_error is None, sync_error

    s, run_s, counts, peak = _counted_run(fn, state, PILE_STEPS)
    y = s.rigid.x[1:, 1]
    finite = bool(torch.isfinite(s.rigid.x).all()
                  and torch.isfinite(s.rigid.q).all())
    low = y.min().item()
    overflow = s.overflow.item()
    log(f"phase 10 P1 {PILE_STEPS} steps in {run_s!r} s, launch counts "
        f"{counts}, finite {finite}, overflow {overflow}, lowest centre "
        f"{low!r} (floor top + r = {PILE_FLOOR_TOP + PILE_RADIUS}), peak "
        f"device memory {peak} B")
    assert all(v == 0 for v in counts.values()), counts
    assert finite and overflow == 0.0
    assert low >= PILE_FLOOR_TOP + PILE_RADIUS - 0.05, low

    st = [s]

    def one_step():
        st[0] = fn(st[0])

    rate = rate_windows(one_step, 1)
    log(f"phase 10 P1 steps/s {rate}")
    top, stats = [], {}
    busy, us = profile_busy(fn, st[0], PILE_PROFILE_STEPS, "phase 10 P1",
                            top_out=top, stats=stats)
    return {"scene": f"bench.py --pile-big: {PILE_BODIES} spheres r "
                     f"{PILE_RADIUS} (32 samples) on a (6, 1, 6) box, "
                     f"tolerance 0.02, batched broad phase, StepConfig()",
            "build_s": build_s, "route": fn.path,
            "broad_phase": pipe.broad_phase,
            "card_vs_cpu_max_dev": dx, "check_steps": PILE_CHECK_STEPS,
            "active_rows": active, "active_counts_equal": counts_equal,
            "sync_free_step": sync_error is None, "launches": counts,
            "steps": PILE_STEPS, "steps_s": run_s, "overflow": overflow,
            "finite": finite, "lowest_centre": low, "steps_per_s": rate,
            "device_busy": busy, "device_us_per_step": us,
            "device_launches_per_step": stats["launches_per_step"],
            "peak_bytes": peak, "top_ops": top}


def cloth_on_sphere_scene(builder, dev, n=SPHERE_CLOTH_N, height=0.63):
    """``tests/torch_collision_scenes.py::cloth_on_sphere``: the demo's
    cloth at n×n laid flat in the x–z plane at ``height`` over the static
    sphere of radius 0.6, so that it lands on it (at 0.63, as
    ``tests/test_torch_mpc.py`` lays it, the first contact row is active
    at step 14)."""
    flat = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    b = builder()
    tm = b.add_regular_triangle_model(n, n, translation=(-1.0, height, -1.0),
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


def _active_particle_rows(pipe, state):
    """Active particle–rigid contact rows of ``pipe`` on ``state`` (a host
    read, for the checks only)."""
    p = state.particles
    return int(pipe.detect_particles(p.x, p.v, p.inv_mass, state.rigid)
               .mask.sum().item())


def unstructured_bars_scene(builder, dev):
    """``examples/torch/deformable_collision_demo.py``'s two bars (a 6×2×2
    XPBD FEM bar dropped on a static one, both particle and tet colliders)
    with the FEM tets as the particle batch, which takes a rollout axis
    (the tet-grid solver takes one scene). Returns the top bar's particle
    slice as a fourth element."""
    b = builder(use_structured_grid=False)
    bottom = b.add_regular_tet_model(6, 2, 2, translation=(0.0, 0.0, 0.0),
                                     scale=(1.2, 0.25, 0.4))
    for i in range(bottom.mesh.n_vertices):
        b.set_mass(bottom.offset + i, 0.0)
    top = b.add_regular_tet_model(6, 2, 2, translation=(0.05, 0.45, 0.0),
                                  scale=(1.0, 0.25, 0.3))
    b.add_solid_constraints(top, method=3, stiffness=1e5)
    for h in (bottom, top):
        b.set_particle_collider(h, restitution=0.0, friction=0.2)
        b.set_tet_collider(h, restitution=0.0, friction=0.2,
                           sdf_resolution=20, grid_resolution=16)
    state, cset = b.build(device=dev)
    return (state, cset, b.build_collision_pipeline(device=dev),
            slice(top.offset, top.offset + top.mesh.n_vertices))


def run_collision_demos(dev):
    """Phase 10 demos: the three collision examples and the cloth laid over
    the sphere (fault C-2: the demo's cloth never touches its sphere)
    built on the card, ``COLLISION_DEMO_CHECK`` steps against the port on
    the CPU (≤ ``PILE_TOL``; the laid cloth with equal active
    particle–rigid rows at every step, and rows at the last of them), then
    their full length from the start with every launch count 0 and the
    demos' own checks: the cloth outside the sphere within the tolerance,
    the spheres resting at about r above the floor top, the top bar above
    the bottom one; overflow 0 each."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    def build(name, device):
        if name == "cloth_on_sphere":
            return cloth_on_sphere_scene(SceneBuilder, device) + (None,)
        d = demo(name, device)
        assert d.cfg == StepConfig(), (name, d.cfg)
        return d.state, d.cset, d.pipeline, d.info.get("top")

    cpu = torch.device("cpu")
    out = {}
    for name, steps in (("cloth_collision_demo", 250),
                        ("cloth_on_sphere", SPHERE_CLOTH_STEPS),
                        ("rigid_body_collision_demo", 300),
                        ("deformable_collision_demo", 150)):
        built = build(name, dev)
        state, cset, pipe = built[:3]
        fn = make_step_fn(cset, StepConfig(), dev, pipeline=pipe)
        cs, cc, cp = build(name, cpu)[:3]
        cfn = make_step_fn(cc, StepConfig(), cpu, pipeline=cp)
        a, b = state, cs
        rows, rows_equal = [], True
        for _ in range(COLLISION_DEMO_CHECK):
            if name == "cloth_on_sphere":
                na, nb = _active_particle_rows(pipe, a), \
                    _active_particle_rows(cp, b)
                rows_equal = rows_equal and na == nb
                rows.append(na)
            a, b = fn(a), cfn(b)
        dx = max_dev(a.particles.x.cpu(), b.particles.x) \
            if b.particles.n else 0.0
        if b.rigid is not None:
            dx = max(dx, max_dev(a.rigid.x.cpu(), b.rigid.x),
                     max_dev(a.rigid.q.cpu(), b.rigid.q))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        s = state
        for _ in range(steps):
            s = fn(s)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        finite = bool(torch.isfinite(s.particles.x).all()
                      and (s.rigid is None
                           or torch.isfinite(s.rigid.x).all()))
        rec = {"route": fn.path, "broad_phase": pipe.broad_phase,
               "check_steps": COLLISION_DEMO_CHECK,
               "card_vs_cpu_max_dev": dx, "steps": steps, "steps_s": run_s,
               "launches": counts, "finite": finite,
               "overflow": s.overflow.item()}
        if name in ("cloth_collision_demo", "cloth_on_sphere"):
            r = torch.linalg.vector_norm(s.particles.x, dim=-1)
            rec["min_radius"] = r.min().item()
            ok = rec["min_radius"] >= 0.6 - 0.02 - 1e-3
            if name == "cloth_on_sphere":
                rec["active_particle_rows"] = rows
                rec["active_rows_equal"] = rows_equal
                rec["final_active_rows"] = _active_particle_rows(pipe, s)
                # C-2: the contact is active, card and CPU agree on it
                ok = (ok and rows_equal and rows[-1] > 0
                      and rec["final_active_rows"] > 0)
        elif name == "rigid_body_collision_demo":
            y = s.rigid.x[1:, 1].cpu()
            rec["heights"] = y.tolist()
            ok = bool((y - 0.8).abs().max() <= 0.05)
        else:
            x = s.particles.x
            top = built[3]
            rec["top_min_y"] = x[top, 1].min().item()
            rec["bottom_max_y"] = x[:top.start, 1].max().item()
            ok = rec["top_min_y"] >= rec["bottom_max_y"] - 0.02
        rec["demo_check"] = ok
        out[name] = rec
        log(f"phase 10 {name}: {rec}")
        assert dx <= PILE_TOL, (name, dx)
        assert all(v == 0 for v in counts.values()), counts
        assert finite and rec["overflow"] == 0.0 and ok, name
        del state, cset, pipe, fn, cs, cc, cp, cfn, a, b, s
    return out


def contact_planner(dev):
    """C1: ``bench_torch.ContactMpc`` (``bench.py --mpc-contact``'s inline
    MPPI, ``bench.py:267-335``) at K ``C1_K``, horizon ``C1_HORIZON`` on
    :func:`unstructured_bars_scene`, the top bar's particles driven."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    state, cset, pipe, top = unstructured_bars_scene(SceneBuilder, dev)
    fn = make_step_fn(cset, StepConfig(), dev, pipeline=pipe)
    return bench_torch.ContactMpc(state, fn, top, C1_K, C1_HORIZON, dev)


def run_contact_planner(dev):
    """Phase 10, C1 (:func:`contact_planner`): ``C1_UPDATES`` updates with
    every launch count 0 and the rollouts' overflow 0, rollouts
    ``C1_SINGLES`` of the last update against the same controls run alone
    (≤ ``BATCH_TOL``), updates/s (median of windows) and busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    planner = contact_planner(dev)
    gen = torch.Generator(device=dev).manual_seed(10)

    def draw():
        return planner.draw(gen)

    nominal = torch.zeros((C1_HORIZON, 3), device=dev)
    nominal = planner.update(nominal, draw())[0]            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    overflow = 0.0
    for _ in range(C1_UPDATES):
        eps, last = draw(), nominal
        nominal, costs, st = planner.update(nominal, eps)
        overflow = max(overflow, st.overflow.max().item())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    single = 0.0
    for k in C1_SINGLES:
        ck, sk = planner.rollouts(last + eps[k])
        single = max(single, max_dev(st.particles.x[k], sk.particles.x),
                     abs(costs[k].item() - ck.item())
                     / max(abs(ck.item()), 1e-30))
    finite = bool(torch.isfinite(costs).all() and torch.isfinite(
        nominal).all())
    log(f"phase 10 C1: K {C1_K}, h {C1_HORIZON}, {C1_UPDATES} updates in "
        f"{wall!r} s, launch counts {counts}, overflow {overflow}, rollouts "
        f"{C1_SINGLES} alone max dev {single!r}, cost "
        f"{costs.min().item()!r}..{costs.max().item()!r}")
    assert all(v == 0 for v in counts.values()), counts
    assert overflow == 0.0 and finite
    assert single <= BATCH_TOL, single

    cur = [nominal]

    def one_update():
        cur[0] = planner.update(cur[0], draw())[0]

    rate = rate_windows(one_update, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_update()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    device = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in device)
    busy = busy_us / 1e6 / pwall
    log(f"phase 10 C1 updates/s {rate}, busy {busy!r}, {busy_us!r} us and "
        f"{sum(ev.count for ev in device)} device launches an update")
    return {"scene": "deformable_collision_demo.py's two bars, the top "
                     "bar driven (bench.py --mpc-contact's planner; its "
                     "Armadillo scene file is absent)",
            "rollouts": C1_K, "horizon": C1_HORIZON, "launches": counts,
            "overflow": overflow, "singles_max_dev": single,
            "updates_s_unwindowed": C1_UPDATES / wall,
            "updates_per_s": rate, "device_busy": busy,
            "device_us_per_update": busy_us,
            "device_launches_per_update": sum(ev.count for ev in device)}


def run_collision(dev):
    """Phase 10: slice 6b on the card, no kernel of the port on its path:
    P1 (:func:`run_pile`), the three collision demos
    (:func:`run_collision_demos`) and C1 (:func:`run_contact_planner`).
    Returns the record of ``{"collision": ...}``."""
    out = {"P1": run_pile(dev)}
    torch.cuda.empty_cache()
    out.update(run_collision_demos(dev))
    out["C1"] = run_contact_planner(dev)
    return out


def _quat_dev(a, b) -> float:
    """Largest difference of two quaternion arrays, each entry's sign
    folded (``q`` and ``−q`` are one rotation; ``tests/test_grid_rods.py:
    40-41``)."""
    return torch.minimum((a - b).abs(), (a + b).abs()).max().item()


def _sync_free(fn, state, label):
    """One step of ``fn`` under CUDA's sync debug mode 'error'. Returns
    the error text, None when the step never waited for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    err = None
    try:
        fn(state)
    except RuntimeError as e:
        err = str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"{label} step under sync debug mode 'error': "
        f"{'no host sync' if err is None else err}")
    return err


def _counted_run(fn, state, steps):
    """``steps`` steps from ``state`` with every kernel launch count set to
    0 just before and read just after. Returns ``(state, seconds,
    counts, peak device bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = state
    for _ in range(steps):
        s = fn(s)
    torch.cuda.synchronize()
    return (s, time.perf_counter() - t0, read_counts(),
            torch.cuda.max_memory_allocated())


def _rates(fn, state, label, units):
    """Steps/s (median of windows), busy share, device µs and launches a
    step and the top five device operations of ``fn`` from ``state``."""
    st = [state]

    def one_step():
        st[0] = fn(st[0])

    rate = rate_windows(one_step, 1)
    log(f"{label} steps/s {rate}")
    top, stats = [], {}
    busy, us = profile_busy(fn, st[0], ROD_PROFILE_STEPS, label,
                            top_out=top, stats=stats)
    return {"steps_per_s": rate,
            "aggregate_per_s": {k: v * units for k, v in rate.items()
                                if k in ("median", "min", "max")},
            "device_busy": busy, "device_us_per_step": us,
            "device_launches_per_step": stats["launches_per_step"],
            "top_ops": top}


def run_rod_lattice(dev):
    """Phase 11, rods: ``bench.py --rods`` at its default through
    ``bench_torch.rod_scene`` → ``make_step_fn``."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    cfg = StepConfig()
    t0 = time.perf_counter()
    state, cset = bench_torch.rod_scene(RODS, dev)
    fn = make_step_fn(cset, cfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    route = "rod_lattice" if cset.rod_lattices else "unstructured"
    log(f"phase 11 rods: {RODS} x {bench_torch.ROD_POINTS} points "
        f"({state.particles.n} particles, {state.orientations.n} "
        f"quaternions), built in {build_s!r} s, route {fn.path}, {route}")
    assert route == "rod_lattice" and fn.path == "torch_rods"
    t0 = time.perf_counter()
    us, uc = bench_torch.rod_scene(RODS, dev, structured=False)
    ufn = make_step_fn(uc, cfg, dev)
    torch.cuda.synchronize()
    u_build_s = time.perf_counter() - t0
    cpu = torch.device("cpu")
    cs, cc = bench_torch.rod_scene(RODS, cpu)
    cfn = make_step_fn(cc, cfg, cpu)
    a, b, c = state, us, cs
    for _ in range(ROD_CHECK_STEPS):
        a, b, c = fn(a), ufn(b), cfn(c)
    u_dx = max_dev(a.particles.x, b.particles.x)
    u_dq = _quat_dev(a.orientations.q, b.orientations.q)
    c_dx = max_dev(a.particles.x.cpu(), c.particles.x)
    c_dq = max_dev(a.orientations.q.cpu(), c.orientations.q)
    log(f"phase 11 rods {ROD_CHECK_STEPS} steps: lattice vs batches (built "
        f"in {u_build_s!r} s) max|dx| {u_dx!r}, sign-folded max|dq| "
        f"{u_dq!r}; card vs CPU max|dx| {c_dx!r}, max|dq| {c_dq!r}")
    assert max(u_dx, u_dq) <= ROD_UNSTRUCTURED_TOL, (u_dx, u_dq)
    assert max(c_dx, c_dq) <= PILE_TOL, (c_dx, c_dq)
    del us, uc, ufn, b, cs, cc, cfn, c

    sync_error = _sync_free(fn, state, "phase 11 rods")
    assert sync_error is None, sync_error
    first = fn(state)
    s, run_s, counts, peak = _counted_run(fn, state, ROD_STEPS)
    p, o = s.particles, s.orientations
    pin = state.particles.inv_mass == 0
    pin_q = state.orientations.inv_mass == 0
    finite = bool(torch.isfinite(p.x).all() and torch.isfinite(o.q).all())
    pins_exact = bool(torch.equal(p.x[pin], state.particles.x[pin]))
    frames_exact = bool(torch.equal(o.q[pin_q], first.orientations.q[pin_q]))
    unit = (torch.linalg.vector_norm(o.q, dim=-1) - 1.0).abs().max().item()
    tip_y = p.x[bench_torch.ROD_POINTS - 1, 1].item()
    log(f"phase 11 rods {ROD_STEPS} steps in {run_s!r} s, launch counts "
        f"{counts}, finite {finite}, pinned particles exact {pins_exact}, "
        f"pinned frames as after the first step {frames_exact}, max|1 - "
        f"|q|| {unit!r}, rod 0 tip y {tip_y!r}, peak device memory {peak} B")
    assert all(v == 0 for v in counts.values()), counts
    assert finite and pins_exact and frames_exact, (finite, pins_exact,
                                                    frames_exact)
    assert unit <= 1e-4 and tip_y < 0.0, (unit, tip_y)
    out = {"scene": f"bench.py --rods: {RODS} rods of "
                    f"{bench_torch.ROD_POINTS} points, stretch-shear "
                    f"(1, 1, 1), bend-twist (0.5, 0.5, 0.5), StepConfig()",
           "build_s": build_s, "route": fn.path, "path": route,
           "particles": state.particles.n,
           "quaternions": state.orientations.n,
           "vs_unstructured_max_dx": u_dx, "vs_unstructured_max_dq": u_dq,
           "card_vs_cpu_max_dx": c_dx, "card_vs_cpu_max_dq": c_dq,
           "check_steps": ROD_CHECK_STEPS, "sync_free_step": True,
           "launches": counts, "steps": ROD_STEPS, "steps_s": run_s,
           "finite": finite, "pinned_exact": pins_exact,
           "pinned_frames_exact": frames_exact, "max_unit_err": unit,
           "peak_bytes": peak}
    out.update(_rates(fn, s, "phase 11 rods", RODS))
    return out


def run_tree(dev):
    """Phase 11, the stiff-rod tree: ``bench.py --rods --tree`` at its
    default through ``bench_torch.tree_scene`` → ``make_step_fn``."""
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn

    cfg = StepConfig()
    n_seg = bench_torch.TREE_SEGMENTS
    t0 = time.perf_counter()
    state, cset = bench_torch.tree_scene(n_seg, dev)
    fn = make_step_fn(cset, cfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    db = cset.direct_rods[0]
    log(f"phase 11 tree: {n_seg} segments, {db.edges.shape[0]} constraints "
        f"in {len(db.levels)} levels, built in {build_s!r} s, route "
        f"{fn.path}, scheduled {db.uses_tree}")
    assert fn.path == "torch_rigid" and db.uses_tree
    _, dc = bench_torch.tree_scene(n_seg, dev, solver="dense")
    dfn = make_step_fn(dc, cfg, dev)
    cpu = torch.device("cpu")
    cs, cc = bench_torch.tree_scene(n_seg, cpu)
    cfn = make_step_fn(cc, cfg, cpu)
    a, b, c = state, state, cs
    for _ in range(TREE_CHECK_STEPS):
        a, b, c = fn(a), dfn(b), cfn(c)
    d_dx = max_dev(a.rigid.x, b.rigid.x)
    d_dq = max_dev(a.rigid.q, b.rigid.q)
    c_dx = max_dev(a.rigid.x.cpu(), c.rigid.x)
    c_dq = max_dev(a.rigid.q.cpu(), c.rigid.q)
    log(f"phase 11 tree {TREE_CHECK_STEPS} steps: scheduled vs dense max|dx| "
        f"{d_dx!r} max|dq| {d_dq!r}; card vs CPU max|dx| {c_dx!r} max|dq| "
        f"{c_dq!r}")
    assert max(d_dx, d_dq) <= TREE_TOL, (d_dx, d_dq)
    assert max(c_dx, c_dq) <= PILE_TOL, (c_dx, c_dq)
    del dc, dfn, cs, cc, cfn, b, c

    sync_error = _sync_free(fn, state, "phase 11 tree")
    assert sync_error is None, sync_error
    s, run_s, counts, peak = _counted_run(fn, state, ROD_STEPS)
    root = state.rigid.inv_mass == 0
    finite = bool(torch.isfinite(s.rigid.x).all()
                  and torch.isfinite(s.rigid.q).all())
    root_exact = bool(torch.equal(s.rigid.x[root], state.rigid.x[root]))
    log(f"phase 11 tree {ROD_STEPS} steps in {run_s!r} s, launch counts "
        f"{counts}, finite {finite}, root exact {root_exact}, peak device "
        f"memory {peak} B")
    assert all(v == 0 for v in counts.values()), counts
    assert finite and root_exact
    out = {"scene": f"bench.py --rods --tree: a random tree of {n_seg} "
                    "stiff-rod segments (r 0.05, length 0.3, E = G = 1e6) "
                    "from default_rng(0), the scheduled elimination, "
                    "StepConfig()",
           "build_s": build_s, "route": fn.path, "path": "tree_scheduled",
           "constraints": int(db.edges.shape[0]), "levels": len(db.levels),
           "vs_dense_max_dx": d_dx, "vs_dense_max_dq": d_dq,
           "card_vs_cpu_max_dx": c_dx, "card_vs_cpu_max_dq": c_dq,
           "check_steps": TREE_CHECK_STEPS, "sync_free_step": True,
           "launches": counts, "steps": ROD_STEPS, "steps_s": run_s,
           "finite": finite, "root_exact": root_exact, "peak_bytes": peak}
    out.update(_rates(fn, s, "phase 11 tree", 1))
    return out


def connector_gap(db, rx, rq) -> float:
    """Largest distance between the two connectors of a stiff-rod batch's
    constraints, the zero-stretch residual (``tests/test_stiff_rods.py``
    holds it under 5e-3)."""
    from positionbaseddynamics_tpu_torch.ops import quaternion as quat

    if hasattr(db, "edges"):
        b0, b1 = db.bodies[db.edges[:, 0]], db.bodies[db.edges[:, 1]]
    else:
        b0, b1 = db.bodies[:, :-1], db.bodies[:, 1:]
    c0 = quat.rotate(rq[b0], db.local0) + rx[b0]
    c1 = quat.rotate(rq[b1], db.local1) + rx[b1]
    return torch.linalg.vector_norm(c0 - c1, dim=-1).max().item()


def _rod_demo_check(name, start, s, cset):
    """The demo's own check of a rod example's final state ``s`` (its
    start ``start``), after ``tests/test_examples.py`` and JAX's rod tests:
    pins fixed and the free end fallen, segment lengths kept; the stiff
    rods' root exact, their connectors closed (< 5e-3) and their tips
    fallen; the pendulum's base fixed and its bob within reach of its
    anchor. Returns ``(ok, record)``."""
    rec = {}
    if s.particles.n:
        p0, p = start.particles, s.particles
        pin = p0.inv_mass == 0
        rec["pins_exact"] = bool(torch.equal(p.x[pin], p0.x[pin]))
        rec["fall"] = (p0.x[~pin, 1] - p.x[~pin, 1]).max().item()
        ok = rec["pins_exact"] and rec["fall"] > 1e-3
    if name == "cosserat_rods_demo":
        seg = torch.linalg.vector_norm(s.particles.x[1:] - s.particles.x[:-1],
                                       dim=-1)
        rec["max_segment_stretch"] = (seg.max() / seg.min()).item()
        rec["max_unit_err"] = (torch.linalg.vector_norm(
            s.orientations.q, dim=-1) - 1.0).abs().max().item()
        ok = (ok and rec["max_segment_stretch"] < 1.1
              and rec["max_unit_err"] <= 1e-4)
    elif name == "elastic_rods_demo":
        seg = torch.linalg.vector_norm(s.particles.x[1:10]
                                       - s.particles.x[:9], dim=-1)
        rec["segments"] = [seg.min().item(), seg.max().item()]
        ok = ok and (seg - 0.25).abs().max().item() < 0.05
    elif name in ("stiff_rods_demo", "stiff_rods_demo_tree"):
        r0, r = start.rigid.x, s.rigid.x
        rec["root_exact"] = bool(torch.equal(r[0], r0[0]))
        rec["connector_gap"] = connector_gap(cset.direct_rods[0], r,
                                             s.rigid.q)
        rec["drop"] = (r0[1:, 1] - r[1:, 1]).tolist()
        ok = (rec["root_exact"] and rec["connector_gap"] < 5e-3
              and min(rec["drop"][-2:]) > 0.002)
    elif name == "generic_rigidbody_demo":
        r = s.rigid.x
        rec["base_exact"] = bool(torch.equal(r[0], start.rigid.x[0]))
        rec["bob"] = r[1].tolist()
        ok = (rec["base_exact"] and r[1].norm().item() < 2.1
              and r[1, 1].item() < -0.05)
    return bool(ok), rec


def run_rod_demos(dev):
    """Phase 11 coverage: the rod examples built on the card,
    ``ROD_DEMO_CHECK`` steps against the port on the CPU (≤ ``PILE_TOL``),
    then their full length from the start with every launch count 0 and
    the demo's own check (:func:`_rod_demo_check`)."""
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    cpu = torch.device("cpu")
    out = {}
    for name, script, argv, steps in (
            ("cosserat_rods_demo", "cosserat_rods_demo", (), 300),
            ("elastic_rods_demo", "elastic_rods_demo", (), 300),
            ("stiff_rods_demo", "stiff_rods_demo", (), 200),
            ("stiff_rods_demo_tree", "stiff_rods_demo", ("--tree",), 200),
            ("generic_particle_demo", "generic_particle_demo", (), 200),
            ("generic_rigidbody_demo", "generic_rigidbody_demo", (), 200)):
        d = demo(script, dev, *argv)
        state, cset, cfg = d.state, d.cset, d.cfg
        fn = make_step_fn(cset, cfg, dev)
        c = demo(script, cpu, *argv)
        cs, cc = c.state, c.cset
        cfn = make_step_fn(cc, cfg, cpu)
        a, b = state, cs
        for _ in range(ROD_DEMO_CHECK):
            a, b = fn(a), cfn(b)
        dx = max_dev(a.particles.x.cpu(), b.particles.x) \
            if b.particles.n else 0.0
        if b.orientations is not None:
            dx = max(dx, max_dev(a.orientations.q.cpu(), b.orientations.q))
        if b.rigid is not None:
            dx = max(dx, max_dev(a.rigid.x.cpu(), b.rigid.x),
                     max_dev(a.rigid.q.cpu(), b.rigid.q))
        s, run_s, counts, _ = _counted_run(fn, state, steps)
        finite = bool(torch.isfinite(s.particles.x).all()
                      and (s.rigid is None
                           or torch.isfinite(s.rigid.x).all()))
        ok, rec = _rod_demo_check(name, state, s, cset)
        rec.update({"route": fn.path, "check_steps": ROD_DEMO_CHECK,
                    "card_vs_cpu_max_dev": dx, "steps": steps,
                    "steps_s": run_s, "launches": counts, "finite": finite,
                    "demo_check": ok})
        out[name] = rec
        log(f"phase 11 {name}: {rec}")
        assert dx <= PILE_TOL, (name, dx)
        assert all(v == 0 for v in counts.values()), counts
        assert finite and ok, name
    return out


def run_rod_planner(dev):
    """Phase 11, a planner over rods: one MPPI update (fed noise) at K
    ``ROD_PLANNER[1]``, horizon ``ROD_PLANNER[2]`` over
    ``ROD_PLANNER[0]`` lattice rods of ``bench.py --rods``' shape, rod 0's
    free end driven by a ``PinVelocityControl`` (≤ 2 m/s) toward a target
    0.2 above it; rollouts ``ROD_PLANNER_SINGLES`` of the update against
    their controls run alone (≤ ``BATCH_TOL`` in positions and
    quaternions), the orientations carrying the rollout axis through
    ``make_sequence_cost``."""
    from positionbaseddynamics_tpu_torch import mpc
    from positionbaseddynamics_tpu_torch.solver import StepConfig

    n_rods, k, hz = ROD_PLANNER
    state, cset = bench_torch.rod_scene(n_rods, dev)
    tip = bench_torch.ROD_POINTS - 1
    target = state.particles.x[tip].cpu().numpy() + np.float32(
        [0.0, 0.2, 0.0])
    seq = mpc.make_sequence_cost(
        cset, StepConfig(), mpc.PinVelocityControl(indices=(tip,),
                                                   max_speed=2.0),
        running_cost=mpc.control_effort(1e-3),
        terminal_cost=mpc.particle_target([tip], target), device=dev)
    mcfg = mpc.MPPIConfig(horizon=hz, num_samples=k, sigma=0.5,
                          temperature=0.1)
    gen = torch.Generator(device=dev).manual_seed(13)
    eps = mcfg.sigma * torch.randn((k, hz, 3), generator=gen, device=dev)
    nominal = torch.zeros((hz, 3), device=dev)
    new, costs = mpc.mppi_update(state, nominal, seq, mcfg, eps=eps)
    _, fin = seq(state, nominal + eps)
    single = 0.0
    for i in ROD_PLANNER_SINGLES:
        ci, si = seq(state, nominal + eps[i])
        single = max(single, max_dev(fin.particles.x[i], si.particles.x),
                     max_dev(fin.orientations.q[i], si.orientations.q),
                     abs(costs[i].item() - ci.item())
                     / max(abs(ci.item()), 1e-30))
    finite = bool(torch.isfinite(costs).all() and torch.isfinite(new).all())
    out = {"rods": n_rods, "rollouts": k, "horizon": hz,
           "route": seq.path, "q_shape": list(fin.orientations.q.shape),
           "singles": list(ROD_PLANNER_SINGLES), "singles_max_dev": single,
           "cost_min": costs.min().item(), "cost_max": costs.max().item(),
           "finite": finite}
    log(f"phase 11 MPPI over rods: {out}")
    assert seq.path == "torch_rods" and finite
    assert tuple(fin.orientations.q.shape[:1]) == (k,)
    assert single <= BATCH_TOL, single
    return out


def run_rods(dev):
    """Phase 11: slice 7 on the card, no kernel of the port on its path:
    the rods (:func:`run_rod_lattice`), the stiff-rod tree
    (:func:`run_tree`), the rod examples (:func:`run_rod_demos`) and MPPI
    over rods (:func:`run_rod_planner`). Returns the record of ``{"rods":
    ...}``."""
    out = {"rods": run_rod_lattice(dev)}
    torch.cuda.empty_cache()
    out["tree"] = run_tree(dev)
    out.update(run_rod_demos(dev))
    out["planner"] = run_rod_planner(dev)
    return out


def _card_vs_cpu(fn, cfn, a, b, steps, active):
    """``steps`` steps of ``a`` on the card and ``b`` on the CPU, with
    ``active(state)`` (a host read) recorded on both before each step.
    Returns ``(largest deviation of particles, bodies and rotations, the
    card's active counts, whether they equal the CPU's at every step, the
    card's last state)``."""
    counts, equal = [], True
    for _ in range(steps):
        na, nb = active(a, True), active(b, False)
        equal = equal and na == nb
        counts.append(na)
        a, b = fn(a), cfn(b)
    dx = max_dev(a.particles.x.cpu(), b.particles.x) if b.particles.n \
        else 0.0
    if b.rigid is not None:
        dx = max(dx, max_dev(a.rigid.x.cpu(), b.rigid.x),
                 max_dev(a.rigid.q.cpu(), b.rigid.q))
    return dx, counts, equal, a


def _leaves_equal(a, b) -> bool:
    from positionbaseddynamics_tpu_torch.utils.checkpoint import _leaves

    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def run_scene_pile(dev, directory):
    """Phase 12, the pile stand-in (``bench_torch.write_pile_scene``):
    loaded cold (the bakes) and again from the bake cache, the route, the
    loaded, skipped and dynamic bodies; ``SCENE_CHECK_STEPS`` steps on the
    card against the CPU (≤ ``SCENE_TOL``) with equal active rigid contact
    rows at every step; one step with no host sync; ``SCENE_STEPS`` steps
    with every launch count 0, overflow 0, finite, the dynamic bodies
    above the floor; steps/s, busy share, device launches and µs a step,
    peak memory, top device operations; ``PhaseTimers``; a checkpoint at
    step ``CKPT_STEP`` loaded into the built template, ``CKPT_MORE`` steps
    from each copy bit for bit equal (deterministic algorithms on).
    Returns ``(record, scene path)``."""
    from positionbaseddynamics_tpu_torch.scene import load_scene
    from positionbaseddynamics_tpu_torch.solver import make_step_fn
    from positionbaseddynamics_tpu_torch.utils import (PhaseTimers,
                                                       load_state, save_state)

    path = bench_torch.write_pile_scene(directory)
    cache = os.path.join(directory, "sdf_cache")
    res = bench_torch.SCENE_SDF_RESOLUTION
    timings = []
    for _ in range(2):                      # cold (bakes), then cached
        t0 = time.perf_counter()
        s = load_scene(path, cache_dir=cache, max_sdf_resolution=res,
                       device=dev)
        torch.cuda.synchronize()
        timings.append(time.perf_counter() - t0)
    fn = make_step_fn(s.cset, s.config, dev, pipeline=s.pipeline)
    dynamic = int((s.state.rigid.inv_mass > 0).sum().item())
    rec = {"scene": "stand-in of PileScene.json (bench_torch."
                    "write_pile_scene): a box floor, 25 static cylinders, "
                    "2 dynamic 1,280-face icospheres with baked SDFs, 6 "
                    "bodies of a missing mesh",
           "load_s": timings[1], "bake_s": timings[0] - timings[1],
           "route": fn.path, "broad_phase": s.pipeline.broad_phase,
           "loaded": len(s.rigid_ids), "skipped": len(s.skipped_bodies),
           "dynamic": dynamic, "rb_pairs": len(s.pipeline.rb_pairs)}
    log(f"phase 12 pile: {rec}")
    assert (rec["loaded"], rec["skipped"], dynamic) == (
        PILE_LOADED, PILE_SKIPPED, PILE_DYNAMIC), rec

    cpu = torch.device("cpu")
    c = load_scene(path, cache_dir=cache, max_sdf_resolution=res,
                   device=cpu)
    cfn = make_step_fn(c.cset, c.config, cpu, pipeline=c.pipeline)
    dx, active, equal, last = _card_vs_cpu(
        fn, cfn, s.state, c.state, SCENE_CHECK_STEPS,
        lambda st, card: _active(s.pipeline if card else c.pipeline, st))
    log(f"phase 12 pile {SCENE_CHECK_STEPS} steps card vs CPU: max dev "
        f"{dx!r}, active rows {active}, equal {equal}")
    assert dx <= SCENE_TOL, dx
    assert equal, active
    del c, cfn
    rec.update({"card_vs_cpu_max_dev": dx, "check_steps": SCENE_CHECK_STEPS,
                "active_rows": active, "active_counts_equal": equal})
    err = _sync_free(fn, last, "phase 12 pile")
    assert err is None, err

    st, run_s, counts, peak = _counted_run(fn, s.state, SCENE_STEPS)
    dyn = s.state.rigid.inv_mass > 0
    low = st.rigid.x[dyn, 1].min().item()
    finite = bool(torch.isfinite(st.rigid.x).all()
                  and torch.isfinite(st.rigid.q).all())
    overflow = st.overflow.item()
    log(f"phase 12 pile {SCENE_STEPS} steps in {run_s!r} s, launch counts "
        f"{counts}, finite {finite}, overflow {overflow}, lowest dynamic "
        f"centre {low!r}, peak {peak} B")
    assert all(v == 0 for v in counts.values()), counts
    assert finite and overflow == 0.0
    assert low >= PILE_FLOOR_Y + PILE_BODY_R - 0.05, low
    rec.update({"sync_free_step": True, "steps": SCENE_STEPS,
                "steps_s": run_s, "launches": counts, "finite": finite,
                "overflow": overflow, "lowest_dynamic_centre": low,
                "peak_bytes": peak})
    rec.update(_rates(fn, st, "phase 12 pile", 1))

    timers = PhaseTimers(s.cset, s.config, s.pipeline, device=dev)
    phases = timers.measure(s.state)
    log(f"phase 12 pile {timers.report()}")
    assert set(phases) == {"simulation step",
                           "position constraints projection",
                           "collision detection"}, phases
    assert all(v > 0 for v in phases.values()), phases
    rec["phase_timers_s"] = phases

    st = s.state
    for _ in range(CKPT_STEP):
        st = fn(st)
    ckpt = os.path.join(directory, "pile_step100.npz")
    save_state(ckpt, st)
    loaded = load_state(ckpt, s.state)
    same_leaves = _leaves_equal(st, loaded)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = st, loaded
        for _ in range(CKPT_MORE):
            a, b = fn(a), fn(b)
        resumed = _leaves_equal(a, b)
        resumed_dev = max(max_dev(a.rigid.x, b.rigid.x),
                          max_dev(a.rigid.q, b.rigid.q))
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"phase 12 checkpoint at step {CKPT_STEP}: leaves equal "
        f"{same_leaves}, {CKPT_MORE} more steps from each bit for bit "
        f"{resumed} (max dev {resumed_dev!r})")
    assert same_leaves and resumed
    rec["checkpoint"] = {"step": CKPT_STEP, "leaves_equal": same_leaves,
                         "more_steps": CKPT_MORE, "resumed_equal": resumed}
    return rec, path


def run_scene_runner(dev, pile_path, cloth_path, directory):
    """Phase 12, ``run_scene_torch.py`` in this process: the pile stand-in
    with ``--export-npz`` (``particles_x``, ``rigid_x``, ``rigid_q``) and
    the cloth stand-in with ``--export-obj`` (its OBJ frames, ``vt``
    lines and ``f v/vt`` corners)."""
    import contextlib
    import io

    import run_scene_torch

    out = {}
    res = str(bench_torch.SCENE_SDF_RESOLUTION)
    for name, path in (("pile", pile_path), ("cloth", cloth_path)):
        npz = os.path.join(directory, f"run_{name}.npz")
        obj = os.path.join(directory, f"run_{name}_obj")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            code = run_scene_torch.main([
                path, "--steps", str(RUN_SCENE_STEPS), "--export-npz", npz,
                "--export-obj", obj, "--max-sdf-resolution", res,
                "--cache-dir", os.path.join(directory, "sdf_cache"),
                "--device", str(dev)])
        lines = text.getvalue().splitlines()
        for line in lines:
            log(f"  run_scene_torch {name}: {line}")
        assert code == 0, (name, code)
        with np.load(npz) as z:
            keys = sorted(z.files)
            finite = all(bool(np.isfinite(z[k]).all()) for k in keys)
        frames = sorted(os.listdir(obj)) if os.path.isdir(obj) else []
        vt = 0
        if frames:
            with open(os.path.join(obj, frames[0])) as f:
                text = f.read()
            vt = text.count("\nvt ")
            assert "/" in text.split("\nf ", 1)[1], frames[0]
        out[name] = {"exit": code, "npz_keys": keys, "finite": finite,
                     "obj_frames": len(frames), "vt_lines": vt,
                     "json": json.loads(lines[1])}
    log(f"phase 12 run_scene_torch: {out}")
    for rec in out.values():
        assert rec["npz_keys"] == ["particles_x", "rigid_q", "rigid_x"], rec
        assert rec["finite"], rec
    assert out["cloth"]["obj_frames"] == (RUN_SCENE_STEPS - 1) // 8
    assert out["cloth"]["vt_lines"] > 0
    return out


def run_scene_contact(dev, directory):
    """Phase 12, the contact stand-in (``bench_torch.write_contact_scene``,
    3 tet models of 1,280 vertices): ``bench_torch.armadillo_batch`` at B
    ``ARMADILLO_B``, its rollout 0 against the scene stepped alone as many
    times (≤ ``BATCH_TOL``); ``bench_torch.mpc_contact`` at its default K
    and h, ``CONTACT_UPDATES`` updates after a warm-up, finite, overflow 0,
    and the busy share of one update."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = bench_torch.write_contact_scene(directory)
    t0 = time.perf_counter()
    scene = bench_torch.load_bench_scene(path, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    out = {"scene": "stand-in of ArmadilloCollisionScene.json (bench_torch."
                    "write_contact_scene): 3 tet models of 20x8x8 "
                    "vertices (1,280 and 4,655 tets each) from .node/.ele "
                    "over a static box floor, collisionObjectType 5",
           "load_s": load_s, "particles": scene.state.particles.n,
           "solid_pairs": len(scene.pipeline.solid_pairs)}
    reset_counts()
    rec, s, fn, batch = bench_torch.armadillo_batch(
        path, dev, ARMADILLO_B, ARMADILLO_CALLS, ARMADILLO_STEPS_PER_CALL,
        scene=scene)
    counts = read_counts()
    st = s.state
    for _ in range(1 + ARMADILLO_CALLS * ARMADILLO_STEPS_PER_CALL):
        st = fn(st)
    single = max_dev(batch.particles.x[0], st.particles.x)
    out["armadillo_batch"] = {**rec, "route": fn.path, "launches": counts,
                              "rollout0_vs_alone_max_dev": single,
                              "steps": 1 + ARMADILLO_CALLS
                              * ARMADILLO_STEPS_PER_CALL}
    log(f"phase 12 contact: loaded in {load_s!r} s; armadillo batch "
        f"{out['armadillo_batch']}")
    assert single <= BATCH_TOL, single
    assert rec["capacity_overflow"] == 0.0, rec
    assert all(v == 0 for v in counts.values()), counts

    reset_counts()
    rec, planner = bench_torch.mpc_contact(path, dev, 256, 10,
                                           CONTACT_UPDATES, scene=scene)
    counts = read_counts()
    gen = torch.Generator(device=dev).manual_seed(12)
    nominal = torch.zeros((planner.horizon, 3), device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nominal, costs, _ = planner.update(nominal, planner.draw(gen))
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    device = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in device)
    finite = bool(torch.isfinite(costs).all() and torch.isfinite(
        nominal).all())
    out["mpc_contact"] = {
        **rec, "launches": counts, "finite": finite,
        "device_busy": busy_us / 1e6 / pwall, "device_us_per_update":
        busy_us, "device_launches_per_update":
        sum(ev.count for ev in device)}
    log(f"phase 12 contact mpc: {out['mpc_contact']}")
    assert finite and rec["capacity_overflow"] == 0.0, rec
    assert all(v == 0 for v in counts.values()), counts
    return out


def _ulp_spread(fn, state, steps):
    """A scene's own float32 spread on the card: ``fn`` from ``state``
    against the same run whose free particles take one float32 step of
    noise in x after every step, as another rounding order adds (the
    witness of ``tests/test_torch_scene_cloth_spread.py``), once with the
    sign alternating and once always the same; the largest particle
    deviation over the steps and both runs."""
    free = state.particles.inv_mass > 0
    out = 0.0
    for sign in ((lambda i: (-1) ** i), (lambda i: 1)):
        a = b = state
        for i in range(steps):
            a, b = fn(a), fn(b)
            p = b.particles
            x = p.x.clone()
            x[free] = torch.nextafter(x[free], torch.full_like(
                x[free], sign(i) * math.inf))
            b = dataclasses.replace(b, particles=dataclasses.replace(p, x=x))
            out = max(out, max_dev(a.particles.x, b.particles.x))
    return out


def run_scene_cloth(dev, directory, xpbd=False):
    """Phase 12, the cloth stand-in (``bench_torch.write_cloth_scene``, a
    51×51 plane OBJ over a baked-SDF sphere), with the loader's default
    cloth methods or with ``xpbd``: ``SCENE_CHECK_STEPS`` steps on the
    card against the CPU with equal active particle–rigid rows at every
    step. The bar is ``SCENE_TOL`` for the XPBD cloth; the default cloth
    parts from itself by more than that in float32 (JAX's own spread,
    ``tests/test_torch_scene_cloth_spread.py``), so its bar is the card's
    own spread over the same steps (:func:`_ulp_spread`) where that is
    larger. The default cloth then takes ``SCENE_STEPS`` steps with every
    launch count 0, finite, the static corners exact, the overflow
    counter recorded. Returns ``(record, scene path)``."""
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    path = bench_torch.write_cloth_scene(directory, xpbd=xpbd)
    t0 = time.perf_counter()
    s = bench_torch.load_bench_scene(path, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fn = make_step_fn(s.cset, s.config, dev, pipeline=s.pipeline)
    cpu = torch.device("cpu")
    c = bench_torch.load_bench_scene(path, cpu)
    cfn = make_step_fn(c.cset, c.config, cpu, pipeline=c.pipeline)
    dx, rows, equal, _ = _card_vs_cpu(
        fn, cfn, s.state, c.state, SCENE_CHECK_STEPS,
        lambda st, card: _active_particle_rows(
            s.pipeline if card else c.pipeline, st))
    del c, cfn
    spread = None if xpbd else _ulp_spread(fn, s.state, SCENE_CHECK_STEPS)
    bar = SCENE_TOL if xpbd else max(SCENE_TOL, spread)
    pins = s.state.particles.inv_mass == 0
    rec = {"scene": "stand-in of ClothOnBunny.json (bench_torch."
                    "write_cloth_scene): a 51x51 plane OBJ, two static "
                    "corners, over a baked-SDF icosphere; "
                    + ("XPBD distance and isometric bending" if xpbd else
                       "the loader's default FEM triangles and classic "
                       "isometric bending"),
           "load_s": load_s, "route": fn.path,
           "particles": s.state.particles.n, "static": int(pins.sum()),
           "card_vs_cpu_max_dev": dx, "check_steps": SCENE_CHECK_STEPS,
           "float32_spread": spread, "bar": bar,
           "active_particle_rows": rows, "active_rows_equal": equal}
    log(f"phase 12 cloth{' (XPBD)' if xpbd else ''}: {rec}")
    assert dx <= bar and equal, (dx, bar, rows)
    assert max(rows) > 0 and int(pins.sum()) == 2, rec
    if xpbd:
        return rec, path
    st, run_s, counts, peak = _counted_run(fn, s.state, SCENE_STEPS)
    rec.update({
        "steps": SCENE_STEPS, "steps_s": run_s, "launches": counts,
        "finite": bool(torch.isfinite(st.particles.x).all()),
        "corners_exact": bool(torch.equal(st.particles.x[pins],
                                          s.state.particles.x[pins])),
        "overflow": st.overflow.item(), "peak_bytes": peak,
        "final_active_rows": _active_particle_rows(s.pipeline, st)})
    log(f"phase 12 cloth {SCENE_STEPS} steps: {rec}")
    assert all(v == 0 for v in counts.values()), counts
    # no overflow bar: once the cloth drapes the body more than a quarter
    # of its particles touch it, past the particle-contact compaction's
    # capacity (JAX's max(512, rows // 4), detection.py:537), and the
    # counter records the rows dropped, as it does in JAX
    assert rec["finite"] and rec["corners_exact"], rec
    assert rec["final_active_rows"] > 0, rec
    return rec, path


def _test_examples():
    """``tests/test_examples.py`` loaded by path: the JAX demos' checks."""
    spec = importlib.util.spec_from_file_location(
        "jax_demo_checks", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "test_examples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _demo_frames(fn, state, steps, fluid):
    """The demo's run from its warm-up step, ``steps`` steps, frames every 8
    (the export of ``examples/torch/_common.py``), with every launch count
    set to 0 just after the warm-up. Returns ``(frames, counts)``."""
    st = fn(state)                                # the demo's warm-up
    torch.cuda.synchronize()
    reset_counts()
    frames = []
    for i in range(steps):
        st = fn(st)
        if i % 8 == 0:
            frames.append((st.x if fluid else st.particles.x).cpu().numpy())
    torch.cuda.synchronize()
    return np.stack(frames), read_counts()


def run_kernel_demos(dev):
    """Phase 12, the three kernel demos, each built by its ``build(args,
    device)``. At their defaults: the route ``cuda_kernel``;
    ``KERNEL_DEMO_CHECK`` steps against the plain versions (≤
    ``KERNEL_DEMO_TOL``); the demo's 200 steps from its warm-up step with
    its kernels launched ``KERNEL_DEMO_LAUNCHES`` times a step and the
    others never, finite. Then at ``tests/test_examples.py``'s arguments
    the demo's own check on frames every 8 steps, on the card. (At the
    fluid demo's defaults that check fails in JAX itself: the block's top
    layer starts on the box's lid and is thrown out of the box, the port
    with it, ``tests/test_torch_example_fluid_defaults.py``; at the
    cloth's and the bar's defaults it holds, and is applied there too.)"""
    from positionbaseddynamics_tpu_torch.fluids import model as fm
    from positionbaseddynamics_tpu_torch.solver import make_step_fn
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    checks = _test_examples()
    test_args = {}
    for script, argv, check in checks.DEMOS:
        test_args.setdefault(script[:-3], (argv, check))
    out = {}
    for name in ("cloth_demo", "bar_demo", "fluid_demo"):
        fluid = name == "fluid_demo"
        argv, check = test_args[name]

        def step_fn(d):
            if fluid:
                return fm.make_fluid_step_fn(d.cset, device=dev)
            return make_step_fn(d.cset, d.cfg, dev)

        d = demo(name, dev)
        fn = step_fn(d)
        if fluid:
            a = b = d.state
            for _ in range(KERNEL_DEMO_CHECK):
                a, b = fn(a), fm.fluid_step_reference(b, d.cset)
            dx = max_dev(a.x, b.x)
        else:
            cfg = d.cfg
            p = d.state.particles
            a = d.state
            for _ in range(KERNEL_DEMO_CHECK):
                a = fn(a)
            n_sub, h = KERNEL_DEMO_CHECK * cfg.substeps, cfg.dt / cfg.substeps
            if name == "cloth_demo":
                x, _ = plain_steps(d.cset.grid_cloths[0], p.x, p.v,
                                   p.inv_mass, n_sub, h)
            else:
                x, v = p.x, p.v
                for _ in range(n_sub):
                    x, v = gtc.tet_substep_reference(
                        d.cset.grid_tets[0], x, v, p.inv_mass, h=h)
            dx = max_dev(a.particles.x, x)
        steps = 200                               # the demos' default
        frames, counts = _demo_frames(fn, d.state, steps, fluid)
        want = {k: v * steps for k, v in KERNEL_DEMO_LAUNCHES[name].items()}
        finite = bool(np.isfinite(frames).all())
        if not fluid:
            check({"particles": frames})
        td = demo(name, dev, *argv)
        tfn = step_fn(td)
        tsteps = int(argv[argv.index("--steps") + 1])
        tframes, _ = _demo_frames(tfn, td.state, tsteps, fluid)
        check({"particles": tframes})
        rec = {"route": fn.path, "check_steps": KERNEL_DEMO_CHECK,
               "max_abs_err_vs_plain": dx, "steps": steps,
               "launches": counts, "finite": finite,
               "default_check": None if fluid else True,
               "test_args": argv, "test_args_route": tfn.path,
               "demo_check": True}
        if fluid:
            rec["default_max_abs_xz"] = float(np.abs(frames[-1][:, [0, 2]])
                                              .max())
        out[name] = rec
        log(f"phase 12 {name}: {rec}")
        assert fn.path == tfn.path == "cuda_kernel", (name, fn.path)
        assert dx <= KERNEL_DEMO_TOL[name], (name, dx)
        assert counts == {k: want.get(k, 0) for k in counts}, (name, counts)
        assert finite, name
    return out


def run_scenes(dev):
    """Phase 12: slice 8 on the card. The three stand-ins written to a
    temporary directory and loaded (:func:`run_scene_pile`,
    :func:`run_scene_contact`, :func:`run_scene_cloth`),
    ``run_scene_torch.py`` in this process (:func:`run_scene_runner`) and
    the three kernel demos (:func:`run_kernel_demos`). Returns the record
    of ``{"scenes": ...}``."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        out = {}
        t0 = time.perf_counter()
        out["pile"], pile_path = run_scene_pile(dev, d)
        torch.cuda.empty_cache()
        out["cloth"], cloth_path = run_scene_cloth(dev, d)
        out["cloth_xpbd"], _ = run_scene_cloth(
            dev, os.path.join(d, "xpbd"), xpbd=True)
        out["run_scene_torch"] = run_scene_runner(dev, pile_path, cloth_path,
                                                  d)
        out.update(run_scene_contact(dev, d))
        torch.cuda.empty_cache()
        out["kernel_demos"] = run_kernel_demos(dev)
        out["phase_s"] = time.perf_counter() - t0
    log(f"phase 12 took {out['phase_s']!r} s")
    return out


def fused_bound(nb, rows=GRID, substeps=5):
    """The least time of one fused launch of ``substeps`` substeps of
    ``nb`` rollouts of a ``rows``×``GRID`` cloth: its state read and
    written once (w, icd and icb read once for all rollouts) against its
    operations. Returns ``(ms, "bytes" or "operations")``."""
    n_part = nb * rows * GRID
    t_bytes = 4 * (12 * n_part + 3 * rows * GRID) / H100_BYTES_PER_S * 1e3
    t_ops = (substeps * (FLOPS_FIXED + FLOPS_PER_ITERATION) * n_part
             / H100_FP32_FLOPS * 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_fused(dev, gc, p, nb):
    """Phase 13a: B1 fused (one cooperative launch a step) at ``n_batch``
    ``nb`` on the bench cloth (rollouts set apart by their start
    velocities): against the per-substep kernel bit for bit in x and v at
    each of ``PAR_BIT_ITERS`` iterations and ``PAR_BIT_DAMPING`` over
    ``PAR_BIT_STEPS`` steps, with its grid size against
    ``fused_grid``; over ``PAR_STEPS`` steps at one iteration, one launch
    a step, against the per-substep kernel (``FUSED_TOL``, and whether bit
    for bit) and against the plain version (``CHECK_TOL``); then the fused
    launch's time beside 5 per-substep launches and its bound."""
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    x = p.x.expand(nb, *p.x.shape).clone()
    v = torch.zeros_like(x)
    v[..., 2] = 0.05 * torch.arange(nb, device=dev)[:, None] / max(nb - 1, 1)
    if nb == 1:
        x, v = x[0], v[0]

    def step(fuse, iters=1, damping=0.0):
        return gcc.make_cloth_step(gc, p.inv_mass, gc.inv_cnt_dist,
                                   gc.inv_cnt_bend, dt=0.005, substeps=5,
                                   max_iterations=iters, damping=damping,
                                   n_batch=nb, fuse_substeps=fuse)

    bitwise = {}
    for iters in PAR_BIT_ITERS:
        for damping in PAR_BIT_DAMPING:
            fused, per = step(True, iters, damping), step(False, iters,
                                                          damping)
            xf, vf, xs, vs = x, v, x, v
            for _ in range(PAR_BIT_STEPS):
                xf, vf = fused(xf, vf)
                xs, vs = per(xs, vs)
            torch.cuda.synchronize()
            bitwise[f"it{iters}_damping{damping}"] = bool(
                torch.equal(xf, xs) and torch.equal(vf, vs)
                and torch.isfinite(xf).all())
    del xf, vf, xs, vs, fused, per
    grid = gcc.cloth_fused_cuda.grid
    want_grid = gcc.fused_grid(nb, GRID, GRID, gcc.fused_capacity())

    fused, per = step(True), step(False)
    before = launch_count("cloth_substep_fused")
    xf, vf, xs, vs = x, v, x, v
    for _ in range(PAR_STEPS):
        xf, vf = fused(xf, vf)
        xs, vs = per(xs, vs)
    launches = launch_count("cloth_substep_fused") - before
    plain_dx = 0.0
    for lo in range(0, nb, PAR_PLAIN_CHUNK):
        sl = slice(lo, lo + PAR_PLAIN_CHUNK)
        xc, vc = (x, v) if nb == 1 else (x[sl], v[sl])
        xr, _ = plain_steps(gc, xc, vc, p.inv_mass, 5 * PAR_STEPS, 0.001)
        plain_dx = max(plain_dx, max_dev(xf if nb == 1 else xf[sl], xr))
        del xr
    torch.cuda.synchronize()
    out = {"launches": launches, "vs_per_substep_max_dx": max_dev(xf, xs),
           "vs_per_substep_max_dv": max_dev(vf, vs),
           "bit_equal_per_substep": bool(torch.equal(xf, xs)
                                         and torch.equal(vf, vs)),
           "bit_equal_cases": bitwise, "grid": grid, "want_grid": want_grid,
           "plain_max_abs_err": plain_dx,
           "finite": bool(torch.isfinite(xf).all()
                          and torch.isfinite(vf).all())}
    del xs, vs, fused, per

    params = gcc.kernel_params(gc, h=0.001)
    w = p.inv_mass.reshape(GRID, GRID)
    icd = gc.inv_cnt_dist.reshape(GRID, GRID).contiguous()
    icb = gc.inv_cnt_bend.reshape(GRID, GRID).contiguous()
    buf = [gcc.to_planes(x, GRID, GRID), gcc.to_planes(v, GRID, GRID)]

    scratch = gcc.FusedScratch()

    def fused_launch():
        buf[:] = gcc.cloth_fused_cuda(buf[0], buf[1], w, icd, icb, params,
                                      1, 5, scratch)

    def substep_launch():
        buf[:] = gcc.cloth_substep_cuda(buf[0], buf[1], w, icd, icb, params)

    for key, fn, kname in (("ms", fused_launch, "cloth_fused_kernel"),
                           ("substep_ms", substep_launch, B1_KERNELS)):
        kms = device_ms(fn, PAR_TIMED[nb], kname)
        out[key] = (cuda_time_ms(fn, PAR_TIMED[nb]) if kms is None
                    else kms)
        out[key + "_source"] = "cuda events" if kms is None else "profiler"
    out["substep_kernel"] = b1_kernel(nb, GRID, GRID)
    out["five_substeps_ms"] = 5 * out["substep_ms"]
    out["over_five_substeps"] = out["ms"] / out["five_substeps_ms"]
    if nb == 1:                 # the plain version of one fused launch
        out["plain_ms"] = cuda_time_ms(
            lambda: plain_steps(gc, x, v, p.inv_mass, 5, 0.001), 3)
    out["bound_ms"], out["bound_by"] = fused_bound(nb)
    out["substep_bound_ms"] = 5 * fused_bound(nb, substeps=1)[0]
    log(f"phase 13 fused B1 at n_batch {nb}: {out}")
    assert launches == PAR_STEPS, launches
    assert all(bitwise.values()), bitwise
    assert grid == want_grid, (grid, want_grid)
    assert out["finite"]
    assert out["vs_per_substep_max_dx"] <= FUSED_TOL[0], out
    assert out["vs_per_substep_max_dv"] <= FUSED_TOL[1], out
    assert plain_dx <= CHECK_TOL, plain_dx
    return out


def check_windows(dev, gc, p):
    """Phase 13b: ``WINDOW_RANKS`` ranks in this process, each a window of
    R + 2·exch rows of the bench cloth cut at ``r·R − exch`` (zeros beyond
    the cloth) and stepped by the fused window kernel, re-cut from the
    stitched kept rows after every step, ``PAR_STEPS`` steps: the kept rows
    against the unsharded fused step (``WINDOW_TOL``), each window against
    its plain version (``CHECK_TOL``); the window launch's time beside its
    plain version and its bound."""
    from positionbaseddynamics_tpu_torch.parallel import intra_cuda
    from positionbaseddynamics_tpu_torch.solver import StepConfig
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
    from positionbaseddynamics_tpu_torch.solver.grid_window import (
        window_substeps_reference)

    r_loc = GRID // WINDOW_RANKS
    exch = intra_cuda.exchange_rows(StepConfig())
    rows = r_loc + 2 * exch
    params = gcc.kernel_params(gc, h=0.001)
    planes = [p.inv_mass.reshape(GRID, GRID, 1),
              gc.inv_cnt_dist.reshape(GRID, GRID, 1),
              gc.inv_cnt_bend.reshape(GRID, GRID, 1)]

    def cut(a, off):
        out = a.new_zeros((rows,) + tuple(a.shape[1:]))
        lo, hi = max(off, 0), min(off + rows, GRID)
        out[lo - off:hi - off] = a[lo:hi]
        return out

    full = gcc.make_cloth_step(gc, p.inv_mass, gc.inv_cnt_dist,
                               gc.inv_cnt_bend, dt=0.005, substeps=5,
                               fuse_substeps=True)
    xg, vg = p.x.reshape(GRID, GRID, 3), p.v.reshape(GRID, GRID, 3)
    xu, vu = p.x, p.v
    plain_dx = 0.0
    before = launch_count("cloth_substep_window")
    for _ in range(PAR_STEPS):
        kept = []
        for r in range(WINDOW_RANKS):
            off = r * r_loc - exch
            w, icd, icb = (cut(a, off).contiguous() for a in planes)
            xe, ve = cut(xg, off), cut(vg, off)
            xk, vk = gcc.cloth_window_cuda(
                gcc.to_planes(xe, rows, GRID), gcc.to_planes(ve, rows, GRID),
                w[..., 0], icd[..., 0], icb[..., 0], params, 1, 5, off, GRID)
            xk, vk = xk.permute(0, 2, 3, 1)[0], vk.permute(0, 2, 3, 1)[0]
            xr, _ = window_substeps_reference(params, xe, ve, w, icd, icb,
                                              row_offset=off,
                                              global_height=GRID, n=5)
            plain_dx = max(plain_dx, max_dev(xk, xr))
            kept.append((xk[exch:exch + r_loc], vk[exch:exch + r_loc]))
        xg = torch.cat([k[0] for k in kept])
        vg = torch.cat([k[1] for k in kept])
        xu, vu = full(xu, vu)
    torch.cuda.synchronize()
    out = {"ranks": WINDOW_RANKS, "rows": r_loc, "exchange_rows": exch,
           "launches": launch_count("cloth_substep_window") - before,
           "stitched_vs_unsharded_max_dx": max_dev(xg.reshape(-1, 3), xu),
           "stitched_vs_unsharded_max_dv": max_dev(vg.reshape(-1, 3), vu),
           "plain_max_abs_err": plain_dx}

    off = r_loc - exch                  # rank 1's window, for the timings
    w, icd, icb = (cut(a, off).contiguous() for a in planes)
    xe, ve = cut(xg, off), cut(vg, off)
    buf = [gcc.to_planes(xe, rows, GRID), gcc.to_planes(ve, rows, GRID)]

    scratch = gcc.FusedScratch()

    def window_launch():
        buf[:] = gcc.cloth_window_cuda(buf[0], buf[1], w[..., 0],
                                       icd[..., 0], icb[..., 0], params, 1,
                                       5, off, GRID, scratch)

    kms = device_ms(window_launch, PAR_TIMED[1], "cloth_fused_kernel")
    out["ms"] = cuda_time_ms(window_launch, PAR_TIMED[1]) if kms is None \
        else kms
    out["ms_source"] = "cuda events" if kms is None else "profiler"
    out["plain_ms"] = cuda_time_ms(
        lambda: window_substeps_reference(params, xe, ve, w, icd, icb,
                                          row_offset=off,
                                          global_height=GRID, n=5), 3)
    out["bound_ms"], out["bound_by"] = fused_bound(1, rows=rows)
    out["grid"] = gcc.cloth_window_cuda.grid
    log(f"phase 13 windows: {out}")
    assert out["launches"] == PAR_STEPS * WINDOW_RANKS, out
    assert out["stitched_vs_unsharded_max_dx"] <= WINDOW_TOL, out
    assert plain_dx <= CHECK_TOL, plain_dx
    return out


def _rate(fn, state):
    st = [state]

    def one():
        st[0] = fn(st[0])

    return rate_windows(one, 1)


def run_parallel_modules(dev):
    """Phase 13c: each ``parallel/`` module at world size 1 through NCCL
    (an in-process ``HashStore``): ``intra_cuda`` against
    ``make_cloth_step(fuse_substeps=True)`` over ``PAR_STEPS`` steps
    (``WINDOW_TOL``), then ``PAR_MAIN_STEPS`` counted steps (B1's window
    launches, one a step); ``intra_grid`` against ``make_step_fn``'s
    structured route over ``INTRA_GRID_STEPS`` (``INTRA_GRID_TOL``);
    ``make_sharded_step_fn`` at ``DP_ROLLOUTS`` rollouts against the
    unsharded batched step, bit for bit; ``intra`` on the unstructured
    bench cloth against ``make_step_fn`` over ``PAR_STEPS`` (``INTRA_TOL``);
    steps/s of each."""
    import torch.distributed as dist

    from positionbaseddynamics_tpu_torch import parallel as par
    from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    cfg = StepConfig()
    out = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = par.make_group(device=dev)
        state, cset = cloth_scene(GRID, GRID, dev)
        gc, p = cset.grid_cloths[0], state.particles

        fn = par.make_cuda_intra_step_fn(gc, p.inv_mass, cfg, group)
        ref = gcc.make_cloth_step(gc, p.inv_mass, gc.inv_cnt_dist,
                                  gc.inv_cnt_bend, dt=cfg.dt,
                                  substeps=cfg.substeps, fuse_substeps=True)
        xv, xr = (p.x, p.v), (p.x, p.v)
        for _ in range(PAR_STEPS):
            xv, xr = fn(*xv), ref(*xr)
        dx = max_dev(xv[0], xr[0])
        xv, run_s, counts, _ = _counted_run(lambda a: fn(*a), xv,
                                            PAR_MAIN_STEPS)
        log(f"phase 13 intra_cuda: {PAR_MAIN_STEPS} steps in {run_s!r} s, "
            f"launch counts {counts}")
        out["intra_cuda"] = {
            "max_abs_dx_vs_fused": dx, "bit_equal": dx == 0.0,
            "launches": counts, "finite": bool(torch.isfinite(xv[0]).all()),
            "steps_per_s": _rate(lambda a: fn(*a), xv)}
        assert dx <= WINDOW_TOL, dx
        assert counts == {k: PAR_MAIN_STEPS if k == "cloth_substep_window"
                          else 0 for k in counts}, counts
        assert out["intra_cuda"]["finite"]

        fn = par.make_grid_intra_step_fn(gc, p.inv_mass, cfg, group)
        step = make_step_fn(cset, cfg)
        xv, st = (p.x, p.v), state
        for _ in range(INTRA_GRID_STEPS):
            xv, st = fn(*xv), step(st)
        dx = max_dev(xv[0], st.particles.x)
        out["intra_grid"] = {"max_abs_dx_vs_step_fn": dx,
                             "steps": INTRA_GRID_STEPS,
                             "steps_per_s": _rate(lambda a: fn(*a), xv)}
        assert dx <= INTRA_GRID_TOL, dx

        batch = par.replicate_scene(state, DP_ROLLOUTS)
        v = batch.particles.v.clone()
        v[..., 2] = 0.05 * torch.arange(DP_ROLLOUTS, device=dev)[:, None] \
            / (DP_ROLLOUTS - 1)
        batch = dataclasses.replace(batch, particles=dataclasses.replace(
            batch.particles, v=v))
        sharded = par.make_sharded_step_fn(cset, cfg, group)
        a, b = par.shard_batch(batch, group), batch
        for _ in range(2):
            a, b = sharded(a), step(b)
        a = par.gather_batch(a, group)
        out["sharded"] = {
            "rollouts": DP_ROLLOUTS, "route": sharded.path,
            "bit_equal": bool(torch.equal(a.particles.x, b.particles.x)
                              and torch.equal(a.particles.v, b.particles.v)),
            "steps_per_s": _rate(sharded, a)}
        out["sharded"]["rollout_steps_per_s"] = {
            k: v * DP_ROLLOUTS for k, v in out["sharded"]["steps_per_s"]
            .items() if k in ("median", "min", "max")}
        assert out["sharded"]["bit_equal"], out["sharded"]
        del a, b, batch, v

        us, uc = cloth_scene(GRID, GRID, dev, structured=False)
        fn = par.make_intra_sharded_step_fn(us, uc, cfg, group)
        step = make_step_fn(uc, cfg)
        a = par.shard_particles(par.pad_state_for_mesh(us, group), group)
        b = us
        for _ in range(PAR_STEPS):
            a, b = fn(a), step(b)
        dx = max_dev(a.particles.x, b.particles.x)
        out["intra"] = {"route": step.path, "max_abs_dx_vs_step_fn": dx,
                        "steps_per_s": _rate(fn, a)}
        assert dx <= INTRA_TOL, dx
    finally:
        dist.destroy_process_group()
    log(f"phase 13 modules at world size 1 (NCCL): {out}")
    return out


def run_parallel(dev):
    """Phase 13: slice 9 on the card. B1's fused mode at each of
    ``PAR_BATCHES`` (:func:`check_fused`), its row-window mode on
    ``WINDOW_RANKS`` in-process windows (:func:`check_windows`), then
    ``make_cloth_step(fuse_substeps=True)`` over ``PAR_MAIN_STEPS`` counted
    steps (one fused launch a step) and its steps/s, and the modules at
    world size 1 (:func:`run_parallel_modules`). Returns the record of
    ``{"parallel": ...}``."""
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    out = {"runtime_resources": gcc.kernel_resources(fused=True),
           "capacity": gcc.fused_capacity()}
    log(f"phase 13 runtime cloth_fused_kernel: {out}")
    state, cset = cloth_scene(GRID, GRID, dev)
    gc, p = cset.grid_cloths[0], state.particles
    out["fused"] = {nb: check_fused(dev, gc, p, nb) for nb in PAR_BATCHES}
    torch.cuda.empty_cache()
    out["windows"] = check_windows(dev, gc, p)
    fused = gcc.make_cloth_step(gc, p.inv_mass, gc.inv_cnt_dist,
                                gc.inv_cnt_bend, dt=0.005, substeps=5,
                                fuse_substeps=True)
    xv, run_s, counts, _ = _counted_run(lambda a: fused(*a), (p.x, p.v),
                                        PAR_MAIN_STEPS)
    log(f"phase 13 make_cloth_step(fuse_substeps=True): {PAR_MAIN_STEPS} "
        f"steps in {run_s!r} s, launch counts {counts}")
    assert counts == {k: PAR_MAIN_STEPS if k == "cloth_substep_fused"
                      else 0 for k in counts}, counts
    assert torch.isfinite(xv[0]).all()
    many = gcc.make_cloth_step(gc, p.inv_mass, gc.inv_cnt_dist,
                               gc.inv_cnt_bend, dt=0.005, substeps=5,
                               n_steps=20, fuse_substeps=True)
    rate = rate_windows(lambda: many(p.x, p.v), 20)
    out["main_path"] = {"steps": PAR_MAIN_STEPS, "launches": counts,
                        "steps_per_s": rate}
    log(f"phase 13 fused main path: {out['main_path']}")
    out["bench"] = {}
    for name, argv in (("default", ["--no-secondary"]),
                       ("batch4", ["--batch", "4", "--no-secondary"])):
        code, records = bench_torch.run(argv)
        for r in records:
            print(json.dumps(r), flush=True)
        assert code == 0 and records, (name, code)
        assert records[-1]["path"] == "cuda_fused", records
        assert all(math.isfinite(r["value"]) for r in records), records
        out["bench"][name] = records[-1]
    log(f"phase 13 bench_torch.py cloth: {out['bench']}")
    out["modules"] = run_parallel_modules(dev)
    return out


def check_tet_fused(dev, bar):
    """Phase 14a: B2's multi-substep mode on the bench bar against the
    per-iteration launches, bit for bit in x and v, at each of
    ``TET_FUSED_BATCHES`` rollouts (rollout r at rest, its free vertices
    moving at (0, −0.1 r, 0.05 r) m/s), ``TET_FUSED_ITERS`` iterations and
    ``TET_FUSED_DAMPING`` over ``TET_FUSED_BIT_STEPS`` steps; then at one
    iteration over 10 steps against the plain version (``CHECK_TOL``).
    Returns the record and the start states."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    state, cset = bar
    gt, p = cset.grid_tets[0], state.particles
    dims = (gt.width, gt.height, gt.depth)
    w = p.inv_mass.contiguous()
    ic = gt.inv_cnt.reshape(-1).contiguous()
    free = (p.inv_mass > 0)[:, None]
    starts = {}
    for nb in TET_FUSED_BATCHES:
        r = torch.arange(nb, device=dev, dtype=torch.float32)
        vel = torch.stack([torch.zeros_like(r), -0.1 * r, 0.05 * r], -1)
        v0 = torch.where(free, vel[:, None, :], 0.0)
        x0 = p.x.expand(nb, -1, -1).contiguous()
        starts[nb] = (x0[0], v0[0]) if nb == 1 else (x0, v0)
    bitwise, grids = {}, {}
    for nb in TET_FUSED_BATCHES:
        for iters in TET_FUSED_ITERS:
            for damping in TET_FUSED_DAMPING:
                params = gtc.kernel_params(gt, h=0.001, damping=damping)
                xf, vf = xs, vs = tuple(gtc.to_planes(a)
                                        for a in starts[nb])
                scratch = gtc.FusedScratch()
                before = launch_count("tet_substep_fused")
                for _ in range(TET_FUSED_BIT_STEPS):
                    xf, vf = gtc.tet_fused_cuda(xf, vf, w, ic, params, dims,
                                                iters, 5, scratch)
                launches = launch_count("tet_substep_fused") - before
                xs, vs, _, _ = gtc.run_substeps(
                    xs, vs, w, ic, params, dims, iters,
                    5 * TET_FUSED_BIT_STEPS)
                torch.cuda.synchronize()
                key = f"b{nb}_it{iters}_damping{damping}"
                bitwise[key] = bool(torch.equal(xf, xs)
                                    and torch.equal(vf, vs)
                                    and torch.isfinite(xf).all())
                grids[f"b{nb}"] = gtc.tet_fused_cuda.grid
                assert launches == TET_FUSED_BIT_STEPS, launches
    plain = {}
    params = gtc.kernel_params(gt, h=0.001)
    for nb in TET_FUSED_BATCHES:
        x, v = starts[nb]
        xf, vf = gtc.to_planes(x), gtc.to_planes(v)
        scratch = gtc.FusedScratch()
        xr, vr = x, v
        devs = []
        for _ in range(10):
            xf, vf = gtc.tet_fused_cuda(xf, vf, w, ic, params, dims, 1, 5,
                                        scratch)
            for _ in range(5):
                xr, vr = gtc.tet_substep_reference(gt, xr, vr, p.inv_mass,
                                                   h=0.001)
            lead = () if nb == 1 else (nb,)
            devs.append(max_dev(gtc.from_planes(xf, lead), xr))
        plain[f"b{nb}"] = devs
    torch.cuda.synchronize()
    out = {"bit_equal_per_iteration": bitwise, "grid": grids,
           "plain_max_abs_err_per_step": plain,
           "plain_max_abs_err": max(max(d) for d in plain.values())}
    log(f"phase 14 tet fused checks: {out}")
    assert all(bitwise.values()), bitwise
    assert out["plain_max_abs_err"] <= CHECK_TOL, plain
    return out, starts


def time_tet_fused(dev, bar, starts):
    """Phase 14b: a fused launch (one step, 5 passes) beside 5
    per-iteration launches in this call, at each of ``TET_FUSED_BATCHES``
    rollouts, with their bounds; the plain version of one fused launch at
    one rollout."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    state, cset = bar
    gt, p = cset.grid_tets[0], state.particles
    dims = (gt.width, gt.height, gt.depth)
    w = p.inv_mass.contiguous()
    ic = gt.inv_cnt.reshape(-1).contiguous()
    params = gtc.kernel_params(gt, h=0.001)
    out = {}
    for nb in TET_FUSED_BATCHES:
        x, v = starts[nb]
        buf = [gtc.to_planes(x), gtc.to_planes(v)]
        scratch = gtc.FusedScratch()

        def fused():
            buf[:] = gtc.tet_fused_cuda(buf[0], buf[1], w, ic, params, dims,
                                        1, 5, scratch)

        def per_iteration():
            buf[:] = gtc.tet_substep_cuda(buf[0], buf[1], w, ic, params,
                                          dims)

        n = TET_FUSED_TIMED[nb]
        # one instance at a time: the name matches both; a second profile
        # where the first recorded no device time for it
        for key, fn, count in (("ms", fused, n // 5),
                               ("substep_ms", per_iteration, n)):
            kms = (device_ms(fn, count, "tet_substep_kernel")
                   or device_ms(fn, count, "tet_substep_kernel"))
            out[f"{key}_b{nb}"] = (cuda_time_ms(fn, count) if kms is None
                                   else kms)
            out[f"{key}_source_b{nb}"] = ("cuda events" if kms is None
                                          else "profiler")
        out[f"interval_ms_b{nb}"] = cuda_time_ms(fused, n // 5)
        out[f"five_launches_ms_b{nb}"] = 5 * out[f"substep_ms_b{nb}"]
        b = tet_bound(dims, nb, substeps=5)
        out[f"bound_ms_b{nb}"], out[f"bound_by_b{nb}"] = b["ms"], b["by"]
        out[f"substep_bound_ms_b{nb}"] = tet_bound(dims, nb)["ms"]
    x, v = starts[1]

    def plain():
        xr, vr = x, v
        for _ in range(5):
            xr, vr = gtc.tet_substep_reference(gt, xr, vr, p.inv_mass,
                                               h=0.001)

    out["plain_ms"] = cuda_time_ms(plain, 3)
    log(f"phase 14 tet fused timing: {out}")
    return out


def run_tet_fused_main_path(dev, bar):
    """Phase 14c: ``make_tet_step`` (fused, its default) over
    ``STEPS_MAIN`` counted steps of the bench bar, one launch a step, and
    its steps/s."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    state, cset = bar
    gt, p = cset.grid_tets[0], state.particles
    step = gtc.make_tet_step(gt, p.inv_mass, dt=0.005, substeps=5)
    xv, run_s, counts, peak = _counted_run(lambda a: step(*a), (p.x, p.v),
                                           STEPS_MAIN)
    log(f"phase 14 make_tet_step (fused): {STEPS_MAIN} steps in {run_s!r} "
        f"s, launch counts {counts}, peak device memory {peak} B")
    n_pin = gt.height * gt.depth
    assert counts == {k: STEPS_MAIN if k == "tet_substep_fused" else 0
                      for k in counts}, counts
    assert torch.isfinite(xv[0]).all() and torch.isfinite(xv[1]).all()
    assert torch.equal(xv[0][:n_pin], p.x[:n_pin]), "pinned face moved"
    many = gtc.make_tet_step(gt, p.inv_mass, dt=0.005, substeps=5,
                             n_steps=20)
    rate = rate_windows(lambda: many(p.x, p.v), 20)
    out = {"steps": STEPS_MAIN, "launches": counts, "peak_bytes": peak,
           "steps_per_s": rate}
    log(f"phase 14 fused main path: {out}")
    return out


def run_bench_options():
    """Phase 14d: ``bench_torch.py``'s ``--bar`` fused and ``--no-fuse``,
    ``--max-iterations 2`` on the cloth and the bar, ``--no-pallas
    --timers --profile DIR`` on the cloth (the trace file written and not
    empty) and the default run with its secondary lines, in this process;
    each JSON line printed as it comes. Every secondary line but the
    absent contact scene's has a value."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as d:
        trace_dir = os.path.join(d, "trace")
        runs = (("bar", ["--bar"]), ("bar_no_fuse", ["--bar", "--no-fuse"]),
                ("cloth_it2", ["--max-iterations", "2", "--no-secondary"]),
                ("bar_it2", ["--bar", "--max-iterations", "2"]),
                ("cloth_no_pallas", ["--no-pallas", "--timers", "--profile",
                                     trace_dir, "--no-secondary",
                                     "--calls", "2", "--steps-per-call",
                                     "5"]),
                ("default", []))
        for name, argv in runs:
            t0 = time.perf_counter()
            code, records = bench_torch.run(argv)
            for r in records:
                print(json.dumps(r), flush=True)
            assert code == 0 and records, (name, code)
            out[name] = {"records": records,
                         "seconds": time.perf_counter() - t0}
            if name == "cloth_no_pallas":
                trace = os.path.join(trace_dir, bench_torch.TRACE_FILE)
                out[name]["trace_bytes"] = (os.path.getsize(trace)
                                            if os.path.exists(trace) else 0)
    paths = {n: r["records"][-1]["path"] for n, r in out.items()}
    log(f"phase 14 bench_torch.py paths: {paths}; seconds "
        f"{ {n: r['seconds'] for n, r in out.items()} }")
    assert paths == {"bar": "cuda_fused", "bar_no_fuse": "cuda_per_iteration",
                     "cloth_it2": "cuda_fused", "bar_it2": "cuda_fused",
                     "cloth_no_pallas": "torch_stencil",
                     "default": "cuda_fused"}, paths
    assert out["bar_it2"]["records"][0]["metric"].endswith("_it2")
    assert out["cloth_no_pallas"]["trace_bytes"] > 0
    default = out["default"]["records"]
    assert len(default) == 5, default
    for r in default[:3] + default[4:]:
        assert math.isfinite(r["value"]) and r["value"] > 0, r
    assert "ArmadilloCollisionScene.json" in default[3]["error"], default[3]
    for name, r in out.items():
        if name != "default":
            assert all(math.isfinite(x["value"]) for x in r["records"])
    return out


def run_tet_fused(dev):
    """Phase 14: B2's multi-substep mode on the card (:func:`check_tet_fused`,
    :func:`time_tet_fused`, :func:`run_tet_fused_main_path`) and
    ``bench_torch.py``'s remaining options (:func:`run_bench_options`).
    Returns the record of ``{"tet_fused": ...}``."""
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    bar = bar_scene(BAR, dev)
    out = {"runtime_resources": gtc.kernel_resources(fused=True)}
    log(f"phase 14 runtime tet_substep_kernel<1>: "
        f"{out['runtime_resources']}")
    out["checks"], starts = check_tet_fused(dev, bar)
    out["timing"] = time_tet_fused(dev, bar, starts)
    out["main_path"] = run_tet_fused_main_path(dev, bar)
    del bar, starts
    torch.cuda.empty_cache()
    out["bench"] = run_bench_options()
    return out


PHASE_S = {}


def timed(name, fn, *args):
    """``fn(*args)``, its seconds kept in ``PHASE_S[name]`` and logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"phase {name} took {PHASE_S[name]!r} s")
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

    libs = timed("2 build", _build.build_all)
    log(f"built {sorted(libs)}")
    ptxas, lines = ptxas_report(_build.build_logs)
    for line in lines:
        log(f"  ptxas {line}")
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
    cloth_resources = gcc.kernel_resources()
    for iters, r in cloth_resources.items():
        log(f"  runtime cloth_substep_kernel<{iters}>: {r}")
    log(f"  runtime cloth_fused_kernel: {gcc.kernel_resources(fused=True)}")
    wide_resources = {**gcc.wide_resources(),
                      "capacity": gcc.wide_capacity()}
    log(f"  runtime cloth_wide_kernel: {wide_resources}")
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc
    tet_resources = gtc.kernel_resources()
    log(f"  runtime tet_substep_kernel: {tet_resources}")
    resources = fcc.kernel_resources()
    for kname, r in resources.items():
        log(f"  runtime {kname}: {r}")

    err, x_plain10 = timed("3 cloth kernel vs plain",
                           check_kernel_against_plain, dev)
    bar = timed("3 bar build", bar_scene, BAR, dev)
    tet_err, bar_plain10, tet_record = timed(
        "3 tet kernel vs plain", check_tet_kernel_against_plain, dev, bar)
    tet_batch = timed("3 tet n_batch", check_tet_kernel_batched, dev, bar)
    launches, main_rate, busy = timed("4 cloth main path", run_main_path,
                                      dev, x_plain10)
    tet_main = timed("4 bar main path", run_tet_main_path, dev, bar_plain10)
    t = timed("5 cloth timing", time_cloth_kernel, dev)
    tt = timed("5 tet timing", time_tet_kernel, dev, bar)
    del bar
    fc = timed("6a fluid kernels vs plain", check_fluid_kernels_against_plain,
               dev)
    dam = timed("6b fluid main path", run_fluid_main_path, dev)
    ft = timed("6c fluid timing", time_fluid_kernels, dam["scene"],
               dam["state"])
    del dam["scene"], dam["state"]
    planner_check = timed("7a planner routes", check_planner_routes, dev)
    bar_planner_check = timed("7a bar planner routes",
                              check_bar_planner_routes, dev)
    mpc_big = timed("7b mpc-big", run_mpc_big, dev)
    bench_lines = timed("7c bench modes", run_bench_modes)
    unstructured = timed("8 unstructured", run_unstructured, dev)
    rigid = timed("9 rigid", run_rigid, dev)
    collision = timed("10 collision", run_collision, dev)
    rods = timed("11 rods", run_rods, dev)
    scenes = timed("12 scenes", run_scenes, dev)
    parallel = timed("13 parallel", run_parallel, dev)
    tet_fused = timed("14 tet fused and bench options", run_tet_fused, dev)

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
        "kernel_b1": t["kernel_b1"],
        "ms_b4": t["ms_b4"],
        "ms_source_b4": t["ms_source_b4"],
        "kernel_b4": t["kernel_b4"],
        "interval_ms_b4": t["interval_ms_b4"],
        "bound_ms_b4": t["bound_ms_b4"],
        "main_path_steps_per_s": main_rate,
        "main_path_device_busy": busy,
        "steps_per_s_b1": t["steps_per_s_b1"],
        "steps_per_s_b4": t["steps_per_s_b4"],
        "planner_launches": mpc_big["launches"]["cloth_substep"],
        "ms_b256": mpc_big["b1_ms"],
        "kernel_b256": b1_kernel(MPC_BIG[1], MPC_BIG[0], MPC_BIG[0]),
        "bound_ms_b256": mpc_big["bound_ms"],
        "planner_updates_per_s": mpc_big["updates_per_s"],
        "planner_aggregate_steps_per_s": mpc_big["aggregate_steps_per_s"],
        "planner_device_busy": mpc_big["device_busy"],
        "planner_copy_share": mpc_big["copy_share"],
        "planner_peak_bytes": mpc_big["peak_bytes"],
        "planner_route_check": planner_check,
        "bench_check": bench_lines["check"],
        "ptxas": {iters: ptxas.get(f"cloth_substep_kernel<{iters}>")
                  for iters in cloth_resources},
        "runtime_resources": cloth_resources,
        "wide_ptxas": ptxas.get("cloth_wide_kernel"),
        "wide_runtime_resources": wide_resources,
    }, {
        "name": "tet_substep",
        "route": "cuda",
        "source": "positionbaseddynamics_tpu_torch/csrc/grid_tet_step.cu",
        "replaces": "positionbaseddynamics_tpu/solver/grid_tet_pallas.py:99",
        "launches": tet_main["launches"],
        "max_abs_err": tet_err,
        "ms": tt["ms"],
        "plain_ms": tt["plain_ms"],
        "bound_ms": tt["bound_ms"],
        "bound_by": tt["bound_by"],
        "library_ms": None,
        "ms_source": tt["ms_source"],
        "interval_ms": tt["interval_ms"],
        "bound_bytes_ms": tt["bound_bytes_ms"],
        "bound_ops_ms": tt["bound_ops_ms"],
        "main_path_max_abs_err": tet_main["max_abs_err"],
        "main_path_steps_per_s": tet_main["steps_per_s"],
        "main_path_device_busy": tet_main["device_busy"],
        "main_path_device_us_per_step": tet_main["device_us_per_step"],
        "main_path_peak_bytes": tet_main["peak_bytes"],
        "ptxas": ptxas.get("tet_substep_kernel<0>"),
        "runtime_resources": tet_resources,
        "n_batch_check": tet_batch,
        "planner_route_check": bar_planner_check,
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
            "staging": ft["staging_xsph" if kname == "pbf_xsph"
                          else "staging"],
            "ptxas": ptxas.get(kname + "_kernel"),
            "runtime_resources": resources[kname],
        })
    fused, windows = parallel["fused"], parallel["windows"]
    kernels += [{
        "name": "cloth_substep_fused",
        "route": "cuda",
        "source": "positionbaseddynamics_tpu_torch/csrc/grid_cloth_step.cu",
        "replaces": "positionbaseddynamics_tpu/solver/grid_cloth_pallas.py:440",
        "launches": parallel["main_path"]["launches"]["cloth_substep_fused"],
        "max_abs_err": max(r["plain_max_abs_err"] for r in fused.values()),
        "ms": fused[1]["ms"],
        "plain_ms": fused[1]["plain_ms"],
        "bound_ms": fused[1]["bound_ms"],
        "bound_by": fused[1]["bound_by"],
        "library_ms": None,
        "ms_source": fused[1]["ms_source"],
        **{f"{k}_b{nb}": r[k] for nb, r in fused.items()
           for k in ("ms", "substep_ms", "substep_kernel",
                     "five_substeps_ms", "over_five_substeps",
                     "bound_ms", "bound_by", "substep_bound_ms",
                     "vs_per_substep_max_dx", "vs_per_substep_max_dv",
                     "bit_equal_per_substep", "bit_equal_cases", "grid",
                     "plain_max_abs_err")},
        "main_path_steps_per_s": parallel["main_path"]["steps_per_s"],
        "bench_steps_per_s": parallel["bench"]["default"]["value"],
        "bench_steps_per_s_b4": parallel["bench"]["batch4"]["value"],
        "capacity": parallel["capacity"],
        "ptxas": ptxas.get("cloth_fused_kernel"),
        "runtime_resources": parallel["runtime_resources"],
    }, {
        "name": "cloth_substep_window",
        "route": "cuda",
        "source": "positionbaseddynamics_tpu_torch/csrc/grid_cloth_step.cu",
        "replaces": "positionbaseddynamics_tpu/solver/grid_cloth_pallas.py:161",
        "launches": parallel["modules"]["intra_cuda"]["launches"][
            "cloth_substep_window"],
        "max_abs_err": windows["plain_max_abs_err"],
        "ms": windows["ms"],
        "plain_ms": windows["plain_ms"],
        "bound_ms": windows["bound_ms"],
        "bound_by": windows["bound_by"],
        "library_ms": None,
        "ms_source": windows["ms_source"],
        "stitched_vs_unsharded_max_dx":
            windows["stitched_vs_unsharded_max_dx"],
        "window_rows": windows["rows"] + 2 * windows["exchange_rows"],
        "grid": windows["grid"],
    }]
    tf, tft = tet_fused["checks"], tet_fused["timing"]
    kernels.append({
        "name": "tet_substep_fused",
        "route": "cuda",
        "source": "positionbaseddynamics_tpu_torch/csrc/grid_tet_step.cu",
        "replaces": "positionbaseddynamics_tpu/solver/grid_tet_pallas.py:164",
        "launches": tet_fused["main_path"]["launches"]["tet_substep_fused"],
        "max_abs_err": tf["plain_max_abs_err"],
        "ms": tft["ms_b1"],
        "plain_ms": tft["plain_ms"],
        "bound_ms": tft["bound_ms_b1"],
        "bound_by": tft["bound_by_b1"],
        "library_ms": None,
        "ms_source": tft["ms_source_b1"],
        **{k: v for k, v in tft.items()
           if k not in ("ms_b1", "plain_ms", "bound_ms_b1", "bound_by_b1",
                        "ms_source_b1")},
        "bit_equal_per_iteration": tf["bit_equal_per_iteration"],
        "grid": tf["grid"],
        "main_path_steps_per_s": tet_fused["main_path"]["steps_per_s"],
        "ptxas": ptxas.get("tet_substep_kernel<1>"),
        "runtime_resources": tet_fused["runtime_resources"],
    })
    assert dam["sync_error"] is None, dam["sync_error"]
    print(json.dumps({"unstructured": unstructured}))
    print(json.dumps({"rigid": rigid}))
    print(json.dumps({"collision": collision}))
    print(json.dumps({"rods": rods}))
    print(json.dumps({"scenes": scenes}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"tet_fused": {k: v for k, v in tet_fused.items()
                                    if k != "bench"}}))
    print(json.dumps({"phase_s": PHASE_S}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
