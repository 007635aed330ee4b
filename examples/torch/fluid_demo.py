#!/usr/bin/env python3
"""FluidDemo: Position-Based Fluids breaking dam — density constraint
solve with Akinci boundary particles, XSPH viscosity and CFL-clamped
time steps (``Demos/FluidDemo``; ``TimeStepFluidModel.cpp:21-68``). The
bounded domain takes the cell-dense pipeline, whose density, correction
and XSPH passes run as CUDA kernels on the card
(``fluids/cellgrid_cuda.py``)."""
import sys
import time

import numpy as np

from _common import Demo, demo_args, device_of, host, p, sync
from positionbaseddynamics_tpu_torch.fluids import (
    FluidScene, FluidState, block_positions, box_boundary,
    make_fluid_step_fn)


def add_args(ap):
    ap.add_argument("--dims", type=int, nargs=3, default=(8, 14, 8),
                    help="fluid block particle counts")


def build(args, device):
    r = 0.025
    diam = 2 * r
    fluid = block_positions((diam, diam, diam), tuple(args.dims), diam)
    boundary = box_boundary((-diam, 0.0, -diam), (0.6, 0.7, 0.6), diam)
    # bounded domain engages the cell-dense engine (fluids/cellgrid.py)
    scene = FluidScene.create(len(fluid), boundary, particle_radius=r,
                              viscosity=0.02, cap_per_cell=16,
                              domain=((-diam, 0.0, -diam),
                                      (0.6, 0.7, 0.6)), device=device)
    state = FluidState.create(fluid, device=device)
    return Demo(state, scene, None,
                info={"fluid": len(fluid), "boundary": len(boundary)})


def main(argv=None):
    ap = demo_args(__doc__, steps=200)
    add_args(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    demo = build(args, dev)
    p("fluid particles", demo.info["fluid"])
    p("boundary particles", demo.info["boundary"])

    fn = make_fluid_step_fn(demo.cset, device=dev)
    state = fn(demo.state)                        # warm-up
    sync(dev)
    t0 = time.perf_counter()
    frames = []
    for i in range(args.steps):
        state = fn(state)
        if args.export_npz and i % 8 == 0:
            frames.append(host(state.x))
    sync(dev)
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.2f}s -> {args.steps / dt:.1f} steps/s")

    x = host(state.x)
    if not np.isfinite(x).all():
        print("finite: False")
        sys.exit(1)
    p("fluid height after collapse", round(float(x[:, 1].max()), 3))
    p("spread x", f"{x[:, 0].min():.3f}..{x[:, 0].max():.3f}")
    if args.export_npz:
        np.savez(args.export_npz, particles=np.stack(frames))
        p("trajectory saved to", args.export_npz)
    return 0


if __name__ == "__main__":
    main()
