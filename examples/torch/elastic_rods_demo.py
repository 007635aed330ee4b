#!/usr/bin/env python3
"""PositionBasedElasticRodsDemo: ghost-point elastic rod (Umetani 2014)
with perpendicular-bisector, ghost-edge-distance and Darboux-vector
constraints (``Demos/PositionBasedElasticRodsDemo``; rod of points at
0.25 spacing, first two points + first ghost pinned)."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--points", type=int, default=10)


def build(args, device):
    n = args.points
    pts = np.stack([0.25 * np.arange(n), np.zeros(n), np.zeros(n)], 1)
    b = SceneBuilder()
    h = b.add_ghost_rod_model(pts)
    b.set_mass(h.offset, 0.0)
    b.set_mass(h.offset + 1, 0.0)
    b.set_mass(h.ghost_offset, 0.0)
    b.add_ghost_rod_constraints(h, stretching_stiffness=1.0,
                                bending_twisting=(0.5, 0.5, 0.5))
    state, cset = b.build(device=device)
    # the demo's custom stepper damps velocities
    return Demo(state, cset, StepConfig(damping=0.001), info={"rod": h})


def report(demo, final):
    h = demo.info["rod"]
    rod = host(final.particles.x[h.offset:h.offset + h.n_points])
    p("tip y", round(float(rod[-1, 1]), 4))
    seg = np.linalg.norm(np.diff(rod, axis=0), axis=1)
    p("segment lengths", f"{seg.min():.3f}..{seg.max():.3f} (rest 0.25)")


def main(argv=None):
    return run(__doc__, build, report, steps=300, add_args=add_args,
               argv=argv)


if __name__ == "__main__":
    main()
