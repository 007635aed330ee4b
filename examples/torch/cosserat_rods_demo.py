#!/usr/bin/env python3
"""CosseratRodsDemo: a helix of rod segments with stretch-shear +
bend-twist constraints (``Demos/CosseratRodsDemo/main.cpp:225-273``,
helix of 50 segments)."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--segments", type=int, default=50)


def build(args, device):
    n = args.segments + 1
    t = np.linspace(0.0, 4.0 * np.pi, n)
    pts = np.stack([0.3 * np.cos(t), -0.1 * t, 0.3 * np.sin(t)], 1)

    b = SceneBuilder()
    lm = b.add_line_model(pts)
    b.set_mass(lm.offset, 0.0)                 # pin helix top
    b.set_quaternion_mass(lm.offset_q, 0.0)
    b.add_rod_constraints(lm, stretch_stiffness=(1.0, 1.0, 1.0),
                          bend_twist_stiffness=(0.5, 0.5, 0.5))
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig(damping=0.001))


def report(demo, final):
    x = host(final.particles.x)
    seg = np.linalg.norm(np.diff(x, axis=0), axis=1)
    p("tip y", round(float(x[-1, 1]), 4))
    p("max segment stretch", round(float(seg.max() / seg.min()), 3))


def main(argv=None):
    return run(__doc__, build, report, steps=300, add_args=add_args,
               argv=argv)


if __name__ == "__main__":
    main()
