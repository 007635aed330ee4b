#!/usr/bin/env python3
"""StretchBendingTwistingDemo: a stiff rod of rigid segments joined by
iterative 6D-XPBD stretch-bending-twisting joints
(``Demos/StiffRodsDemos/StretchBendingTwistingDemo.cpp``;
kernel ``PositionBasedElasticRods.cpp:1228-1363``)."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--youngs", type=float, default=1e6)


def build(args, device):
    radius, seg_len = 0.1, 0.5
    mass = 1000.0 * np.pi * radius**2 * seg_len
    ix = 0.5 * mass * radius**2
    iyz = mass * (3 * radius**2 + seg_len**2) / 12.0

    b = SceneBuilder()
    for i in range(args.segments):
        b.add_rigid_body(x=((i + 0.5) * seg_len, 0.0, 0.0),
                         mass=(0.0 if i == 0 else mass),
                         inertia=(ix, iyz, iyz))
    for i in range(args.segments - 1):
        b.add_stretch_bending_twisting_constraint(
            i, i + 1, pos=((i + 1) * seg_len, 0.0, 0.0),
            average_radius=radius, average_segment_length=seg_len,
            youngs_modulus=args.youngs, torsion_modulus=args.youngs)
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig(max_iterations=5))


def report(demo, final):
    x = host(final.rigid.x)
    p("tip", np.round(x[-1], 3))


def main(argv=None):
    return run(__doc__, build, report, add_args=add_args, argv=argv)


if __name__ == "__main__":
    main()
