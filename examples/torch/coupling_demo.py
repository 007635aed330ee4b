#!/usr/bin/env python3
"""RigidBodyClothCouplingDemo: cloth corners attached to a swinging
rigid chain with RigidBodyParticleBallJoints
(``Demos/CouplingDemos/RigidBodyClothCouplingDemo.cpp``)."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--n", type=int, default=12)


def build(args, device):
    b = SceneBuilder()
    # short rigid chain hanging from a static anchor
    anchor = b.add_rigid_body((0.0, 2.0, 0.0), mass=0.0)
    link = b.add_rigid_body((0.8, 2.0, 0.0), mass=1.0,
                            inertia=(0.1, 0.15, 0.2))
    b.add_ball_joint(anchor, link, (0.4, 2.0, 0.0))

    # cloth whose first-row corners pin to the chain tip
    tm = b.add_regular_triangle_model(args.n, args.n,
                                      translation=(1.2, 2.0, -0.5),
                                      scale=(1.0, 1.0))
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    b.add_rigid_body_particle_ball_joint(link, tm.offset)
    b.add_rigid_body_particle_ball_joint(link, tm.offset + args.n - 1)
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig(max_iterations=5),
                info={"cloth": tm})


def report(demo, final):
    x = host(final.particles.x)
    rx = host(final.rigid.x)
    p("chain link", np.round(rx[1], 3))
    p("attached cloth corner", np.round(x[demo.info["cloth"].offset], 3))
    p("free cloth corner y", round(float(x[-1, 1]), 3))


def main(argv=None):
    return run(__doc__, build, report, steps=250, add_args=add_args,
               argv=argv)


if __name__ == "__main__":
    main()
