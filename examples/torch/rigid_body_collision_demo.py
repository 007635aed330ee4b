#!/usr/bin/env python3
"""RigidBodyCollisionDemo: dynamic rigid spheres dropped onto a static
box floor — analytic-SDF collision with restitution and friction
(``Demos/DistanceFieldDemos/RigidBodyCollisionDemo.cpp``)."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.collision import sampling
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--bodies", type=int, default=5)


def build(args, device):
    b = SceneBuilder()
    floor = b.add_rigid_body((0.0, -0.5, 0.0), mass=0.0)
    b.add_collision_box(floor, (10.0, 1.0, 10.0))
    r = 0.3
    verts = sampling.sample_sphere(r, 64)
    for i in range(args.bodies):
        body = b.add_rigid_body((0.7 * i - 1.4, 2.0 + 0.5 * i, 0.0),
                                mass=1.0, inertia=(0.4 * r * r,) * 3)
        b.add_collision_sphere(body, r, restitution=0.4, friction=0.2,
                               verts=verts)
    state, cset = b.build(device=device)
    pipe = b.build_collision_pipeline(tolerance=0.02, device=device)
    return Demo(state, cset, StepConfig(), pipe)


def report(demo, final):
    x = host(final.rigid.x)
    p("sphere heights (resting ~= 0.3+floor top)",
      np.round(x[1:, 1], 3))


def main(argv=None):
    return run(__doc__, build, report, steps=300, add_args=add_args,
               argv=argv)


if __name__ == "__main__":
    main()
