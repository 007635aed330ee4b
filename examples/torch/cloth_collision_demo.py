#!/usr/bin/env python3
"""ClothCollisionDemo: cloth dropped onto a static collision sphere
(``Demos/DistanceFieldDemos/ClothCollisionDemo.cpp``) — particle-rigid
contacts against an analytic SDF."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--n", type=int, default=20)


def build(args, device):
    b = SceneBuilder()
    tm = b.add_regular_triangle_model(args.n, args.n,
                                      translation=(-1.0, 1.0, -1.0),
                                      scale=(2.0, 2.0))
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    sph = b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    b.add_collision_sphere(sph, 0.6, restitution=0.0, friction=0.2,
                           verts=np.zeros((1, 3), np.float32))
    b.set_particle_collider(tm, restitution=0.0, friction=0.2)
    state, cset = b.build(device=device)
    pipe = b.build_collision_pipeline(tolerance=0.02, device=device)
    return Demo(state, cset, StepConfig(), pipe)


def report(demo, final):
    x = host(final.particles.x)
    p("min |x| (cloth outside the r=0.6 sphere)",
      round(float(np.linalg.norm(x, axis=-1).min()), 3))
    p("max height (draped over the top)", round(float(x[:, 1].max()), 3))


def main(argv=None):
    return run(__doc__, build, report, steps=250, add_args=add_args,
               argv=argv)


if __name__ == "__main__":
    main()
