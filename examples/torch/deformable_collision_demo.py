#!/usr/bin/env python3
"""DeformableCollisionDemo: a dynamic XPBD-FEM tet bar dropped onto a
static tet bar — solid–solid (particle–tet) contact
(``Demos/DistanceFieldDemos/DeformableCollisionDemo.cpp``;
``DistanceFieldCollisionDetection.cpp:361-470``)."""
from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def build(args, device):
    b = SceneBuilder()
    bottom = b.add_regular_tet_model(6, 2, 2, translation=(0.0, 0.0, 0.0),
                                     scale=(1.2, 0.25, 0.4))
    for i in range(bottom.mesh.n_vertices):
        b.set_mass(bottom.offset + i, 0.0)
    top = b.add_regular_tet_model(6, 2, 2,
                                  translation=(0.05, 0.45, 0.0),
                                  scale=(1.0, 0.25, 0.3))
    b.add_solid_constraints(top, method=3, stiffness=1e5)
    b.set_particle_collider(bottom, restitution=0.0, friction=0.2)
    b.set_particle_collider(top, restitution=0.0, friction=0.2)
    b.set_tet_collider(bottom, restitution=0.0, friction=0.2,
                       sdf_resolution=20, grid_resolution=16)
    b.set_tet_collider(top, restitution=0.0, friction=0.2,
                       sdf_resolution=20, grid_resolution=16)
    state, cset = b.build(device=device)
    pipe = b.build_collision_pipeline(device=device)
    return Demo(state, cset, StepConfig(), pipe,
                info={"top": slice(top.offset,
                                   top.offset + top.mesh.n_vertices)})


def report(demo, final):
    top_x = host(final.particles.x[demo.info["top"]])
    p("top bar rests above the bottom bar at y",
      round(float(top_x[:, 1].min()), 3))


def main(argv=None):
    return run(__doc__, build, report, steps=150, argv=argv)


if __name__ == "__main__":
    main()
