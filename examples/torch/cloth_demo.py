#!/usr/bin/env python3
"""ClothDemo: regular grid cloth with two pinned corners
(``Demos/ClothDemo/main.cpp``). Cloth methods 1=distance, 2=FEM
triangle, 3=strain triangle, 4=XPBD distance; bending methods
1=dihedral, 2=isometric, 3=XPBD isometric
(``SimulationModel.cpp:1125-1240``). At its default (30×30, method 4,
bending 3) the step runs through the fused cloth kernel on the card."""
from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--method", type=int, default=4, choices=(1, 2, 3, 4))
    ap.add_argument("--bending", type=int, default=3, choices=(1, 2, 3))


def build(args, device):
    b = SceneBuilder()
    tm = b.add_regular_triangle_model(args.n, args.n, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)                     # pin two corners
    b.set_mass(tm.offset + args.n - 1, 0.0)
    stiff = 1e5 if args.method == 4 else 1.0
    b.add_cloth_constraints(tm, method=args.method,
                            distance_stiffness=stiff)
    b.add_bending_constraints(tm, method=args.bending, stiffness=0.05)
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig())


def report(demo, final):
    x = host(final.particles.x)
    p("pinned corner", x[0])
    p("free corner fell to y", round(float(x[-1, 1]), 4))


def main(argv=None):
    return run(__doc__, build, report, add_args=add_args, argv=argv)


if __name__ == "__main__":
    main()
