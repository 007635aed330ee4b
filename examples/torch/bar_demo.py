#!/usr/bin/env python3
"""BarDemo: regular tet-bar cantilever, all 6 solid methods
(``Demos/BarDemo/main.cpp``): 1=distance+volume, 2=FEM, 3=XPBD FEM,
4=strain, 5=shape matching, 6=XPBD distance+volume. Method 3 on a
regular grid runs on the structured tet path, through the fused tet
kernel on the card (``solver/grid_tet_cuda.py``)."""
from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--dims", type=int, nargs=3, default=(12, 4, 4))
    ap.add_argument("--method", type=int, default=3,
                    choices=(1, 2, 3, 4, 5, 6))


def build(args, device):
    w, h, d = args.dims
    b = SceneBuilder()
    tm = b.add_regular_tet_model(w, h, d, scale=(2.0, 0.5, 0.5))
    for j in range(h):                      # pin the i=0 face
        for k in range(d):
            b.set_mass(tm.offset + j * d + k, 0.0)
    # stiffness presets per method as in the demo (~main.cpp:130-150)
    stiff = {1: 1.0, 2: 1.0, 3: 1e5, 4: 1.0, 5: 1.0, 6: 1e5}[args.method]
    b.add_solid_constraints(tm, method=args.method, stiffness=stiff,
                            poisson_ratio=0.3, volume_stiffness=stiff)
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig())


def announce(demo):
    p("structured tet path", bool(demo.cset.grid_tets))


def report(demo, final):
    x = host(final.particles.x)
    pin = host(demo.state.particles.inv_mass) == 0
    p("free-end mean y", round(float(x[~pin, 1].mean()), 4))


def main(argv=None):
    return run(__doc__, build, report, add_args=add_args,
               announce=announce, argv=argv)


if __name__ == "__main__":
    main()
