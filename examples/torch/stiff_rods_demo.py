#!/usr/bin/env python3
"""DirectPositionBasedSolverForStiffRodsDemo: stiff-rod chains and a
branched Y-tree solved EXACTLY each iteration by the direct solver
(Deul 2018; ``PositionBasedElasticRods.cpp:735-1226``) — block-Thomas
scans for chains, a dense tree solve for branches."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--tree", action="store_true",
                    help="run the Y-branched tree instead of the chain")


def build(args, device):
    radius, seg_len, youngs = 0.1, 0.5, 1e6
    mass = 1000.0 * np.pi * radius**2 * seg_len
    ix = 0.5 * mass * radius**2
    iyz = mass * (3 * radius**2 + seg_len**2) / 12.0

    b = SceneBuilder()
    if args.tree:
        centers = [(0.25, 0, 0), (0.75, 0, 0), (1.25, 0.08, 0),
                   (1.25, -0.08, 0)]
        bodies = [b.add_rigid_body(x=c, mass=(0.0 if i == 0 else mass),
                                   inertia=(ix, iyz, iyz))
                  for i, c in enumerate(centers)]
        b.add_direct_rod_tree(
            bodies, [(0, 1), (1, 2), (1, 3)],
            [(0.5, 0, 0), (1.0, 0, 0), (1.0, 0, 0)],
            radius, seg_len, youngs, youngs)
    else:
        bodies = [b.add_rigid_body(
            x=((i + 0.5) * seg_len, 0.0, 0.0),
            mass=(0.0 if i == 0 else mass), inertia=(ix, iyz, iyz))
            for i in range(args.segments)]
        pos = [((i + 1) * seg_len, 0.0, 0.0)
               for i in range(args.segments - 1)]
        b.add_direct_rod_chain(bodies, np.asarray(pos), radius, seg_len,
                               youngs, youngs)
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig(),
                info={"tree": args.tree, "segments": args.segments})


def report(demo, final):
    tree = demo.info["tree"]
    x = host(final.rigid.x)
    p("topology", "Y-tree" if tree else f"{demo.info['segments']}-chain")
    p("tip(s)", np.round(x[-2 if tree else -1:], 3))


def main(argv=None):
    return run(__doc__, build, report, add_args=add_args, argv=argv)


if __name__ == "__main__":
    main()
