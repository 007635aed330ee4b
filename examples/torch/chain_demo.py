#!/usr/bin/env python3
"""ChainDemo: a hanging chain of rigid bodies linked by ball joints
swinging under gravity (``Demos/RigidBodyDemos/ChainDemo.cpp``)."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--links", type=int, default=8)


def build(args, device):
    b = SceneBuilder()
    prev = b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)   # static anchor
    for i in range(args.links):
        body = b.add_rigid_body((1.0 + i, 0.0, 0.0), mass=1.0,
                                inertia=(0.1, 0.2, 0.3))
        b.add_ball_joint(prev, body, (0.5 + i, 0.0, 0.0))
        prev = body
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig(max_iterations=5))


def report(demo, final):
    x = host(final.rigid.x)
    gaps = np.linalg.norm(np.diff(x, axis=0), axis=1)
    p("link spacing", f"{gaps.min():.3f}..{gaps.max():.3f} (rest 1.0)")
    p("chain tip", np.round(x[-1], 3))


def main(argv=None):
    return run(__doc__, build, report, steps=300, add_args=add_args,
               argv=argv)


if __name__ == "__main__":
    main()
