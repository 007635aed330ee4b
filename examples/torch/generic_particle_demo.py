#!/usr/bin/env python3
"""GenericParticleConstraintsDemo: a cloth held together purely by
user-defined constraint FUNCTIONS — Jacobians by forward-mode autodiff
(``torch.func.jacfwd``) where the reference uses finite differences
(``Demos/GenericConstraintsDemos/GenericParticleConstraintsDemo.cpp``;
``PositionBasedGenericConstraints.h:31-121``). The constraint is written
in torch, the JAX demo's function term for term."""
import numpy as np
import torch

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def add_args(ap):
    ap.add_argument("--n", type=int, default=12)


def distance_c(pts, params):
    return (torch.linalg.vector_norm(pts[1] - pts[0])
            - params[0]).reshape(1)


def build(args, device):
    b = SceneBuilder(use_structured_grid=False)
    tm = b.add_regular_triangle_model(args.n, args.n)
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + args.n - 1, 0.0)
    edges = tm.mesh.edges + tm.offset
    x0 = np.concatenate(b._x)
    rests = np.linalg.norm(x0[edges[:, 0]] - x0[edges[:, 1]],
                           axis=-1)[:, None]
    b.add_generic_constraints(distance_c, edges, stiffness=1.0,
                              params=rests)
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig())


def report(demo, final):
    x = host(final.particles.x)
    p("free corner y", round(float(x[-1, 1]), 4))


def main(argv=None):
    return run(__doc__, build, report, add_args=add_args, argv=argv)


if __name__ == "__main__":
    main()
