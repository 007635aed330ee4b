#!/usr/bin/env python3
"""GenericRigidBodyConstraintsDemo: a rigid pendulum whose ball joint
is expressed only as a constraint FUNCTION of body states (quaternion
Jacobians by autodiff;
``Demos/GenericConstraintsDemos/GenericRigidBodyConstraintsDemo.cpp``;
``PositionBasedGenericConstraints.h:218``). The constraint is written in
torch, the JAX demo's function term for term."""
import numpy as np
import torch

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.ops import quaternion as quat
from positionbaseddynamics_tpu_torch.solver import StepConfig
from positionbaseddynamics_tpu_torch.utils import npquat


def ball_c(x, q):
    # the unit x axis made from x itself: a constant tensor would be
    # copied to the card inside the step
    e = torch.zeros_like(x[0])
    e0 = torch.cat([e[:1] + 1.0, e[1:]])
    return (quat.rotate(q[0], e0) + x[0]) - (quat.rotate(q[1], -e0) + x[1])


def build(args, device):
    b = SceneBuilder()
    b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    b.add_rigid_body((2.0, 0.0, 0.0), mass=1.0, inertia=(0.4, 0.4, 0.4))
    b.add_generic_rigid_constraints(ball_c, [[0, 1]])
    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig())


def report(demo, final):
    x = host(final.rigid.x)
    q = host(final.rigid.q)
    c1 = npquat.rotate(q[1], np.array([-1.0, 0.0, 0.0])) + x[1]
    p("pendulum body", np.round(x[1], 3))
    p("connector drift from anchor",
      round(float(np.linalg.norm(c1 - [1, 0, 0])), 4))


def main(argv=None):
    return run(__doc__, build, report, argv=argv)


if __name__ == "__main__":
    main()
