#!/usr/bin/env python3
"""JointDemo: the rigid-joint zoo — ball, ball-on-line, hinge,
universal, slider, plus all four motor joints with target sequences
(``Demos/RigidBodyDemos/JointDemo.cpp``). Each pair is independent
(static base + dynamic body)."""
import numpy as np

from _common import Demo, host, p, run
from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def build(args, device):
    b = SceneBuilder()
    names = []

    def pair(y):
        s = b.add_rigid_body((0.0, y, 0.0), mass=0.0)
        d = b.add_rigid_body((1.0, y, 0.0), mass=1.0,
                             inertia=(0.1, 0.15, 0.2))
        return s, d

    s, d = pair(0.0)
    b.add_ball_joint(s, d, (0.5, 0.0, 0.0)); names.append("ball")
    s, d = pair(2.0)
    b.add_ball_on_line_joint(s, d, (0.5, 2.0, 0.0), (1.0, 0.0, 0.0))
    names.append("ball_on_line")
    s, d = pair(4.0)
    b.add_hinge_joint(s, d, (0.5, 4.0, 0.0), (0.0, 0.0, 1.0))
    names.append("hinge")
    s, d = pair(6.0)
    b.add_universal_joint(s, d, (0.5, 6.0, 0.0), (0.0, 0.0, 1.0),
                          (0.0, 1.0, 0.0)); names.append("universal")
    s, d = pair(8.0)
    b.add_slider_joint(s, d, (1.0, 0.0, 0.0)); names.append("slider")
    s, d = pair(10.0)
    b.add_target_angle_motor_hinge_joint(
        s, d, (0.5, 10.0, 0.0), (0.0, 0.0, 1.0),
        sequence=[0.0, 0.0, 1.0, 0.8, 2.0, 0.0], repeat=True)
    names.append("angle_motor_hinge (sequence)")
    s, d = pair(12.0)
    b.add_target_velocity_motor_hinge_joint(
        s, d, (0.5, 12.0, 0.0), (0.0, 0.0, 1.0), target=1.5)
    names.append("velocity_motor_hinge")
    s, d = pair(14.0)
    b.add_target_position_motor_slider_joint(
        s, d, (1.0, 0.0, 0.0), sequence=[0.0, 0.0, 1.0, 0.5, 2.0, 0.0],
        repeat=True)
    names.append("position_motor_slider (sequence)")
    s, d = pair(16.0)
    b.add_target_velocity_motor_slider_joint(s, d, (1.0, 0.0, 0.0),
                                             target=0.4)
    names.append("velocity_motor_slider")

    state, cset = b.build(device=device)
    return Demo(state, cset, StepConfig(max_iterations=5),
                info={"names": names})


def announce(demo):
    p("joints", ", ".join(demo.info["names"]))


def report(demo, final):
    x = host(final.rigid.x)
    for i, n in enumerate(demo.info["names"]):
        p(n, np.round(x[2 * i + 1], 3))


def main(argv=None):
    return run(__doc__, build, report, steps=300, announce=announce,
               argv=argv)


if __name__ == "__main__":
    main()
