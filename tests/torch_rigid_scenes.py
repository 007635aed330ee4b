"""Rigid scenes and joint cases shared by the port's rigid-body tests
(``test_torch_rigid_ops.py``, ``test_torch_joints.py``,
``test_torch_rigid_step.py``). Each builder takes a ``SceneBuilder`` class,
the JAX package's or the port's, and the ``build`` keywords, so both
packages build one scene from the same arguments."""
import numpy as np

#: Every joint kind and the builder arguments of its random case.
KINDS = ("ball", "ball_on_line", "hinge", "universal", "slider",
         "target_position_motor_slider", "target_velocity_motor_slider",
         "target_angle_motor_hinge", "target_velocity_motor_hinge",
         "distance", "damper", "rb_particle_ball",
         "stretch_bending_twisting")
VELOCITY_KINDS = ("target_velocity_motor_slider",
                  "target_velocity_motor_hinge")

#: Body pairs of a case: a static body 0 and 5, a joint between two static
#: bodies, and bodies shared between joints.
PAIRS = np.array([(0, 1), (1, 2), (3, 2), (4, 5), (0, 5)], np.int32)
MASSES = np.array([0.0, 1.0, 2.0, 1.5, 0.7, 0.0])


def unit(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def small_turn(rng, q, angle):
    """``q`` turned by ``angle`` about random axes, float64."""
    axis = rng.normal(size=(len(q), 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    dq = np.concatenate([np.full((len(q), 1), np.cos(angle / 2)),
                         np.sin(angle / 2) * axis], axis=1)
    w0, x0, y0, z0 = dq.T
    w1, x1, y1, z1 = q.T
    out = np.stack([w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
                    w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                    w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
                    w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1], axis=1)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def joint_case(kind, seed=0):
    """The build inputs of one random case of ``kind``: ``(bodies,
    conflict, x, q, kwargs)`` for ``make_joint_batch``, float64; for
    ``rb_particle_ball`` column 1 indexes 4 particles."""
    rng = np.random.default_rng(seed)
    r = len(MASSES)
    x = np.stack([np.arange(r) * 0.7, 0.1 * np.arange(r),
                  -0.05 * np.arange(r)], axis=1) + 0.05 * rng.normal(
                      size=(r, 3))
    q = unit(rng, r)
    bodies = PAIRS.copy()
    c = len(bodies)
    kw = {}
    if kind == "rb_particle_ball":
        bodies = np.array([(1, 0), (2, 1), (3, 2), (0, 3), (5, 0)],
                          np.int32)
        kw["particle_x"] = x[[2, 3, 4, 1]] + 0.3
    x0, x1 = x[bodies[:, 0]], x[bodies[:, 1]]
    mid = 0.5 * (x0 + x1) + 0.05 * rng.normal(size=(c, 3))
    if kind in ("ball", "ball_on_line", "hinge", "universal",
                "target_angle_motor_hinge", "target_velocity_motor_hinge",
                "stretch_bending_twisting", "distance"):
        kw["positions"] = mid
    if kind in ("ball_on_line", "hinge", "universal", "slider",
                "target_position_motor_slider",
                "target_velocity_motor_slider", "target_angle_motor_hinge",
                "target_velocity_motor_hinge", "damper"):
        kw["directions"] = rng.normal(size=(c, 3))
    if kind == "universal":
        kw["directions1"] = rng.normal(size=(c, 3))
    if kind == "distance":
        kw["positions1"] = x1 + 0.1 * rng.normal(size=(c, 3))
        kw["stiffness"] = np.array([0.0, 50.0, 0.0, 200.0, 0.0])
    if kind == "damper":
        kw["stiffness"] = np.array([10.0, 0.0, 300.0, 5.0, 1.0])
    if kind == "stretch_bending_twisting":
        kw["rest"] = np.full((c,), 0.5)
        kw["directions"] = np.tile([0.1, 1e6, 8e5], (c, 1))
    if kind.startswith("target_"):
        kw["target"] = rng.uniform(-1.0, 1.0, c)
    conflict = bodies.astype(np.int64).copy()
    return bodies, conflict, x, q, kw


def perturbed(x, q, rng, dx=0.03, angle=0.08):
    """A state near the build state: positions moved by ~``dx``,
    rotations turned by ``angle``; float32."""
    return ((x + dx * rng.normal(size=x.shape)).astype(np.float32),
            small_turn(rng, q, angle).astype(np.float32))


def chain(builder, links=8, **kw):
    """``examples/chain_demo.py`` at its default: a static anchor and
    ``links`` bodies of mass 1, inertia (0.1, 0.2, 0.3), ball joints at the
    midpoints."""
    b = builder()
    prev = b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    for i in range(links):
        body = b.add_rigid_body((1.0 + i, 0.0, 0.0), mass=1.0,
                                inertia=(0.1, 0.2, 0.3))
        b.add_ball_joint(prev, body, (0.5 + i, 0.0, 0.0))
        prev = body
    return b.build(**kw)


JOINT_DEMO_NAMES = ("ball", "ball_on_line", "hinge", "universal", "slider",
                    "target_angle_motor_hinge", "target_velocity_motor_hinge",
                    "target_position_motor_slider",
                    "target_velocity_motor_slider")


def joint_demo(builder, only=None, **kw):
    """``examples/joint_demo.py``: nine static-base/dynamic-body pairs, one
    joint kind each, the four motors with their target sequences; body
    ``2i + 1`` is pair i's dynamic body. ``only`` (a name of
    ``JOINT_DEMO_NAMES``) builds that pair alone, at its place."""
    b = builder()

    def pair(y):
        s = b.add_rigid_body((0.0, y, 0.0), mass=0.0)
        d = b.add_rigid_body((1.0, y, 0.0), mass=1.0,
                             inertia=(0.1, 0.15, 0.2))
        return s, d

    adders = (
        lambda s, d: b.add_ball_joint(s, d, (0.5, 0.0, 0.0)),
        lambda s, d: b.add_ball_on_line_joint(s, d, (0.5, 2.0, 0.0),
                                              (1.0, 0.0, 0.0)),
        lambda s, d: b.add_hinge_joint(s, d, (0.5, 4.0, 0.0),
                                       (0.0, 0.0, 1.0)),
        lambda s, d: b.add_universal_joint(s, d, (0.5, 6.0, 0.0),
                                           (0.0, 0.0, 1.0),
                                           (0.0, 1.0, 0.0)),
        lambda s, d: b.add_slider_joint(s, d, (1.0, 0.0, 0.0)),
        lambda s, d: b.add_target_angle_motor_hinge_joint(
            s, d, (0.5, 10.0, 0.0), (0.0, 0.0, 1.0),
            sequence=[0.0, 0.0, 1.0, 0.8, 2.0, 0.0], repeat=True),
        lambda s, d: b.add_target_velocity_motor_hinge_joint(
            s, d, (0.5, 12.0, 0.0), (0.0, 0.0, 1.0), target=1.5),
        lambda s, d: b.add_target_position_motor_slider_joint(
            s, d, (1.0, 0.0, 0.0), sequence=[0.0, 0.0, 1.0, 0.5, 2.0, 0.0],
            repeat=True),
        lambda s, d: b.add_target_velocity_motor_slider_joint(
            s, d, (1.0, 0.0, 0.0), target=0.4),
    )
    for i, (name, add) in enumerate(zip(JOINT_DEMO_NAMES, adders)):
        if only is None or name == only:
            add(*pair(2.0 * i))
    return b.build(**kw)


def sbt(builder, segments=10, youngs=1e6, **kw):
    """``examples/sbt_demo.py``: a rod of ``segments`` rigid segments (the
    first static) joined by stretch-bending-twisting constraints."""
    radius, seg_len = 0.1, 0.5
    mass = 1000.0 * np.pi * radius**2 * seg_len
    ix = 0.5 * mass * radius**2
    iyz = mass * (3 * radius**2 + seg_len**2) / 12.0
    b = builder()
    for i in range(segments):
        b.add_rigid_body(x=((i + 0.5) * seg_len, 0.0, 0.0),
                         mass=(0.0 if i == 0 else mass),
                         inertia=(ix, iyz, iyz))
    for i in range(segments - 1):
        b.add_stretch_bending_twisting_constraint(
            i, i + 1, pos=((i + 1) * seg_len, 0.0, 0.0),
            average_radius=radius, average_segment_length=seg_len,
            youngs_modulus=youngs, torsion_modulus=youngs)
    return b.build(**kw)


def coupling(builder, n=12, **kw):
    """``examples/coupling_demo.py``: a rigid link ball-jointed to a static
    anchor, and an n×n grid cloth whose first-row corners hang from the
    link by ``rb_particle_ball`` joints."""
    b = builder()
    anchor = b.add_rigid_body((0.0, 2.0, 0.0), mass=0.0)
    link = b.add_rigid_body((0.8, 2.0, 0.0), mass=1.0,
                            inertia=(0.1, 0.15, 0.2))
    b.add_ball_joint(anchor, link, (0.4, 2.0, 0.0))
    tm = b.add_regular_triangle_model(n, n, translation=(1.2, 2.0, -0.5),
                                      scale=(1.0, 1.0))
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    b.add_rigid_body_particle_ball_joint(link, tm.offset)
    b.add_rigid_body_particle_ball_joint(link, tm.offset + n - 1)
    return b.build(**kw)


def springs(builder, **kw):
    """The three kinds no example uses: a damper to a static base, a rigid
    distance joint and an XPBD spring, on spinning and moving bodies."""
    b = builder()
    s = b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    d1 = b.add_rigid_body((1.0, 0.0, 0.0), mass=1.0,
                          inertia=(0.1, 0.15, 0.2), omega=(0.3, 0.2, 0.1))
    d2 = b.add_rigid_body((1.0, -1.0, 0.0), mass=2.0,
                          inertia=(0.2, 0.1, 0.3))
    d3 = b.add_rigid_body((2.0, 0.5, 0.3), mass=1.5,
                          inertia=(0.2, 0.2, 0.1), velocity=(0.1, 0.0, 0.2))
    b.add_damper_joint(s, d1, (1.0, 0.2, 0.0), stiffness=50.0)
    b.add_rigid_distance_joint(d1, d2, (1.1, -0.1, 0.0), (1.0, -0.9, 0.05))
    b.add_rigid_body_spring(d1, d3, (1.2, 0.1, 0.0), (1.9, 0.4, 0.3),
                            stiffness=200.0)
    return b.build(**kw)


def free_body(builder, **kw):
    """JAX's ``test_rigid_free_fall_and_spin`` body: mass 2, inertia (0.2,
    0.3, 0.4), spinning at 3 rad/s about z, no joint."""
    b = builder()
    b.add_rigid_body((0.0, 0.0, 0.0), mass=2.0, inertia=(0.2, 0.3, 0.4),
                     omega=(0.0, 0.0, 3.0))
    return b.build(**kw)
