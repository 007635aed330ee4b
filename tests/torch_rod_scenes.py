"""Rod scenes shared by the port's slice-7 tests (``test_torch_rods.py``,
``test_torch_rod_step.py``, ``test_torch_direct_rods.py``,
``test_torch_generic.py``, ``test_torch_builders.py``,
``test_torch_mpc.py``). Each builder takes the package name, ``"jax"`` or
``"torch"``, and the ``build`` keywords, and returns ``(state, cset)``
built by that package's ``SceneBuilder`` from the same arguments: the
JAX package's rod examples and tests at small sizes
(``examples/cosserat_rods_demo.py``, ``elastic_rods_demo.py``,
``stiff_rods_demo.py``, ``generic_particle_demo.py``,
``generic_rigidbody_demo.py``; ``tests/test_grid_rods.py``,
``test_stiff_rods.py``, ``test_generic_constraints.py``). The generic
constraint functions are written twice, in JAX and in torch.
:func:`from_jax` carries a JAX scene across through
``convert.scene_from_numpy``."""
import dataclasses
import importlib

import numpy as np


def builder(pkg):
    root = ("positionbaseddynamics_tpu" if pkg == "jax"
            else "positionbaseddynamics_tpu_torch")
    return importlib.import_module(root + ".models").SceneBuilder


def _build(pkg, b, kw):
    return b.build(**({} if pkg == "jax" else dict({"device": "cpu"}, **kw)))


def helix(pkg, segments=12, **kw):
    """``cosserat_rods_demo.py``: a helix of ``segments`` rod segments, its
    top particle and frame pinned."""
    n = segments + 1
    t = np.linspace(0.0, 4.0 * np.pi, n)
    pts = np.stack([0.3 * np.cos(t), -0.1 * t, 0.3 * np.sin(t)], 1)
    b = builder(pkg)()
    lm = b.add_line_model(pts)
    b.set_mass(lm.offset, 0.0)
    b.set_quaternion_mass(lm.offset_q, 0.0)
    b.add_rod_constraints(lm, stretch_stiffness=(1.0, 1.0, 1.0),
                          bend_twist_stiffness=(0.5, 0.5, 0.5))
    return _build(pkg, b, kw)


def rods(pkg, n_rods=4, n=12, structured=True, spacing=0.1, **kw):
    """``bench.py --rods`` / ``tests/test_grid_rods.py``: ``n_rods``
    straight rods of ``n`` points along x, each root particle and frame
    pinned; the rod lattice when ``structured``."""
    b = builder(pkg)(use_structured_grid=structured)
    for r in range(n_rods):
        pts = np.stack([np.linspace(0.0, 1.0, n),
                        np.full(n, spacing * r), np.zeros(n)], 1)
        lm = b.add_line_model(pts)
        b.set_mass(lm.offset, 0.0)
        b.set_quaternion_mass(lm.offset_q, 0.0)
        b.add_rod_constraints(lm, stretch_stiffness=(1.0, 1.0, 1.0),
                              bend_twist_stiffness=(0.5, 0.5, 0.5))
    return _build(pkg, b, kw)


def ghost_rod(pkg, n=10, **kw):
    """``elastic_rods_demo.py``: the ghost-point rod of ``n`` points at
    0.25 spacing, the first two points and the first ghost pinned."""
    pts = np.stack([0.25 * np.arange(n), np.zeros(n), np.zeros(n)], 1)
    b = builder(pkg)()
    h = b.add_ghost_rod_model(pts)
    b.set_mass(h.offset, 0.0)
    b.set_mass(h.offset + 1, 0.0)
    b.set_mass(h.ghost_offset, 0.0)
    b.add_ghost_rod_constraints(h, stretching_stiffness=1.0,
                                bending_twisting=(0.5, 0.5, 0.5))
    return _build(pkg, b, kw)


def _segment(radius=0.1, seg_len=0.5, density=1000.0):
    mass = density * np.pi * radius**2 * seg_len
    ix = 0.5 * mass * radius**2
    iyz = mass * (3 * radius**2 + seg_len**2) / 12.0
    return mass, (ix, iyz, iyz)


def stiff_chain(pkg, segments=6, youngs=1e6, **kw):
    """``stiff_rods_demo.py``: a chain of ``segments`` rigid segments (the
    first static) for the direct solver."""
    radius, seg_len = 0.1, 0.5
    mass, inertia = _segment(radius, seg_len)
    b = builder(pkg)()
    bodies = [b.add_rigid_body(x=((i + 0.5) * seg_len, 0.0, 0.0),
                               mass=(0.0 if i == 0 else mass),
                               inertia=inertia) for i in range(segments)]
    pos = [((i + 1) * seg_len, 0.0, 0.0) for i in range(segments - 1)]
    b.add_direct_rod_chain(bodies, np.asarray(pos), radius, seg_len,
                           youngs, youngs)
    return _build(pkg, b, kw)


def y_tree(pkg, youngs=1e6, **kw):
    """``stiff_rods_demo.py --tree``: the Y of two trunk segments (the
    first static) and two branches."""
    radius, seg_len = 0.1, 0.5
    mass, inertia = _segment(radius, seg_len)
    centers = [(0.25, 0, 0), (0.75, 0, 0), (1.25, 0.08, 0),
               (1.25, -0.08, 0)]
    b = builder(pkg)()
    bodies = [b.add_rigid_body(x=c, mass=(0.0 if i == 0 else mass),
                               inertia=inertia)
              for i, c in enumerate(centers)]
    b.add_direct_rod_tree(bodies, [(0, 1), (1, 2), (1, 3)],
                          [(0.5, 0, 0), (1.0, 0, 0), (1.0, 0, 0)],
                          radius, seg_len, youngs, youngs)
    return _build(pkg, b, kw)


def tree_geometry(n_seg, seed=0, seg_len=0.3, radius=0.05):
    """``bench.py --tree``'s random tree (``bench.py:336-393``): segment i
    hangs from a random earlier one, in a random direction, from
    ``default_rng(seed)``. Returns ``(centers, masses, inertia, edges,
    positions, radius, seg_len)``."""
    rng = np.random.default_rng(seed)
    mass, inertia = _segment(radius, seg_len)
    centers = [np.zeros(3)]
    edges, positions = [], []
    for i in range(1, n_seg):
        parent = int(rng.integers(0, i))
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        joint = centers[parent] + 0.5 * seg_len * d
        centers.append(joint + 0.5 * seg_len * d)
        edges.append((parent, i))
        positions.append(tuple(joint))
    masses = [0.0] + [mass] * (n_seg - 1)
    return centers, masses, inertia, edges, positions, radius, seg_len


def random_tree(pkg, n_seg=31, seed=3, solver=None, **kw):
    """A random stiff-rod tree of ``n_seg`` segments (``bench.py
    --tree``'s construction), its solver forced when ``solver`` is
    given."""
    centers, masses, inertia, edges, positions, radius, seg_len = \
        tree_geometry(n_seg, seed)
    b = builder(pkg)()
    bodies = [b.add_rigid_body(tuple(c), mass=m, inertia=inertia)
              for c, m in zip(centers, masses)]
    b.add_direct_rod_tree(bodies, edges, positions, radius, seg_len, 1e6,
                          1e6)
    state, cset = _build(pkg, b, kw)
    if solver is not None:
        db = cset.direct_rods[0]
        cset = dataclasses.replace(cset, direct_rods=(
            dataclasses.replace(db, solver=solver),))
    return state, cset


def distance_fn(pkg):
    """The generic distance ``|p1 − p0| − rest`` of
    ``generic_particle_demo.py``, as ``fn(pts, params)``."""
    if pkg == "jax":
        import jax.numpy as jnp

        return lambda pts, prm: jnp.array(
            [jnp.linalg.norm(pts[1] - pts[0]) - prm[0]])
    import torch

    return lambda pts, prm: (torch.linalg.vector_norm(pts[1] - pts[0])
                             - prm[0]).reshape(1)


def bend_fn(pkg):
    """``test_generic_isometric_bending_runs``' 4-point bend, as
    ``fn(pts)``."""
    if pkg == "jax":
        import jax.numpy as jnp

        def f(pts):
            e = pts[3] - pts[2]
            m = 0.5 * (pts[2] + pts[3])
            return jnp.array([jnp.dot(pts[0] - m, pts[1] - m)
                              / jnp.maximum(jnp.dot(e, e), 1e-9)])
        return f
    import torch

    def g(pts):
        e = pts[3] - pts[2]
        m = 0.5 * (pts[2] + pts[3])
        return (torch.dot(pts[0] - m, pts[1] - m)
                / torch.clamp_min(torch.dot(e, e), 1e-9)).reshape(1)
    return g


def ball_fn(pkg):
    """``generic_rigidbody_demo.py``'s ball joint: body 0's local (1, 0,
    0) and body 1's local (−1, 0, 0) meet, as ``fn(x, q)``."""
    if pkg == "jax":
        import jax.numpy as jnp

        from positionbaseddynamics_tpu.ops import quaternion as quat

        def f(x, q):
            c0 = quat.rotate(q[0], jnp.array([1.0, 0.0, 0.0])) + x[0]
            c1 = quat.rotate(q[1], jnp.array([-1.0, 0.0, 0.0])) + x[1]
            return c0 - c1
        return f
    import torch

    from positionbaseddynamics_tpu_torch.ops import quaternion as quat

    def g(x, q):
        e = torch.zeros_like(x[0])
        e0 = torch.cat([e[:1] + 1.0, e[1:]])
        c0 = quat.rotate(q[0], e0) + x[0]
        c1 = quat.rotate(q[1], -e0) + x[1]
        return c0 - c1
    return g


def generic_cloth(pkg, generic=True, n=8, bend=False, **kw):
    """``test_generic_constraints.py``'s cloth: an n×n cloth, two corners
    pinned, held by generic distance constraints (``generic``) or by the
    classic distance batch; ``bend`` adds the generic 4-point bend."""
    b = builder(pkg)(use_structured_grid=False)
    tm = b.add_regular_triangle_model(n, n)
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + n - 1, 0.0)
    edges = tm.mesh.edges + tm.offset
    if generic:
        x0 = np.concatenate(b._x)
        rests = np.linalg.norm(x0[edges[:, 0]] - x0[edges[:, 1]],
                               axis=-1)[:, None]
        b.add_generic_constraints(distance_fn(pkg), edges, stiffness=1.0,
                                  params=rests)
    else:
        b.add_cloth_constraints(tm, method=1, distance_stiffness=1.0)
    if bend:
        b.add_generic_constraints(bend_fn(pkg),
                                  tm.mesh.bending_stencils() + tm.offset,
                                  stiffness=0.05)
    return _build(pkg, b, kw)


def pendulum(pkg, **kw):
    """``generic_rigidbody_demo.py``: a static body and a body of mass 1
    joined by the generic ball joint."""
    b = builder(pkg)()
    b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    b.add_rigid_body((2.0, 0.0, 0.0), mass=1.0, inertia=(0.4, 0.4, 0.4))
    b.add_generic_rigid_constraints(ball_fn(pkg), [[0, 1]])
    return _build(pkg, b, kw)


def _arrays(batch, skip=()):
    """A JAX batch's array fields (not None) and its static fields."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if f.name in skip:
            continue
        if f.metadata.get("static"):
            statics[f.name] = v
        elif v is not None:
            arrays[f.name] = np.asarray(v)
    return arrays, statics


def from_jax(js, jc, generic_fns=(), rigid_fns=()):
    """The port's ``(state, cset)`` on the CPU from JAX's, through
    ``convert.scene_from_numpy``: particles, orientations and bodies, the
    particle batches (the generic ones with ``generic_fns``, torch
    functions in their order), the rod batches and lattices, the stiff
    rods and the generic rigid batches (with ``rigid_fns``). Grid cloths,
    tet grids and joints are left out (their own tests carry them)."""
    from positionbaseddynamics_tpu_torch import convert

    p = js.particles
    state = {f.name: np.asarray(getattr(p, f.name))
             for f in dataclasses.fields(p)}
    state["time"] = np.asarray(js.time)
    pb = {}
    for name, b in jc.particle_batches():
        arrays, statics = _arrays(b)
        if name.startswith("generic"):
            statics["fn"] = generic_fns[int(name[len("generic"):])]
        pb[name] = (type(b).__name__, arrays, statics)
    rod_b = {name: (type(getattr(jc, name)).__name__,
                    *_arrays(getattr(jc, name)))
             for name in ("stretch_shear", "bend_twist")
             if getattr(jc, name) is not None}
    direct = []
    for db in jc.direct_rods:
        arrays, statics = _arrays(db, skip=("schedule",))
        if getattr(db, "schedule", None) is not None:
            arrays["schedule"] = {k: np.asarray(v)
                                  for k, v in db.schedule.items()}
        direct.append((type(db).__name__, arrays, statics))
    rgen = []
    for gb, fn in zip(jc.rigid_generics, rigid_fns):
        arrays, statics = _arrays(gb)
        statics["fn"] = fn
        rgen.append((arrays, statics))
    o = js.orientations
    return convert.scene_from_numpy(
        state, (), (), device="cpu", particle_batches=pb,
        rigid=None if js.rigid is None else {
            f.name: np.asarray(getattr(js.rigid, f.name))
            for f in dataclasses.fields(js.rigid)},
        orientations=None if o is None else {
            f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o)},
        rods=rod_b, rod_lattices=[_arrays(rl) for rl in jc.rod_lattices],
        direct_rods=direct, rigid_generics=rgen)
