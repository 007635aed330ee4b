"""Collision scenes shared by the port's collision tests
(``test_torch_collision.py``, ``test_torch_solid_contact.py``,
``test_torch_collision_step.py``, ``test_torch_mpc.py``,
``test_torch_builders.py``). Each builder takes the package name,
``"jax"`` or ``"torch"``, and returns ``(state, cset, pipeline)`` built by
that package's ``SceneBuilder`` from the same arguments (the port's on the
CPU). The scenes are the JAX package's collision examples and tests at
small sizes: ``examples/rigid_body_collision_demo.py``'s spheres on a box
floor, ``cloth_collision_demo.py``'s cloth over a sphere (laid flat so
that it lands on it), ``deformable_collision_demo.py``'s two bars, and
``bench.py --pile-big``'s sphere pile."""
import dataclasses
import importlib

import numpy as np

#: the cloth over the sphere lies in the x–z plane: (x, y, 0) → (x, 0, y)
FLAT = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def mods(pkg):
    """``(SceneBuilder, collision package)`` of ``"jax"`` or ``"torch"``."""
    root = ("positionbaseddynamics_tpu" if pkg == "jax"
            else "positionbaseddynamics_tpu_torch")
    return (importlib.import_module(root + ".models").SceneBuilder,
            importlib.import_module(root + ".collision"))


def _kw(pkg):
    return {} if pkg == "jax" else {"device": "cpu"}


def _done(pkg, b, **pipe_kw):
    state, cset = b.build(**_kw(pkg))
    return state, cset, b.build_collision_pipeline(**pipe_kw, **_kw(pkg))


def spheres_on_box(pkg, n=3, restitution=0.4, height=0.8, verts=64,
                   broad_phase="unrolled", pair_capacity=None):
    """``rigid_body_collision_demo.py`` with ``n`` spheres of radius 0.3:
    a static box floor (top at y 0), spheres with ``verts`` surface
    samples starting at ``height`` + 0.5 i."""
    builder, col = mods(pkg)
    b = builder()
    floor = b.add_rigid_body((0.0, -0.5, 0.0), mass=0.0)
    b.add_collision_box(floor, (10.0, 0.5, 10.0))
    r = 0.3
    sv = col.sampling.sample_sphere(r, verts)
    for i in range(n):
        body = b.add_rigid_body((0.7 * i - 0.7, height + 0.5 * i, 0.1 * i),
                                mass=1.0, inertia=(0.4 * r * r,) * 3)
        b.add_collision_sphere(body, r, restitution=restitution,
                               friction=0.2, verts=sv)
    return _done(pkg, b, tolerance=0.02, broad_phase=broad_phase,
                 pair_capacity=pair_capacity)


def cloth_on_sphere(pkg, n=12, broad_phase="unrolled", height=0.75):
    """``cloth_collision_demo.py`` at ``n``×``n``, laid flat at
    ``height`` over the static sphere of radius 0.6 at the origin."""
    builder, _ = mods(pkg)
    b = builder()
    tm = b.add_regular_triangle_model(n, n, translation=(-1.0, height, -1.0),
                                      rotation=FLAT, scale=(2.0, 2.0))
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    sph = b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    b.add_collision_sphere(sph, 0.6, restitution=0.0, friction=0.2,
                           verts=np.zeros((1, 3), np.float32))
    b.set_particle_collider(tm, restitution=0.0, friction=0.2)
    return _done(pkg, b, tolerance=0.02, broad_phase=broad_phase)


def pile(pkg, n=12, broad_phase="batched", pair_capacity=None):
    """``bench.py --pile-big``'s scene at ``n`` bodies on a 4×4 grid in
    layers: spheres of radius 0.25 with 32 samples on a (6, 1, 6) box
    floor, tolerance 0.02."""
    builder, col = mods(pkg)
    rng = np.random.default_rng(0)
    b = builder()
    floor = b.add_rigid_body((0.0, -0.5, 0.0), mass=0.0)
    b.add_collision_box(floor, (6.0, 1.0, 6.0))
    r = 0.25
    sv = col.sampling.sample_sphere(r, 32)
    for i in range(n):
        gx, gz = i % 4, (i // 4) % 4
        body = b.add_rigid_body(
            (0.55 * gx - 0.8 + 0.02 * rng.standard_normal(),
             0.8 + 0.45 * (i // 16),
             0.55 * gz - 0.8 + 0.02 * rng.standard_normal()),
            mass=1.0, inertia=(0.4 * r * r,) * 3)
        b.add_collision_sphere(body, r, restitution=0.1, friction=0.3,
                               verts=sv)
    return _done(pkg, b, tolerance=0.02, broad_phase=broad_phase,
                 pair_capacity=pair_capacity)


def big_pile(pkg, n=100):
    """``bench.py --pile-big`` at its default: 100 spheres on a 10×10 grid
    (``bench.py:180-227``)."""
    builder, col = mods(pkg)
    rng = np.random.default_rng(0)
    b = builder()
    floor = b.add_rigid_body((0.0, -0.5, 0.0), mass=0.0)
    b.add_collision_box(floor, (6.0, 1.0, 6.0))
    r = 0.25
    sv = col.sampling.sample_sphere(r, 32)
    for i in range(n):
        gx, gz = i % 10, (i // 10) % 10
        body = b.add_rigid_body(
            (0.55 * gx - 2.5 + 0.02 * rng.standard_normal(),
             0.8 + 0.55 * (i // 100),
             0.55 * gz - 2.5 + 0.02 * rng.standard_normal()),
            mass=1.0, inertia=(0.4 * r * r,) * 3)
        b.add_collision_sphere(body, r, restitution=0.1, friction=0.3,
                               verts=sv)
    return _done(pkg, b, tolerance=0.02, broad_phase="batched")


def two_bars(pkg, dims=(6, 2, 2), top_dims=None, top_y=0.45):
    """``deformable_collision_demo.py``: a dynamic FEM bar dropped on a
    static one, each a particle collider and a tet collider; ``top_dims``
    and ``top_y`` (the demo's 0.45) change the top bar."""
    builder, _ = mods(pkg)
    b = builder()
    bottom = b.add_regular_tet_model(*dims, translation=(0.0, 0.0, 0.0),
                                     scale=(1.2, 0.25, 0.4))
    for i in range(bottom.mesh.n_vertices):
        b.set_mass(bottom.offset + i, 0.0)
    top = b.add_regular_tet_model(*(top_dims or dims),
                                  translation=(0.05, top_y, 0.0),
                                  scale=(1.0, 0.25, 0.3))
    b.add_solid_constraints(top, method=3, stiffness=1e5)
    for h in (bottom, top):
        b.set_particle_collider(h, restitution=0.0, friction=0.2)
        b.set_tet_collider(h, restitution=0.0, friction=0.2,
                           sdf_resolution=20, grid_resolution=16)
    return _done(pkg, b)


def cube_mesh(half=0.3):
    """A closed cube of 8 vertices and 12 outward-wound triangles."""
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def mesh_body_on_box(pkg, resolution=12):
    """A box body built from its mesh (``add_rigid_body_from_mesh``, offset
    and turned so its principal frame differs from the mesh frame) with a
    baked grid SDF of that mesh, dropped on a box floor: the collider
    carries the mesh frame."""
    builder, col = mods(pkg)
    b = builder()
    floor = b.add_rigid_body((0.0, -0.5, 0.0), mass=0.0)
    b.add_collision_box(floor, (4.0, 0.5, 4.0))
    v, f = cube_mesh()
    v = v * np.array([1.0, 0.6, 1.4]) + np.array([0.05, 0.02, -0.03])
    q = np.array([np.cos(0.2), np.sin(0.2), 0.0, 0.0])
    body = b.add_rigid_body_from_mesh(v, f, density=2.0,
                                      translation=(0.0, 0.35, 0.0), q=q)
    values, origin, extent = col.bake_mesh_sdf(v, f, resolution=resolution)
    b.add_collision_sdf(body, values, origin, extent, restitution=0.2,
                        friction=0.3)
    return _done(pkg, b, tolerance=0.02)


def flatten(obj):
    """A JAX dataclass pytree as nested dicts of numpy arrays (the input
    of ``convert.collision_pipeline_from_numpy``)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: flatten(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [flatten(o) for o in obj]
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return np.asarray(obj)
    return obj


def rigid_from_jax(ts, js):
    """The port's state ``ts`` with the rigid bodies of JAX's ``js``."""
    import torch

    r = dataclasses.replace(ts.rigid, **{
        f.name: torch.tensor(np.asarray(getattr(js.rigid, f.name)))
        for f in dataclasses.fields(ts.rigid)})
    return dataclasses.replace(ts, rigid=r)


def particles_from_jax(ts, js):
    """The port's state ``ts`` with the particles of JAX's ``js``."""
    import torch

    p = dataclasses.replace(ts.particles, **{
        f.name: torch.tensor(np.asarray(getattr(js.particles, f.name)))
        for f in dataclasses.fields(ts.particles)})
    return dataclasses.replace(ts, particles=p)


def from_jax(ts, js):
    """The port's state with JAX's particles, bodies and time."""
    import torch

    out = particles_from_jax(ts, js)
    if ts.rigid is not None:
        out = rigid_from_jax(out, js)
    return dataclasses.replace(out, time=torch.tensor(np.asarray(js.time)))
