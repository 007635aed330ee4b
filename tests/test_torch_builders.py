"""The port's scene builder against the JAX package's: a 33×29 cloth
built by both gives equal arrays (atol 1e-7: both compute the build in
float64 numpy and round once to float32), the cloth branches that take
the particle batches build the same batches, every rigid adder builds the
same rigid state and joint batches exactly, and an unknown method raises
NotImplementedError."""
import numpy as np
import pytest

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.models.mesh import TriangleMesh as JMesh
from positionbaseddynamics_tpu.solver import grid_cloth as jgc
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.models.mesh import TriangleMesh as TMesh
from positionbaseddynamics_tpu_torch.solver import grid_cloth as tgc

ATOL = 1e-7
W, H = 33, 29


def _scene(builder, **build_kw):
    b = builder()
    tm = b.add_regular_triangle_model(W, H, translation=(0.1, 0.2, -0.3),
                                      scale=(2.0, 1.5))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + W - 1, 0.0)
    b.set_mass(tm.offset + 7, 2.5)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(**build_kw)


def _np(a):
    return np.asarray(a.cpu().numpy() if hasattr(a, "cpu") else a)


def test_cloth_build_matches_jax():
    js, jc = _scene(JBuilder)
    ts, tc = _scene(TBuilder, device="cpu")
    for f in ("x", "v", "old_x", "last_x", "x0", "inv_mass"):
        np.testing.assert_allclose(_np(getattr(ts.particles, f)),
                                   _np(getattr(js.particles, f)), atol=ATOL)
    assert float(ts.time) == float(js.time) == 0.0
    assert len(tc.grid_cloths) == len(jc.grid_cloths) == 1
    assert tc.n_particles == W * H
    g, gj = tc.grid_cloths[0], jc.grid_cloths[0]
    for f in ("height", "width", "offset", "xpbd_distance", "xpbd_bending",
              "has_distance", "has_bending"):
        assert getattr(g, f) == getattr(gj, f), f
    for f in ("rest", "stiff", "q_mat", "bend_stiff"):
        td, jd = getattr(g, f), getattr(gj, f)
        assert list(td) == list(jd), f
        for fam in jd:
            assert tuple(td[fam].shape) == tuple(np.shape(jd[fam])), (f, fam)
            np.testing.assert_allclose(_np(td[fam]), _np(jd[fam]), atol=ATOL)
    for f in ("inv_cnt_dist", "inv_cnt_bend"):
        np.testing.assert_allclose(_np(getattr(g, f)), _np(getattr(gj, f)),
                                   atol=ATOL)


def test_state_fields_are_distinct_tensors():
    ts, _ = _scene(TBuilder, device="cpu")
    p = ts.particles
    ptrs = {getattr(p, f).data_ptr()
            for f in ("x", "v", "old_x", "last_x", "x0")}
    assert len(ptrs) == 5


def test_mesh_and_stencil_tables_match_jax():
    from positionbaseddynamics_tpu.models.builders import (
        regular_triangle_grid as jgrid)
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_triangle_grid as tgrid)

    pj, fj = jgrid(W, H, scale=(2.0, 1.5))
    pt, ft = tgrid(W, H, scale=(2.0, 1.5))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ft, fj)
    mj, mt = JMesh(len(pj), fj), TMesh(len(pt), ft)
    np.testing.assert_array_equal(mt.edges, mj.edges)
    np.testing.assert_array_equal(mt.edge_faces, mj.edge_faces)
    np.testing.assert_array_equal(mt.bending_stencils(),
                                  mj.bending_stencils())
    for k, (a, b) in jgc._grid_edges_np(H, W).items():
        ta, tb = tgc._grid_edges_np(H, W)[k]
        np.testing.assert_array_equal(ta, a)
        np.testing.assert_array_equal(tb, b)
    for k, sten in jgc._bend_stencils_np(H, W).items():
        for a, b in zip(tgc._bend_stencils_np(H, W)[k], sten):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call", [
    lambda b, tm: b.add_cloth_constraints(tm, method=7),
], ids=["unknown_method"])
def test_unported_branches_raise(call):
    b = TBuilder()
    tm = b.add_regular_triangle_model(5, 4)
    with pytest.raises(NotImplementedError):
        call(b, tm)


def assert_builds_equal(t_built, j_built):
    """The two packages' ``(state, set)`` of one scene: equal particle
    fields, the same particle batches in the same order with equal fields
    (exactly: both compute them in numpy and round once to float32), and
    equal Jacobi counts."""
    import dataclasses

    (ts, tc), (js, jc) = t_built, j_built
    for f in ("x", "v", "old_x", "last_x", "x0", "inv_mass"):
        np.testing.assert_array_equal(_np(getattr(ts.particles, f)),
                                      _np(getattr(js.particles, f)))
    assert tc.n_particles == js.particles.x.shape[0]
    names = [n for n, _ in jc.particle_batches()]
    assert [n for n, _ in tc.particle_batches()] == names
    for (name, tb), (_, jb) in zip(tc.particle_batches(),
                                   jc.particle_batches()):
        assert type(tb).__name__ == type(jb).__name__, name
        for f in dataclasses.fields(jb):
            jv, tv = getattr(jb, f.name), getattr(tb, f.name)
            if f.metadata.get("static"):
                assert tv == jv, (name, f.name)
            else:
                np.testing.assert_array_equal(_np(tv), _np(jv),
                                              err_msg=f"{name}.{f.name}")
    assert sorted(tc.jacobi_inv_counts) == sorted(jc.jacobi_inv_counts)
    for key, v in jc.jacobi_inv_counts.items():
        np.testing.assert_array_equal(_np(tc.jacobi_inv_counts[key]),
                                      _np(v), err_msg=key)
    return names


def _cloth_branch(builder, call, structured=True, **build_kw):
    b = builder(use_structured_grid=structured)
    tm = b.add_regular_triangle_model(5, 4, scale=(1.0, 0.8))
    b.set_mass(tm.offset, 0.0)
    call(b, tm)
    return b.build(**build_kw)


@pytest.mark.parametrize("call,family", [
    (lambda b, tm: b.add_cloth_constraints(tm, method=2, xx_stiffness=0.9,
                                           xy_poisson=0.2), "fem_triangle"),
    (lambda b, tm: b.add_cloth_constraints(tm, method=3,
                                           normalize_shear=True),
     "strain_triangle"),
    (lambda b, tm: b.add_bending_constraints(tm, method=1, stiffness=0.3),
     "dihedral"),
], ids=["fem_triangle", "strain_triangle", "dihedral"])
def test_cloth_branches_build_batches_as_jax(call, family):
    """The cloth branches that only the batches serve (cloth methods 2
    and 3, dihedral bending) build the same batch as JAX's builder, also
    on a structured builder's regular grid."""
    names = assert_builds_equal(_cloth_branch(TBuilder, call, device="cpu"),
                                _cloth_branch(JBuilder, call))
    assert names == [family]


@pytest.mark.parametrize("method", ["cloth", "bending"])
def test_unstructured_grid_builds_batches_as_jax(method):
    """``use_structured_grid=False`` puts a regular grid's distance and
    isometric bending in the batches, as JAX's builder does."""
    def call(b, tm):
        if method == "cloth":
            b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
        else:
            b.add_bending_constraints(tm, method=3, stiffness=0.05)

    t = _cloth_branch(TBuilder, call, structured=False, device="cpu")
    names = assert_builds_equal(t, _cloth_branch(JBuilder, call,
                                                 structured=False))
    assert not t[1].grid_cloths
    assert names == ["distance" if method == "cloth"
                     else "isometric_bending"]


def test_build_without_cuda_and_device_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = TBuilder()
    b.add_regular_triangle_model(4, 4)
    with pytest.raises(RuntimeError):
        b.build()


def test_every_jax_builder_method_exists_and_the_unported_raise():
    """The port's builder has each public method of JAX's, and none of
    them raises for want of a slice: the slice-7 adders, the last that
    did, now build (``test_slice7_adders_build_as_jax``)."""
    import positionbaseddynamics_tpu_torch.models.builders as tb

    jnames = {n for n, v in vars(JBuilder).items()
              if not n.startswith("_") and callable(v)}
    missing = [n for n in sorted(jnames) if not hasattr(TBuilder, n)]
    assert not missing, missing
    assert not hasattr(tb, "_UNPORTED")
    for name in ("add_quaternions", "add_line_model", "add_rod_constraints",
                 "add_ghost_rod_model", "add_direct_rod_chain",
                 "add_generic_constraints", "add_generic_rigid_constraints"):
        assert getattr(TBuilder, name).__qualname__ == f"SceneBuilder.{name}"


def _rigid_zoo(builder, **build_kw):
    """Every rigid adder: bodies with start velocities and spins, one from a
    closed box mesh, each of the 14 joint adders (motors with sequences of
    unequal length and without), a cloth whose corner hangs from a body,
    and a static body shared by several joints."""
    b = builder()
    tm = b.add_regular_triangle_model(4, 4, translation=(0.0, 2.0, 0.0))
    s = b.add_rigid_body((0.0, 0.0, 0.0), mass=0.0)
    bodies = [b.add_rigid_body((1.0 + 0.5 * i, 0.1 * i, -0.2 * i),
                               q=(1.0, 0.1 * i, -0.05 * i, 0.02),
                               mass=1.0 + 0.1 * i,
                               inertia=(0.1, 0.2 + 0.01 * i, 0.3),
                               velocity=(0.0, 0.1 * i, 0.0),
                               omega=(0.05 * i, 0.0, 0.1))
              for i in range(6)]
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64) * (0.3, 0.2, 0.1)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = np.array([f for a, bb, c, d in quads
                      for f in ((a, bb, c), (a, c, d))], np.int32)
    mesh_body = b.add_rigid_body_from_mesh(
        corners, faces, density=500.0, translation=(3.0, 1.0, 0.0),
        q=(0.9, 0.1, 0.3, 0.0), scale=(1.0, 2.0, 1.5))
    b0, b1, b2, b3, b4, b5 = bodies
    b.add_ball_joint(s, b0, (0.5, 0.0, 0.0))
    b.add_ball_on_line_joint(b0, b1, (1.2, 0.05, -0.1), (1.0, 0.2, 0.0))
    b.add_hinge_joint(s, b1, (0.7, 0.0, 0.0), (0.0, 0.0, 1.0))
    b.add_universal_joint(b1, b2, (1.7, 0.15, -0.3), (0.0, 0.0, 1.0),
                          (0.0, 1.0, 0.0))
    b.add_slider_joint(s, b2, (1.0, 0.0, 0.3))
    b.add_target_position_motor_slider_joint(
        s, b3, (1.0, 0.0, 0.0), sequence=[0.0, 0.0, 1.0, 0.5, 2.0, 0.0],
        repeat=True)
    b.add_target_position_motor_slider_joint(b0, b4, (0.0, 1.0, 0.0),
                                             target=0.2)
    b.add_target_velocity_motor_slider_joint(b3, b4, (1.0, 0.0, 0.0),
                                             target=0.4)
    b.add_target_angle_motor_hinge_joint(
        s, b5, (2.0, 0.5, -1.0), (0.0, 0.0, 1.0),
        sequence=[0.0, 0.0, 1.0, 0.8], repeat=False)
    b.add_target_velocity_motor_hinge_joint(b4, b5, (3.0, 0.4, -0.9),
                                            (0.0, 1.0, 0.0), target=1.5)
    b.add_damper_joint(s, b5, (1.0, 0.2, 0.0), stiffness=50.0)
    b.add_rigid_distance_joint(b1, b3, (1.5, 0.1, 0.0), (2.4, 0.3, -0.6))
    b.add_rigid_body_spring(b2, mesh_body, (2.0, 0.2, -0.4),
                            (2.9, 0.9, 0.0), stiffness=200.0)
    b.add_rigid_body_particle_ball_joint(b0, tm.offset)
    b.add_rigid_body_particle_ball_joint(s, tm.offset + 3)
    b.add_stretch_bending_twisting_constraint(
        b4, mesh_body, (3.0, 0.7, -0.4), average_radius=0.1,
        average_segment_length=0.5, youngs_modulus=1e6,
        torsion_modulus=8e5)
    return b.build(**build_kw)


def test_rigid_build_matches_jax():
    """Every rigid adder builds the same rigid state and the same joint
    batches (kind order, colours, every field) as JAX's builder, exactly:
    both compute them in float64 numpy and round once to float32."""
    import dataclasses

    (ts, tc), (js, jc) = _rigid_zoo(TBuilder, device="cpu"), \
        _rigid_zoo(JBuilder)
    for f in dataclasses.fields(js.rigid):
        np.testing.assert_array_equal(_np(getattr(ts.rigid, f.name)),
                                      _np(getattr(js.rigid, f.name)),
                                      err_msg=f.name)
    assert tc.n_rigid == js.rigid.x.shape[0] == 8
    assert [j.kind for j in tc.joints] == [j.kind for j in jc.joints]
    assert len(tc.joints) == 13
    for tb, jb in zip(tc.joints, jc.joints):
        assert tb.num_colors == jb.num_colors, tb.kind
        for f in dataclasses.fields(jb):
            jv, tv = getattr(jb, f.name), getattr(tb, f.name)
            if f.metadata.get("static"):
                assert tv == jv, (tb.kind, f.name)
            else:
                assert (jv is None) == (tv is None), (tb.kind, f.name)
                if jv is not None:
                    np.testing.assert_array_equal(
                        _np(tv), _np(jv), err_msg=f"{tb.kind}.{f.name}")
    assert_builds_equal((ts, tc), (js, jc))


def test_rigid_body_from_mesh_keeps_its_mesh_frame_as_jax():
    b_t, b_j = TBuilder(), JBuilder()
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    faces = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    for b in (b_t, b_j):
        b.add_rigid_body_from_mesh(verts, faces, density=2.0,
                                   translation=(1.0, 2.0, 3.0))
    for key, v in b_j._rb_mesh_frames[0].items():
        np.testing.assert_array_equal(b_t._rb_mesh_frames[0][key], v)
    np.testing.assert_array_equal(b_t._rb_x[0], b_j._rb_x[0])
    np.testing.assert_array_equal(b_t._rb_inertia[0], b_j._rb_inertia[0])


def test_generic_rigid_constraints_raise_naming_slice_7():
    """Slice 7 ported: the generic rigid adder builds JAX's
    ``GenericRigidBatch`` (bodies, stiffness, colours), the constraint a
    torch function."""
    import torch_rod_scenes as rscenes

    ts, tc = rscenes.pendulum("torch")
    js, jc = rscenes.pendulum("jax")
    _assert_slice7_equal((ts, tc), (js, jc))
    assert len(tc.rigid_generics) == 1


def _fields_equal(tb, jb, name, skip=("fn", "levels"), rtol_fields=()):
    import dataclasses

    for f in dataclasses.fields(jb):
        if f.name in skip:
            continue
        jv, tv = getattr(jb, f.name), getattr(tb, f.name)
        if isinstance(jv, dict):
            assert sorted(tv) == sorted(jv), (name, f.name)
            for k in jv:
                np.testing.assert_array_equal(_np(tv[k]), _np(jv[k]),
                                              err_msg=f"{name}.{f.name}.{k}")
        elif f.metadata.get("static") or jv is None:
            assert tv == jv, (name, f.name)
        elif f.name in rtol_fields:
            np.testing.assert_allclose(_np(tv), _np(jv), atol=1e-6,
                                       err_msg=f"{name}.{f.name}")
        else:
            np.testing.assert_array_equal(_np(tv), _np(jv),
                                          err_msg=f"{name}.{f.name}")


def _assert_slice7_equal(t_built, j_built):
    """Two packages' builds of a slice-7 scene: equal particles,
    orientations and bodies, the particle batches (ghost-rod and generic
    included, the constraint functions apart), the Cosserat batches, the
    lattices, the stiff rods with their schedules, the generic rigid
    batches and the Jacobi counts — exactly, but the ghost rod's rest
    Darboux vectors, which both compute in float32 (1e-6)."""
    (ts, tc), (js, jc) = t_built, j_built
    for part in ("particles", "orientations", "rigid"):
        tp, jp = getattr(ts, part), getattr(js, part)
        assert (tp is None) == (jp is None), part
        if jp is not None:
            _fields_equal(tp, jp, part)
    assert [n for n, _ in tc.particle_batches()] == \
        [n for n, _ in jc.particle_batches()]
    for (name, tb), (_, jb) in zip(tc.particle_batches(),
                                   jc.particle_batches()):
        assert type(tb).__name__ == type(jb).__name__, name
        _fields_equal(tb, jb, name, rtol_fields=("rest_darboux",))
    for name in ("stretch_shear", "bend_twist"):
        tb, jb = getattr(tc, name), getattr(jc, name)
        assert (tb is None) == (jb is None), name
        if jb is not None:
            _fields_equal(tb, jb, name)
    for field in ("rod_lattices", "direct_rods", "rigid_generics"):
        tt, jt = getattr(tc, field), getattr(jc, field)
        assert len(tt) == len(jt), field
        for tb, jb in zip(tt, jt):
            assert type(tb).__name__ == type(jb).__name__, field
            _fields_equal(tb, jb, field)
    assert sorted(tc.jacobi_inv_counts) == sorted(jc.jacobi_inv_counts)
    for key, v in jc.jacobi_inv_counts.items():
        np.testing.assert_array_equal(_np(tc.jacobi_inv_counts[key]),
                                      _np(v), err_msg=key)


def _rod_adders(builder, **kw):
    """The per-constraint rod adders: quaternions added and one pinned,
    stretch-shear and bend-twist constraints one at a time, a ghost-point
    edge with its three constraints by hand, and a generic constraint
    without parameters."""
    import torch_rod_scenes as rscenes

    pkg = "jax" if builder is JBuilder else "torch"
    b = builder()
    pts = np.stack([np.linspace(0.0, 1.0, 5), np.zeros(5), np.zeros(5)], 1)
    o = b.add_particles(pts, mass=1.0)
    b.set_mass(o, 0.0)
    q = np.tile([np.cos(0.1), 0.0, np.sin(0.1), 0.0], (4, 1))
    oq = b.add_quaternions(q, mass=2.0)
    b.set_quaternion_mass(oq, 0.0)
    for i in range(4):
        b.add_stretch_shear_constraint(o + i, o + i + 1, oq + i,
                                       stiffness=(1.0, 0.5, 0.8))
    for i in range(3):
        b.add_bend_twist_constraint(oq + i, oq + i + 1, stiffness=0.3)
    g = b.add_particles([[0.5, 0.3, 0.0], [0.7, 0.25, 0.1]])
    b.add_perpendicular_bisector_constraint(o + 1, o + 2, g, stiffness=0.7)
    b.add_ghost_point_edge_distance_constraint(o + 1, o + 2, g)
    b.add_darboux_vector_constraint(o + 1, o + 2, o + 3, g, g + 1,
                                    bending_twisting=(0.2, 0.3, 0.4),
                                    mid_edge_length=0.9)
    b.add_generic_constraints(rscenes.bend_fn(pkg), [[o, o + 1, o + 2, g]],
                              stiffness=0.4)
    return b.build(**kw)


@pytest.mark.parametrize("scene", [
    "helix", "rods", "rods_unstructured", "ghost_rod", "stiff_chain",
    "y_tree", "random_tree", "generic_cloth", "pendulum", "adders"])
def test_slice7_adders_build_as_jax(scene):
    """Every slice-7 adder (line models and rod constraints on the batches
    and on the lattice, ghost-point rods, stiff-rod chains and trees,
    generic particle and rigid constraints, and the per-constraint
    adders) builds JAX's batches field by field; then
    ``convert.scene_from_numpy`` carries the JAX build across to the same
    state and set."""
    import torch_rod_scenes as rscenes

    if scene == "adders":
        t_built = _rod_adders(TBuilder, device="cpu")
        j_built = _rod_adders(JBuilder)
        fns = [rscenes.bend_fn("torch")]
    else:
        kw = {"structured": False} if scene == "rods_unstructured" else {}
        make = getattr(rscenes, scene.replace("_unstructured", ""))
        t_built, j_built = make("torch", **kw), make("jax", **kw)
        fns = ([rscenes.distance_fn("torch")] if scene == "generic_cloth"
               else [])
    _assert_slice7_equal(t_built, j_built)
    rfns = [rscenes.ball_fn("torch")] if scene == "pendulum" else []
    carried = rscenes.from_jax(*j_built, generic_fns=fns, rigid_fns=rfns)
    _assert_slice7_equal(carried, j_built)
    assert carried[1].n_orientations == t_built[1].n_orientations


def _collision_zoo(pkg, broad_phase):
    """Every collision adder: a static box floor, bodies with a sphere, a
    cylinder, a torus, a hollow box and a hollow sphere (their default
    surface samples, one beyond ``max_collider_verts``), a mesh-built body
    with a baked grid SDF (its mesh vertices as samples), a 10×10 cloth as
    a particle collider (Morton-ordered: ≥ 64 particles) and two tet bars
    as particle and tet colliders."""
    import torch_collision_scenes as scenes

    builder, col = scenes.mods(pkg)
    sdf = col.SDFShape
    b = builder()
    floor = b.add_rigid_body((0.0, -0.5, 0.0), mass=0.0)
    b.add_collision_box(floor, (3.0, 0.5, 3.0), restitution=0.3)
    bodies = [b.add_rigid_body((0.8 * i - 2.0, 1.0, 0.0), mass=1.0 + i)
              for i in range(5)]
    b.add_collision_sphere(bodies[0], 0.3, friction=0.4)
    b.add_collision_cylinder(bodies[1], 0.2, 0.6)
    b.add_collision_torus(bodies[2], 0.3, 0.1)
    b.add_collision_object(bodies[3], sdf.hollow_box((0.3, 0.2, 0.2), 0.02))
    b.add_collision_object(bodies[4], sdf.hollow_sphere(0.3, 0.05),
                           restitution=0.1)
    v, f = scenes.cube_mesh(0.25)
    mesh = b.add_rigid_body_from_mesh(v * [1.0, 0.7, 1.2], f, density=3.0,
                                      translation=(1.5, 1.0, 0.5))
    values, origin, extent = col.bake_mesh_sdf(v * [1.0, 0.7, 1.2], f,
                                               resolution=10)
    b.add_collision_sdf(mesh, values, origin, extent)
    cloth = b.add_regular_triangle_model(10, 10, translation=(-1, 2, -1),
                                         rotation=scenes.FLAT,
                                         scale=(2.0, 2.0))
    b.set_particle_collider(cloth, restitution=0.2, friction=0.1)
    for y in (0.3, 0.8):
        bar = b.add_regular_tet_model(4, 2, 2, translation=(0.0, y, 0.0),
                                      scale=(1.0, 0.2, 0.3))
        b.set_particle_collider(bar)
        b.set_tet_collider(bar, grid_resolution=8)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return b.build_collision_pipeline(
        tolerance=0.015, max_collider_verts=40, broad_phase=broad_phase,
        pair_capacity=16 if broad_phase == "batched" else None, **kw)


def _same(t, j, path="pipeline"):
    """The port's collision structure ``t`` equals JAX's ``j`` field by
    field: tensors exactly (indices as int64), numbers and tuples equal;
    ``grid_row``, the port's handle on a stack of grids, is skipped."""
    import dataclasses

    import torch

    if dataclasses.is_dataclass(j):
        assert type(t).__name__ == type(j).__name__, path
        for f in dataclasses.fields(j):
            _same(getattr(t, f.name), getattr(j, f.name),
                  f"{path}.{f.name}")
    elif isinstance(j, (tuple, list)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _same(a, b, f"{path}[{i}]")
    elif j is None or t is None:
        assert t is None and j is None, path
    elif isinstance(j, np.generic):
        assert t == j, path
    elif hasattr(j, "shape"):
        assert isinstance(t, torch.Tensor), path
        assert t.dtype in (torch.float32, torch.int64), path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), path)
    else:
        assert t == j, path


@pytest.mark.parametrize("broad_phase", ["auto", "unrolled", "batched"])
def test_collision_adders_build_jax_pipeline(broad_phase):
    jp = _collision_zoo("jax", broad_phase)
    tp = _collision_zoo("torch", broad_phase)
    assert tp.broad_phase == jp.broad_phase
    assert tp.broad_phase == ("unrolled" if broad_phase == "unrolled"
                              else "batched")
    assert tp.active and len(tp.solid_pairs) == 4
    _same(tp, jp)
