"""JSON scene loader (port of ``positionbaseddynamics_tpu/scene/
loader.py``) — the reference scene format, built on the card unless the
caller passes ``device="cpu"``.

Reads the schema of ``Utils/SceneLoader.h:180-205`` (field defaults from
``Utils/SceneLoader.cpp:144-430``) and reproduces the scene-build
semantics of ``Demos/SceneLoaderDemo/SceneLoaderDemo.cpp``:

* rigid bodies from OBJ/PLY meshes with density mass properties
  (``RigidBody::initBody(density, …)``), analytic or baked-SDF collision
  geometry in the scaled mesh frame;
* triangle models (cloth) with ``addClothConstraints`` /
  ``addBendingConstraints`` driven by the scene's ``Simulation`` block;
* tet models from TetGen ``.node``/``.ele`` pairs with
  ``addSolidConstraints``;
* every joint section, including motor target sequences;
* the ``Simulation`` parameter block mapped onto :class:`StepConfig`
  (the GenericParameters ``readParameterObject`` path,
  ``Utils/SceneLoader.h:249``).

Where the reference generates cubic Discregrid SDFs at runtime
(``SceneLoaderDemo.cpp:212-260``), we bake dense grids with
the port's ``collision/bake.py`` into an npz cache (same MD5-keyed-cache idea,
``Utils/FileSystem.h:310-353``) — baked over the *scaled* mesh so the
grid lives directly in the scaled mesh frame the colliders expect.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .._device import resolve_device
from ..models.builders import SceneBuilder
from ..solver.step import StepConfig
from ..utils import npquat
from ..utils.loaders import load_mesh, load_tetgen

# collisionObjectType enum (Utils/SceneLoader.h:17-19)
NO_COLLISION, SPHERE_T, BOX_T, CYLINDER_T, TORUS_T, SDF_T, \
    HOLLOW_SPHERE_T, HOLLOW_BOX_T = range(8)


@dataclass
class LoadedScene:
    """A fully built scene: state + batches + collision pipeline +
    solver config on one device, plus the handles needed to poke at
    it."""

    name: str
    state: object                 # SimState on the scene's device
    cset: object                  # ConstraintSet
    pipeline: object              # CollisionPipeline or None
    config: StepConfig
    builder: SceneBuilder
    rigid_ids: dict               # scene body id -> rigid index
    tri_models: list              # [(id, TriModelHandle)]
    tet_models: list              # [(id, TetModelHandle)]
    sim_params: dict              # raw "Simulation" JSON block
    skipped_bodies: list = None   # [(scene body id, missing geometry path)]


def _axis_angle_quat(axis, angle) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    n = np.linalg.norm(a)
    if n < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    a = a / n
    h = 0.5 * float(angle)
    return np.array([np.cos(h), *(np.sin(h) * a)])


def _transform_points(pts, scale, q, translation) -> np.ndarray:
    """``R (p ∘ scale) + x`` — the vertex transform the demo applies to
    triangle/tet model geometry (``SceneLoaderDemo.cpp:577-580``)."""
    r = npquat.to_matrix(np.asarray(q, np.float64))
    return (np.asarray(pts, np.float64)
            * np.asarray(scale, np.float64)) @ r.T + np.asarray(
                translation, np.float64)


def _body_common(d: dict):
    """Fields shared by rigid/tri/tet entries with SceneLoader.cpp
    defaults."""
    q = _axis_angle_quat(d.get("rotationAxis", (1, 0, 0)),
                         d.get("rotationAngle", 0.0))
    return dict(
        translation=np.asarray(d.get("translation", (0, 0, 0)), np.float64),
        q=q,
        scale=np.asarray(d.get("scale", (1, 1, 1)), np.float64),
        restitution=float(d.get("restitution", 0.6)),
        friction=float(d.get("friction", 0.2)),
    )


def _sdf_shape_for(d: dict, verts_scaled, faces, cache_dir,
                   default_res=(10, 10, 10), respath=None):
    """Load a shipped Discregrid ``.csdf`` field verbatim when the scene
    provides one (``collisionObjectFileName``,
    ``CubicSDFCollisionDetection.h:27-33``), else bake (or reuse) a
    dense SDF over the scaled mesh — the analogue of ``generateSDF``
    (``SceneLoaderDemo.cpp:212-260``)."""
    from ..collision.bake import bake_mesh_sdf_cached
    from ..collision.sdf import SDFShape

    res = [int(r) for r in d.get("resolutionSDF", default_res)]
    invert = bool(d.get("invertSDF", False))

    fname = str(d.get("collisionObjectFileName", ""))
    if fname.endswith(".csdf") and respath is not None:
        path = respath(fname)
        cs = np.asarray(d.get("collisionObjectScale", (1.0, 1.0, 1.0)),
                        np.float64)
        uniform = np.allclose(cs, cs[0], rtol=1e-9)
        if os.path.exists(path) and uniform:
            # exact shipped field; reference query semantics are
            # x/scale with distance·scale[0]
            # (CubicSDFCollisionDetection.cpp:66-73)
            return SDFShape.from_csdf(path, invert=invert,
                                      scale=float(cs[0]))
        import warnings
        if not os.path.exists(path):
            warnings.warn(f"missing SDF file {fname}; rebaking")
        elif not uniform:
            warnings.warn(
                f"{fname}: non-uniform collisionObjectScale {list(cs)} — "
                f"a scaled SDF is only a distance field under uniform "
                f"scaling; rebaking over the scaled mesh instead of using "
                f"the shipped field")
    # cubic Lagrange interpolation by default, like the reference's
    # Discregrid CubicLagrangeDiscreteGrid (SceneLoaderDemo.cpp:212-260);
    # "interpolationOrderSDF": 1 opts a scene back into trilinear (8
    # gathers per eval instead of 64) — an extension key, absent from the
    # reference format.
    order = int(d.get("interpolationOrderSDF", 3))
    values, origin, extent = bake_mesh_sdf_cached(
        verts_scaled, faces, resolution=res, padding=0.1,
        cache_dir=cache_dir)
    return SDFShape.grid(values, origin, extent, invert=invert, order=order)


def _collision_shape(d: dict, verts_scaled, faces, cache_dir,
                     respath=None):
    """Map ``collisionObjectType`` + ``collisionObjectScale`` to an
    :class:`SDFShape` — the ``addCollision*`` dispatch of
    ``SceneLoaderDemo.cpp:503-545`` (box full extents are halved as in
    ``addCollisionBox``, ``DistanceFieldCollisionDetection.cpp:496-507``;
    cylinder dims are (radius, height))."""
    from ..collision.sdf import SDFShape

    ctype = int(d.get("collisionObjectType", NO_COLLISION))
    cs = np.asarray(d.get("collisionObjectScale", (1.0, 1.0, 1.0)),
                    np.float64)
    thickness = float(d.get("thicknessSDF", 0.1))
    invert = bool(d.get("invertSDF", False))
    if ctype == NO_COLLISION:
        return None
    if ctype == SPHERE_T:
        return SDFShape.sphere(cs[0], invert=invert)
    if ctype == BOX_T:
        return SDFShape.box(0.5 * cs, invert=invert)
    if ctype == CYLINDER_T:
        return SDFShape.cylinder(cs[0], cs[1], invert=invert)
    if ctype == TORUS_T:
        return SDFShape.torus(cs[0], cs[1], invert=invert)
    if ctype == SDF_T:
        return _sdf_shape_for(d, verts_scaled, faces, cache_dir,
                              respath=respath)
    if ctype == HOLLOW_SPHERE_T:
        return SDFShape.hollow_sphere(cs[0], thickness, invert=invert)
    if ctype == HOLLOW_BOX_T:
        return SDFShape.hollow_box(0.5 * cs, thickness, invert=invert)
    raise ValueError(f"unknown collisionObjectType {ctype}")


def _sim_get(sim: dict, key: str, default, *aliases):
    for k in (key,) + aliases:
        if k in sim:
            return sim[k]
    return default


def load_scene_dict(data: dict, base_path: str = ".",
                    cache_dir: Optional[str] = None,
                    max_sdf_resolution: Optional[int] = None,
                    enable_collision: bool = True,
                    device=None) -> LoadedScene:
    """Build a scene from an already-parsed JSON dict on ``device`` (None
    means CUDA). ``base_path`` resolves relative model paths (the scene
    file's directory). ``max_sdf_resolution`` optionally caps per-axis SDF
    bake resolution (useful in tests)."""
    dev = resolve_device(device)
    sim = dict(data.get("Simulation", {}))
    if max_sdf_resolution is not None:
        def _cap(d):
            if "resolutionSDF" in d:
                d = dict(d)
                d["resolutionSDF"] = [min(int(r), max_sdf_resolution)
                                      for r in d["resolutionSDF"]]
            return d
    else:
        def _cap(d):
            return d

    cfg = StepConfig(
        dt=float(_sim_get(sim, "timeStepSize", 0.005)),
        substeps=int(_sim_get(sim, "subSteps", 5)),
        max_iterations=int(_sim_get(sim, "maxIterations", 1, "maxIter")),
        max_iterations_v=int(_sim_get(sim, "maxIterationsV", 5,
                                      "maxIterVel")),
        velocity_update_method=int(_sim_get(sim, "velocityUpdateMethod", 0)),
        gravity=tuple(_sim_get(sim, "gravity", (0.0, -9.81, 0.0))),
        contact_stiffness_rb=float(
            _sim_get(sim, "contactStiffnessRigidBody", 1.0)),
        contact_stiffness_particle_rb=float(
            _sim_get(sim, "contactStiffnessParticleRigidBody", 100.0)),
    )
    tolerance = float(_sim_get(sim, "contactTolerance", 0.01))

    cloth_method = int(_sim_get(sim, "clothSimulationMethod", 2,
                                "triangleModelSimulationMethod"))
    bending_method = int(_sim_get(sim, "clothBendingMethod", 2,
                                  "triangleModelBendingMethod"))
    solid_method = int(_sim_get(sim, "solidSimulationMethod", 2,
                                "tetModelSimulationMethod"))

    b = SceneBuilder()

    def respath(p):
        return p if os.path.isabs(p) else os.path.normpath(
            os.path.join(base_path, p))

    mesh_cache: dict = {}

    def get_mesh(p):
        p = respath(p)
        if p not in mesh_cache:
            mesh_cache[p] = load_mesh(p)
        return mesh_cache[p]

    # -- rigid bodies (SceneLoaderDemo.cpp:470-545) --------------------------
    rigid_ids: dict = {}
    skipped_bodies: list = []
    has_collision = False
    for rbd in data.get("RigidBodies", []):
        rbd = _cap(rbd)
        if not os.path.exists(respath(rbd["geometryFile"])):
            # the reference skips bodies whose mesh failed to load
            # (SceneLoaderDemo.cpp:474-475); some shipped scenes reference
            # models absent from the repo (e.g. armadillo.obj)
            import warnings
            warnings.warn(f"skipping rigid body {rbd.get('id')}: missing "
                          f"geometry {rbd['geometryFile']}")
            skipped_bodies.append((rbd.get("id"), rbd["geometryFile"]))
            continue
        geo = get_mesh(rbd["geometryFile"])
        c = _body_common(rbd)
        body = b.add_rigid_body_from_mesh(
            geo["vertices"], geo["faces"],
            density=float(rbd.get("density", 1.0)),
            translation=c["translation"], q=c["q"], scale=c["scale"],
            is_dynamic=bool(rbd.get("isDynamic", True)),
            velocity=rbd.get("velocity", (0.0, 0.0, 0.0)),
            omega=rbd.get("angularVelocity", (0.0, 0.0, 0.0)))
        rigid_ids[int(rbd.get("id", len(rigid_ids)))] = body
        shape = None
        if enable_collision:
            shape = _collision_shape(
                rbd, np.asarray(geo["vertices"]) * c["scale"], geo["faces"],
                cache_dir, respath=respath)
        if shape is not None:
            b.add_collision_object(body, shape,
                                   restitution=c["restitution"],
                                   friction=c["friction"])
            has_collision = True

    # -- triangle models (SceneLoaderDemo.cpp:547-600) -----------------------
    tri_models = []
    for tmd in data.get("TriangleModels", []):
        geo = get_mesh(tmd["geometryFile"])
        c = _body_common(tmd)
        # cloth restitution/friction defaults are 0.1/0.2
        # (SceneLoader.cpp:307-311)
        rest = float(tmd.get("restitution", 0.1))
        fric = float(tmd.get("friction", 0.2))
        pts = _transform_points(geo["vertices"], c["scale"], c["q"],
                                c["translation"])
        h = b.add_triangle_model(pts, geo["faces"], uvs=geo.get("uvs"),
                                 uv_indices=geo.get("uv_indices"))
        for sp in tmd.get("staticParticles", []):
            b.set_mass(h.offset + int(sp), 0.0)
        if cloth_method:
            b.add_cloth_constraints(
                h, method=cloth_method,
                distance_stiffness=float(_sim_get(sim, "cloth_stiffness",
                                                  1.0)),
                xx_stiffness=float(_sim_get(sim, "cloth_xxStiffness", 1.0)),
                yy_stiffness=float(_sim_get(sim, "cloth_yyStiffness", 1.0)),
                xy_stiffness=float(_sim_get(sim, "cloth_xyStiffness", 1.0)),
                xy_poisson=float(_sim_get(sim, "cloth_xyPoissonRatio", 0.3)),
                yx_poisson=float(_sim_get(sim, "cloth_yxPoissonRatio", 0.3)),
                normalize_stretch=bool(_sim_get(sim, "cloth_normalizeStretch",
                                                False)),
                normalize_shear=bool(_sim_get(sim, "cloth_normalizeShear",
                                              False)))
        if bending_method:
            b.add_bending_constraints(
                h, method=bending_method,
                stiffness=float(_sim_get(sim, "cloth_bendingStiffness",
                                         0.01)))
        b.set_particle_collider(h, restitution=rest, friction=fric)
        tri_models.append((int(tmd.get("id", len(tri_models))), h))

    # -- tet models (SceneLoaderDemo.cpp:602-690) ----------------------------
    tet_models = []
    for tmd in data.get("TetModels", []):
        tmd = _cap(tmd)
        verts, tets = load_tetgen(respath(tmd["nodeFile"]),
                                  respath(tmd["eleFile"]))
        c = _body_common(tmd)
        rest = float(tmd.get("restitution", 0.1))
        fric = float(tmd.get("friction", 0.2))
        pts = _transform_points(verts, c["scale"], c["q"], c["translation"])
        h = b.add_tet_model(pts, tets)
        for sp in tmd.get("staticParticles", []):
            b.set_mass(h.offset + int(sp), 0.0)
        if solid_method:
            b.add_solid_constraints(
                h, method=solid_method,
                stiffness=float(_sim_get(sim, "solid_stiffness", 1.0)),
                poisson_ratio=float(_sim_get(sim, "solid_poissonRatio", 0.3)),
                volume_stiffness=float(_sim_get(sim, "solid_volumeStiffness",
                                                1.0)),
                normalize_stretch=bool(_sim_get(sim, "solid_normalizeStretch",
                                                False)),
                normalize_shear=bool(_sim_get(sim, "solid_normalizeShear",
                                              False)))
        b.set_particle_collider(h, restitution=rest, friction=fric)
        if (enable_collision
                and int(tmd.get("collisionObjectType",
                                NO_COLLISION)) == SDF_T):
            # deformable solid-solid target: rest-pose SDF + ref-tet map
            res = tmd.get("resolutionSDF", (20, 20, 20))
            b.set_tet_collider(h, restitution=rest, friction=fric,
                               sdf_resolution=[int(r) for r in res],
                               cache_dir=cache_dir)
            has_collision = True
        tet_models.append((int(tmd.get("id", len(tet_models))), h))

    # -- stiff-rod tree models (StiffRodsDemos scene extension) --------------
    # CosseratJoints + TreeModels declare rod chains over rigid segments
    # (Demos/StiffRodsDemos/StiffRodsSceneLoader.cpp;
    # DirectPositionBasedSolverForStiffRodsDemo.cpp:700-745: average
    # radius/length derived from the two segments' scales, rod axis = y)
    if data.get("CosseratJoints") and data.get("TreeModels"):
        joints_by_id = {int(j["id"]): j for j in data["CosseratJoints"]}
        rb_scale = {int(rbd["id"]): np.asarray(
            rbd.get("scale", (1, 1, 1)), np.float64)
            for rbd in data.get("RigidBodies", [])}
        for tree in data["TreeModels"]:
            rb_ids = [int(i) for i in tree.get("rbIds", [])]
            j_ids = [int(i) for i in tree.get("jIds", [])]
            if not rb_ids or not j_ids:
                continue
            if any(i not in rigid_ids for i in rb_ids):
                continue
            chain = [rigid_ids[i] for i in rb_ids]
            for seg in tree.get("staticSegments", []):
                body = rigid_ids.get(int(seg))
                if body is not None:
                    b._rb_mass[body] = 0.0
            positions, radii, seg_lens, edges = [], [], [], []
            local = {rid: k for k, rid in enumerate(rb_ids)}
            for k, jid in enumerate(j_ids):
                jd = joints_by_id[jid]
                b1, b2 = int(jd["bodyID1"]), int(jd["bodyID2"])
                if b1 not in local or b2 not in local:
                    import warnings
                    warnings.warn(
                        f"skipping CosseratJoint {jid}: endpoint "
                        f"{b1 if b1 not in local else b2} is not in the "
                        f"tree's rbIds")
                    continue
                positions.append(np.asarray(jd["position"], np.float64))
                sa = rb_scale[b1]
                sb = rb_scale[b2]
                radii.append(0.125 * (sa[0] + sa[2] + sb[0] + sb[2]))
                seg_lens.append(0.5 * (sa[1] + sb[1]))
                edges.append((local[b1], local[b2]))
            if not edges:
                continue
            is_path = len(edges) == len(rb_ids) - 1 and all(
                e == (k, k + 1) for k, e in enumerate(edges))
            if is_path:
                # linear chain: O(S) block-Thomas scan
                b.add_direct_rod_chain(
                    chain, np.asarray(positions),
                    np.asarray(radii), np.asarray(seg_lens),
                    float(tree.get("youngsModulus", 1e9)),
                    float(tree.get("torsionModulus", 1e9)))
            else:
                # branched tree: exact dense solve (the reference's
                # initTree/orderMatrix factorization capability,
                # PositionBasedElasticRods.cpp:735-1107)
                b.add_direct_rod_tree(
                    chain, np.asarray(edges, np.int32),
                    np.asarray(positions),
                    np.asarray(radii), np.asarray(seg_lens),
                    float(tree.get("youngsModulus", 1e9)),
                    float(tree.get("torsionModulus", 1e9)))

    # -- joints (SceneLoaderDemo.cpp:766-860) --------------------------------
    def bodies(jd):
        b1, b2 = int(jd["bodyID1"]), int(jd["bodyID2"])
        if b1 not in rigid_ids or b2 not in rigid_ids:
            raise KeyError(f"joint references missing body {b1}/{b2}")
        return rigid_ids[b1], rigid_ids[b2]

    for jd in data.get("BallJoints", []):
        b.add_ball_joint(*bodies(jd), jd["position"])
    for jd in data.get("BallOnLineJoints", []):
        b.add_ball_on_line_joint(*bodies(jd), jd["position"], jd["axis"])
    for jd in data.get("HingeJoints", []):
        b.add_hinge_joint(*bodies(jd), jd["position"], jd["axis"])
    for jd in data.get("UniversalJoints", []):
        b.add_universal_joint(*bodies(jd), jd["position"], jd["axis1"],
                              jd["axis2"])
    for jd in data.get("SliderJoints", []):
        b.add_slider_joint(*bodies(jd), jd["axis"])
    for jd in data.get("RigidBodyParticleBallJoints", []):
        b.add_rigid_body_particle_ball_joint(
            rigid_ids[int(jd["bodyID1"])], int(jd["bodyID2"]))
    for jd in data.get("TargetAngleMotorHingeJoints", []):
        b.add_target_angle_motor_hinge_joint(
            *bodies(jd), jd["position"], jd["axis"],
            target=float(jd.get("target", 0.0)),
            sequence=jd.get("targetSequence"),
            repeat=bool(jd.get("repeatSequence", False)))
    for jd in data.get("TargetVelocityMotorHingeJoints", []):
        b.add_target_velocity_motor_hinge_joint(
            *bodies(jd), jd["position"], jd["axis"],
            target=float(jd.get("target", 0.0)),
            sequence=jd.get("targetSequence"),
            repeat=bool(jd.get("repeatSequence", False)))
    for jd in data.get("TargetPositionMotorSliderJoints", []):
        b.add_target_position_motor_slider_joint(
            *bodies(jd), jd["axis"], target=float(jd.get("target", 0.0)),
            sequence=jd.get("targetSequence"),
            repeat=bool(jd.get("repeatSequence", False)))
    for jd in data.get("TargetVelocityMotorSliderJoints", []):
        b.add_target_velocity_motor_slider_joint(
            *bodies(jd), jd["axis"], target=float(jd.get("target", 0.0)),
            sequence=jd.get("targetSequence"),
            repeat=bool(jd.get("repeatSequence", False)))
    for jd in data.get("DamperJoints", []):
        b.add_damper_joint(*bodies(jd), jd["axis"],
                           float(jd.get("stiffness", 1.0)))
    for jd in data.get("RigidBodySprings", []):
        b.add_rigid_body_spring(*bodies(jd), jd["position1"],
                                jd["position2"],
                                float(jd.get("stiffness", 1.0)))
    for jd in data.get("DistanceJoints", []):
        b.add_rigid_distance_joint(*bodies(jd), jd["position1"],
                                   jd["position2"])

    state, cset = b.build(device=dev)
    pipeline = None
    if has_collision:
        pipeline = b.build_collision_pipeline(tolerance=tolerance,
                                              device=dev)

    return LoadedScene(
        name=str(data.get("Name", "scene")), state=state, cset=cset,
        pipeline=pipeline, config=cfg, builder=b, rigid_ids=rigid_ids,
        tri_models=tri_models, tet_models=tet_models, sim_params=sim,
        skipped_bodies=skipped_bodies)


def load_scene(path: str, cache_dir: Optional[str] = None,
               max_sdf_resolution: Optional[int] = None,
               enable_collision: bool = True, device=None) -> LoadedScene:
    """Read a scene JSON file (``SceneLoader::readScene``,
    ``Utils/SceneLoader.cpp:17-140``) and build it on ``device`` (None
    means CUDA). Relative model paths resolve against the scene file's
    directory; baked SDFs cache under ``cache_dir`` (default:
    ``$TMPDIR/pbd_torch_sdf_cache`` — the reference writes a ``Cache/``
    directory beside the scene, which may be read-only)."""
    if cache_dir is None:
        import tempfile
        cache_dir = os.path.join(tempfile.gettempdir(),
                                 "pbd_torch_sdf_cache")
    with open(path) as f:
        data = json.load(f)
    return load_scene_dict(data, base_path=os.path.dirname(
        os.path.abspath(path)), cache_dir=cache_dir,
        max_sdf_resolution=max_sdf_resolution,
        enable_collision=enable_collision, device=device)
