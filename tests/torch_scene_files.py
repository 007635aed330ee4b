"""Scene files shared by the port's scene-I/O tests
(``test_torch_scene_loader.py``, ``test_torch_scene_rollout.py``,
``test_torch_app.py``, ``test_torch_examples.py``). The shipped reference
scenes and meshes are not in the repository, so every file is written
here, into a directory the test gives: ``bench_torch``'s stand-in writers
(its cube, cylinder, icosphere, plane and TetGen meshes), trimmed to test
sizes, and the JAX loader test's Y-tree and a chain over its own
``cube.obj``. Each function returns ``(scene dict, base path)``: the path
is the ``scenes/`` directory, so that ``../models/`` resolves as in the
reference's data layout."""
import json
import os

import numpy as np

import bench_torch as bt

ALIASES = {"maxIter": 3, "maxIterVel": 2,
           "triangleModelSimulationMethod": 3,
           "tetModelSimulationMethod": 4, "triangleModelBendingMethod": 1}


def _read(path):
    with open(path) as f:
        return json.load(f), os.path.dirname(path)


def small_pile(d):
    """PileScene's stand-in cut to a floor, 3 cylinders, its 2 baked
    bodies and 1 body of a missing mesh."""
    data, base = _read(bt.write_pile_scene(d, grid=2, missing=1))
    data["RigidBodies"] = [b for b in data["RigidBodies"] if b["id"] != 4]
    return data, base


def cloth(d, n=11, xpbd=True):
    """ClothOnBunny's stand-in at n×n, with XPBD methods unless ``xpbd`` is
    false (then the loader's defaults)."""
    return _read(bt.write_cloth_scene(d, n=n, xpbd=xpbd))


def two_tets(d, dims=(4, 2, 2)):
    """Two tet models with ``collisionObjectType`` 5 over the floor."""
    return _read(bt.write_contact_scene(d, dims=dims, models_n=2))


def cube_obj(d):
    """``models/cube.obj``, the unit cube, written by the test; returns
    the ``scenes/`` directory."""
    models = os.path.join(d, "models")
    scenes = os.path.join(d, "scenes")
    os.makedirs(models, exist_ok=True)
    os.makedirs(scenes, exist_ok=True)
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                  for z in (-0.5, 0.5)])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    with open(os.path.join(models, "cube.obj"), "w") as fh:
        for p in v:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in f:
            fh.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return scenes


def _segment(i, t):
    return {"id": i, "geometryFile": "../models/cube.obj",
            "translation": t, "scale": [0.1, 0.5, 0.1], "isDynamic": 1,
            "density": 1000, "collisionObjectType": 0}


def y_tree(d):
    """``tests/test_scene_loader.py``'s branched tree: four cube segments,
    three CosseratJoints, the root static, the dense tree solver."""
    base = cube_obj(d)
    data = {
        "Name": "YTree",
        "RigidBodies": [_segment(i, t) for i, t in enumerate(
            [[0.0, 0.0, 0.0], [0.0, -0.5, 0.0], [0.1, -1.0, 0.0],
             [-0.1, -1.0, 0.0]])],
        "CosseratJoints": [
            {"id": 0, "bodyID1": 0, "bodyID2": 1,
             "position": [0.0, -0.25, 0.0]},
            {"id": 1, "bodyID1": 1, "bodyID2": 2,
             "position": [0.0, -0.75, 0.0]},
            {"id": 2, "bodyID1": 1, "bodyID2": 3,
             "position": [0.0, -0.75, 0.0]}],
        "TreeModels": [{"rbIds": [0, 1, 2, 3], "jIds": [0, 1, 2],
                        "staticSegments": [0], "youngsModulus": 1e6,
                        "torsionModulus": 1e6}]}
    return data, base


def chain(d, n=5):
    """A straight chain of ``n`` cube segments along −y, the first static:
    the block-Thomas chain solver."""
    base = cube_obj(d)
    data = {
        "Name": "Chain",
        "RigidBodies": [_segment(i, [0.0, -0.5 * i, 0.0])
                        for i in range(n)],
        "CosseratJoints": [{"id": i, "bodyID1": i, "bodyID2": i + 1,
                            "position": [0.0, -0.5 * i - 0.25, 0.0]}
                           for i in range(n - 1)],
        "TreeModels": [{"rbIds": list(range(n)), "jIds": list(range(n - 1)),
                        "staticSegments": [0], "youngsModulus": 1e6,
                        "torsionModulus": 5e5}]}
    return data, base


def joints(d):
    """Every joint section of the format, each on its own pair of cube
    bodies (a static base, a dynamic body), the motors with target
    sequences, and ``cube.obj`` as a triangle model of distance
    constraints for the rigid-body–particle joint."""
    base = cube_obj(d)
    bodies, sections = [], {}

    def pair(y):
        i = len(bodies)
        for k, (x, dyn) in enumerate(((0.0, 0), (1.0, 1))):
            bodies.append({"id": i + k, "geometryFile": "../models/cube.obj",
                           "translation": [x, y, 0.0],
                           "scale": [0.4, 0.4, 0.4], "isDynamic": dyn,
                           "density": 500, "collisionObjectType": 0})
        return {"bodyID1": i, "bodyID2": i + 1}

    def add(section, y, **kw):
        sections.setdefault(section, []).append({**pair(y), **kw})

    z, x = [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]
    add("BallJoints", 0.0, position=[0.5, 0.0, 0.0])
    add("BallOnLineJoints", 2.0, position=[0.5, 2.0, 0.0], axis=x)
    add("HingeJoints", 4.0, position=[0.5, 4.0, 0.0], axis=z)
    add("UniversalJoints", 6.0, position=[0.5, 6.0, 0.0], axis1=z,
        axis2=[0.0, 1.0, 0.0])
    add("SliderJoints", 8.0, axis=x)
    add("TargetAngleMotorHingeJoints", 10.0, position=[0.5, 10.0, 0.0],
        axis=z, targetSequence=[0.0, 0.0, 1.0, 0.8, 2.0, 0.0],
        repeatSequence=1)
    add("TargetVelocityMotorHingeJoints", 12.0, position=[0.5, 12.0, 0.0],
        axis=z, target=1.5)
    add("TargetPositionMotorSliderJoints", 14.0, axis=x,
        targetSequence=[0.0, 0.0, 1.0, 0.5, 2.0, 0.0], repeatSequence=1)
    add("TargetVelocityMotorSliderJoints", 16.0, axis=x, target=0.4)
    add("DamperJoints", 18.0, axis=x, stiffness=50.0)
    add("RigidBodySprings", 20.0, position1=[0.0, 20.0, 0.0],
        position2=[1.0, 20.2, 0.0], stiffness=20.0)
    add("DistanceJoints", 22.0, position1=[0.2, 22.0, 0.0],
        position2=[0.9, 22.0, 0.0])
    # the particle joint: body 1 holds particle 0 of the triangle model
    sections["RigidBodyParticleBallJoints"] = [{"bodyID1": 1, "bodyID2": 0}]
    data = {"Name": "Joints",
            "Simulation": {"maxIterations": 2, "clothSimulationMethod": 1,
                           "clothBendingMethod": 0},
            "RigidBodies": bodies,
            "TriangleModels": [{"id": 0, "geometryFile": "../models/cube.obj",
                                "translation": [1.3, 0.0, 0.0],
                                "scale": [0.2, 0.2, 0.2]}],
            **sections}
    return data, base


def aliases(d):
    """A cloth and a tet model under every ``Simulation`` alias (and the
    other keys the loader maps onto ``StepConfig``)."""
    data, base = two_tets(d, dims=(3, 2, 2))
    cl, _ = cloth(d, n=4)
    data["TriangleModels"] = cl["TriangleModels"]
    data["RigidBodies"] = cl["RigidBodies"] + [
        dict(b, id=1) for b in data["RigidBodies"]]
    data["Simulation"] = {
        **ALIASES, "timeStepSize": 0.004, "subSteps": 3,
        "velocityUpdateMethod": 1, "gravity": [0.0, -9.0, 0.5],
        "contactStiffnessRigidBody": 0.5,
        "contactStiffnessParticleRigidBody": 50.0,
        "contactTolerance": 0.02, "cloth_bendingStiffness": 0.02,
        "cloth_xxStiffness": 0.9, "solid_stiffness": 0.8,
        "solid_poissonRatio": 0.25}
    return data, base


def write(data, base, name):
    """``data`` written as ``base/name``; returns its path."""
    path = os.path.join(base, name)
    with open(path, "w") as f:
        json.dump(data, f)
    return path
