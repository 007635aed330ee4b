"""The port's scene loader (``scene/loader.py``) against the JAX
package's on the same scene dicts and files, on the CPU: every mesh file
is written by the test (``torch_scene_files``). The loaded scenes must be
equal: ``rigid_ids``, ``skipped_bodies``, the ``StepConfig`` fields,
``sim_params``, the models' offsets, the built state arrays and every
constraint batch and joint batch exactly (both build in float64 numpy and
round once to float32), and the collision pipeline field by field
(``test_torch_builders._same``: tensors exactly, baked SDF grids
included). Rollouts are in ``test_torch_scene_rollout.py``."""
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import torch_scene_files as files
from positionbaseddynamics_tpu.scene import load_scene as jload
from positionbaseddynamics_tpu.scene import load_scene_dict as jload_dict
from positionbaseddynamics_tpu_torch.scene import load_scene as tload
from positionbaseddynamics_tpu_torch.scene import load_scene_dict as tload_dict
from test_torch_builders import _assert_slice7_equal, _np, _same

SDF_RES = 10            # max_sdf_resolution of the baked bodies


def load_both(data, base, cache):
    """``(port scene, JAX scene)`` of one dict, the port's on the CPU."""
    kw = dict(base_path=base, cache_dir=cache, max_sdf_resolution=SDF_RES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # the skipped bodies
        return (tload_dict(data, device="cpu", **kw), jload_dict(data, **kw))


def assert_scenes_equal(t, j):
    """Two packages' loads of one scene are the same scene."""
    assert t.name == j.name
    assert t.rigid_ids == j.rigid_ids
    assert t.skipped_bodies == j.skipped_bodies
    assert t.sim_params == j.sim_params
    for f in dataclasses.fields(j.config):
        assert getattr(t.config, f.name) == getattr(j.config, f.name), f.name
    for tm, jm in ((t.tri_models, j.tri_models), (t.tet_models,
                                                   j.tet_models)):
        assert [(i, h.offset, h.mesh.n_vertices) for i, h in tm] == \
            [(i, h.offset, h.mesh.n_vertices) for i, h in jm]
        for (_, th), (_, jh) in zip(tm, jm):
            for f in ("faces", "tets", "uvs", "uv_indices"):
                if hasattr(jh.mesh, f):
                    jv, tv = getattr(jh.mesh, f), getattr(th.mesh, f)
                    assert (jv is None) == (tv is None), f
                    if jv is not None:
                        np.testing.assert_array_equal(tv, jv, err_msg=f)
    _assert_slice7_equal((t.state, t.cset), (j.state, j.cset))
    assert [b.kind for b in t.cset.joints] == [b.kind for b in j.cset.joints]
    for tb, jb in zip(t.cset.joints, j.cset.joints):
        for f in dataclasses.fields(jb):
            jv, tv = getattr(jb, f.name), getattr(tb, f.name)
            if f.metadata.get("static") or jv is None:
                assert tv == jv, (tb.kind, f.name)
            else:
                np.testing.assert_array_equal(_np(tv), _np(jv),
                                              err_msg=f"{tb.kind}.{f.name}")
    assert (t.pipeline is None) == (j.pipeline is None)
    if j.pipeline is not None:
        assert t.pipeline.broad_phase == j.pipeline.broad_phase
        _same(t.pipeline, j.pipeline)


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_small_pile(tmp_path):
    """A floor, 3 cylinders, 2 bodies with baked SDFs, 1 missing mesh: the
    missing body is skipped with a warning in both, the rest equal."""
    data, base = files.small_pile(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    assert_scenes_equal(t, j)
    assert len(t.rigid_ids) == 6 and len(t.skipped_bodies) == 1
    assert int((t.state.rigid.inv_mass > 0).sum()) == 2
    assert t.config.max_iterations == 5               # "maxIter"
    assert t.pipeline.active and t.state.particles.x.device.type == "cpu"


@pytest.mark.parametrize("xpbd", [True, False], ids=["xpbd", "defaults"])
def test_cloth(tmp_path, xpbd):
    """ClothOnBunny's stand-in at 11×11: the plane's quads, UVs and two
    static corners; XPBD distance and isometric bending by the aliases,
    or the loader's defaults, FEM triangles and classic isometric bending
    (an irregular mesh: the particle batches, not the grid solver)."""
    data, base = files.cloth(str(tmp_path), xpbd=xpbd)
    t, j = load_both(data, base, str(tmp_path / "cache"))
    assert_scenes_equal(t, j)
    _, h = t.tri_models[0]
    assert h.mesh.n_vertices == 121 and h.mesh.uv_indices is not None
    assert not t.cset.grid_cloths
    assert (t.cset.distance is not None) == xpbd
    assert (t.cset.fem_triangle is not None) == (not xpbd)
    assert t.cset.isometric_bending is not None
    assert int((t.state.particles.inv_mass == 0).sum()) == 2


def test_two_tet_models(tmp_path):
    """Two TetGen models with ``collisionObjectType`` 5: tet colliders and
    the solid–solid pairs, classic FEM tets by the alias."""
    data, base = files.two_tets(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    assert_scenes_equal(t, j)
    assert len(t.tet_models) == 2 and len(t.pipeline.solid_pairs) == 2
    assert t.cset.fem_tetra is not None


@pytest.mark.parametrize("scene,solver", [("y_tree", "DirectRodTreeBatch"),
                                          ("chain", "DirectRodBatch")])
def test_stiff_rod_trees(tmp_path, scene, solver):
    """CosseratJoints + TreeModels: the Y-tree routes to the tree solver,
    the straight chain to the chain solver; static segments take the
    builder's ``_rb_mass`` 0."""
    data, base = getattr(files, scene)(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    assert_scenes_equal(t, j)
    assert [type(b).__name__ for b in t.cset.direct_rods] == [solver]
    assert float(t.state.rigid.inv_mass[0]) == 0.0


def test_every_joint_section(tmp_path):
    """Every joint section (13), motor sequences included, and the
    rigid-body–particle joint onto a triangle model: 12 joint kinds, the
    spring and the distance joint sharing one."""
    data, base = files.joints(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    assert_scenes_equal(t, j)
    assert len({b.kind for b in t.cset.joints}) == 12
    assert sum(b.n for b in t.cset.joints) == 13


def test_simulation_aliases(tmp_path):
    """``maxIter``, ``maxIterVel`` and the three model-method aliases, and
    the other ``Simulation`` keys, map onto the same config and batches."""
    data, base = files.aliases(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    assert_scenes_equal(t, j)
    assert (t.config.max_iterations, t.config.max_iterations_v) == (3, 2)
    assert t.cset.strain_triangle is not None          # method 3
    assert t.cset.dihedral is not None                  # bending 1
    assert t.cset.strain_tetra is not None              # solid method 4


def test_load_scene_from_file_with_relative_models(tmp_path, one_thread):
    """``load_scene`` on a file: ``../models/`` resolves against the scene
    file's directory, the default device is CUDA (refused without it), and
    ``device="cpu"`` builds the JAX package's scene."""
    data, base = files.y_tree(str(tmp_path))
    path = files.write(data, base, "ytree.json")
    cache = str(tmp_path / "cache")
    t = tload(path, cache_dir=cache, device="cpu")
    j = jload(path, cache_dir=cache)
    assert_scenes_equal(t, j)
    assert t.name == "YTree"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tload(path, cache_dir=cache)


def test_missing_body_warns_and_is_listed(tmp_path):
    data, base = files.small_pile(str(tmp_path))
    with pytest.warns(UserWarning, match="missing geometry"):
        t = tload_dict(data, base_path=base, cache_dir=str(tmp_path),
                       max_sdf_resolution=SDF_RES, device="cpu")
    assert t.skipped_bodies == [(7, "../models/armadillo.obj")]


def test_default_cache_is_the_ports(tmp_path, monkeypatch):
    """Without ``cache_dir`` the bakes cache under ``$TMPDIR/
    pbd_torch_sdf_cache``."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    data, base = files.cloth(str(tmp_path / "files"), n=4)
    path = files.write(data, base, "c.json")
    tload(path, max_sdf_resolution=SDF_RES, device="cpu")
    assert os.listdir(tmp_path / "pbd_torch_sdf_cache")
