"""The port's app layer against the JAX package's on the CPU: skinning
(``models/skinning.py``: ``tet_verts`` exactly, ``bary`` within 1e-6,
``skin`` within 1e-6 on the same positions), checkpoints
(``utils/checkpoint.py``: a round trip resumes bit for bit, and a file
written by either package loads into the other with equal arrays), the
phase timers (``utils/timing.py``) and the log sinks (``utils/log.py``)."""
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_collision_scenes as scenes
import torch_rod_scenes as rscenes
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.models.skinning import VisMeshAttachment as JVis
from positionbaseddynamics_tpu.utils import checkpoint as jckpt
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.models.skinning import (
    VisMeshAttachment as TVis)
from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
from positionbaseddynamics_tpu_torch.utils import (PhaseTimers, load_state,
                                                   save_state)
from positionbaseddynamics_tpu_torch.utils import log as tlog
from positionbaseddynamics_tpu_torch.utils.checkpoint import _leaves

SKIN_TOL = 1e-6


def _bar(builder):
    b = builder()
    h = b.add_regular_tet_model(5, 3, 3, translation=(0.2, 0.1, 0.0),
                                scale=(2.0, 0.6, 0.5))
    return b, h


def test_skinning_matches_jax():
    rng = np.random.default_rng(4)
    vis = rng.uniform((0.0, 0.0, -0.1), (2.3, 0.8, 0.6), size=(300, 3))
    faces = rng.integers(0, 300, size=(50, 3))
    (bj, hj), (bt, ht) = _bar(JBuilder), _bar(TBuilder)
    rest = np.concatenate(bj._x)
    j = JVis.create(vis, hj, rest, faces=faces)
    t = TVis.create(vis, ht, rest, faces=faces, device="cpu")
    assert t.tet_verts.dtype == torch.int64 and t.bary.dtype == torch.float32
    np.testing.assert_array_equal(t.tet_verts.numpy(), np.asarray(j.tet_verts))
    np.testing.assert_allclose(t.bary.numpy(), np.asarray(j.bary),
                               atol=SKIN_TOL, rtol=0)
    np.testing.assert_array_equal(t.faces, j.faces)
    x = (rest + 0.05 * rng.normal(size=rest.shape)).astype(np.float32)
    sj = np.asarray(j.skin(jnp.asarray(x)))
    st = t.skin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(st, sj, atol=SKIN_TOL, rtol=0)
    # rest positions skin back onto the vis mesh (inside points exactly
    # up to rounding), and a batch of positions skins rollout by rollout
    inside = (vis >= (0.2, 0.1, 0.0)).all(1) & (vis <= (2.2, 0.7, 0.5)).all(1)
    back = t.skin(torch.from_numpy(rest.astype(np.float32))).numpy()
    assert np.abs(back[inside] - vis[inside]).max() < 1e-5
    xs = torch.from_numpy(np.stack([x, rest.astype(np.float32)]))
    assert torch.equal(t.skin(xs)[0], t.skin(xs[0]))
    tens = TVis.create(vis, ht, torch.from_numpy(rest), device="cpu")
    assert torch.equal(tens.tet_verts, t.tet_verts)
    assert tens.faces.shape == (0, 3)


def _scenes(pkg):
    """A scene with particles and bodies (no orientations) and one with
    orientations (the helix)."""
    return {"bodies": scenes.cloth_on_sphere(pkg, n=6)[:2],
            "helix": rscenes.helix(pkg, segments=6)}


@pytest.mark.parametrize("scene", ["bodies", "helix"])
def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path, scene):
    state, cset = _scenes("torch")[scene]
    fn = make_step_fn(cset, StepConfig(), device="cpu")
    for _ in range(5):
        state = fn(state)
    path = str(tmp_path / "s.npz")
    save_state(path, state)
    template = _scenes("torch")[scene][0]
    loaded = load_state(path, template)
    assert type(loaded) is type(state)
    assert (loaded.orientations is None) == (scene == "bodies")
    for a, b in zip(_leaves(state), _leaves(loaded)):
        assert torch.equal(a, b)
    a, b = state, loaded
    for _ in range(5):
        a, b = fn(a), fn(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("scene", ["bodies", "helix"])
def test_checkpoints_cross_between_packages(tmp_path, scene):
    """JAX's file into the port, the port's into JAX: the same leaves in
    the same order, arrays equal."""
    js = _scenes("jax")[scene][0]
    ts = _scenes("torch")[scene][0]
    # a state that is not the template: time and positions moved
    js = dataclasses.replace(js, time=js.time + 0.25, particles=(
        dataclasses.replace(js.particles, x=js.particles.x + 0.5)))
    ts = dataclasses.replace(ts, time=ts.time + 0.25, particles=(
        dataclasses.replace(ts.particles, x=ts.particles.x + 0.5)))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_state(jpath, js)
    save_state(tpath, ts)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    t_from_j = load_state(jpath, _scenes("torch")[scene][0])
    j_from_t = jckpt.load_state(tpath, _scenes("jax")[scene][0])
    import jax

    jleaves = jax.tree.leaves(j_from_t)
    tleaves = _leaves(t_from_j)
    assert len(jleaves) == len(tleaves) == len(zj.files)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t_from_j.particles.x.numpy(),
                                  np.asarray(js.particles.x))


def test_phase_timers():
    state, cset, pipe = scenes.cloth_on_sphere("torch", n=6)
    timers = PhaseTimers(cset, StepConfig(), pipe, device="cpu")
    avg = timers.measure(state, repeats=2)
    assert list(avg) == ["simulation step",
                         "position constraints projection",
                         "collision detection"]
    assert all(v > 0 for v in avg.values()), avg
    timers.measure(state, repeats=1)
    assert timers._counts["simulation step"] == 2
    report = timers.report()
    assert report.startswith("---- average times ----")
    assert all(k in report for k in avg)
    # without a pipeline: two phases
    s2, c2 = rscenes.helix("torch", segments=4)
    assert list(PhaseTimers(c2, StepConfig(), device="cpu").measure(
        s2, repeats=1)) == ["simulation step",
                            "position constraints projection"]


def test_phase_timers_refuse_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    _, cset = rscenes.helix("torch", segments=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PhaseTimers(cset, StepConfig())


def test_log_sinks(tmp_path, capsys):
    assert tlog.logger.name == "positionbaseddynamics_tpu_torch"
    buf = tlog.add_buffer_sink(tlog.INFO)
    fpath = tmp_path / "log.txt"
    fh = tlog.add_file_sink(str(fpath))
    ch = tlog.add_console_sink(tlog.WARN)
    try:
        tlog.log_debug("hidden from the buffer")
        tlog.log_info("step %d", 3)
        tlog.log_warn("careful")
        tlog.log_err("bad")
        assert buf.messages == ["[INFO] step 3", "[WARNING] careful",
                                "[ERROR] bad"]
        fh.flush()
        text = fpath.read_text()
        assert "[DEBUG] hidden from the buffer" in text
        assert "[ERROR] bad" in text
        err = capsys.readouterr().err
        assert "[WARNING] careful" in err and "step 3" not in err
    finally:
        for h in (buf, fh, ch):
            tlog.logger.removeHandler(h)
        fh.close()
        tlog.logger.setLevel(logging.NOTSET)
