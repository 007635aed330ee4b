"""Loaded scenes stepped by both packages on the CPU: the port's
``load_scene_dict`` → ``make_step_fn`` against JAX's loader and jitted
step, 20 steps from the same scene dict, within 1e-4 (``BASELINE.md``'s
end-to-end bar). The contact scenes are here; the tet models, the joints
and the stiff-rod trees are in ``test_torch_scene_rollout_solids.py``.

Contacts switch on at a threshold, so a rounding can turn one on a step
earlier in one package and part the trajectories by a jump: the two are
compared while their active contact sets agree, and the port's detection
on the loaded pipeline is held to JAX's on JAX's own states up to step
``DETECT_STEPS`` (masks and indices exactly, rows within
``test_torch_collision.TOL``), as the collision tests do.

A loaded body's SDF is a baked cubic grid in the scaled mesh frame, and
its normal a float32 central difference over 2·10⁻⁴ there: the rounding
of a 64-term sum, divided by that step, leaves JAX's own normals ~6e-5
from the normals of the same rows computed in float64. So each row field
of an active contact is held to 1e-6 of JAX's, or, where JAX itself is
farther than that from float64, the port's root-mean-square distance from
float64 over the compared rows to twice JAX's (after the ``.csdf``
normals' bar in ``test_torch_sdf.py``; an RMS, since the largest of a
few dozen rows of two noises of one size is itself noise); float64 is
the port's detection with every tensor in double."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_collision_scenes as scenes
import torch_scene_files as files
from positionbaseddynamics_tpu.solver.step import step as jstep
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from test_torch_collision import PARTICLE_INDEX, RIGID_INDEX
from test_torch_collision import TOL as TOL_ROWS
from test_torch_scene_loader import load_both

STEPS = 20
DETECT_STEPS = 40       # JAX's states on which detection is compared
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dev(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max()) if t.numel() \
        else 0.0


def _state_dev(ts, js):
    out = _dev(ts.particles.x, js.particles.x)
    if ts.rigid is not None:
        out = max(out, _dev(ts.rigid.x, js.rigid.x),
                  _dev(ts.rigid.q, js.rigid.q))
    return out


class Detect:
    """A pipeline's rigid and particle detection (jitted for JAX's)."""

    def __init__(self, pipe, jit=False):
        self.pipe = pipe
        wrap = jax.jit if jit else (lambda f: f)
        self.rigid = wrap(pipe.detect_rigid) if pipe.rb_pairs else None
        self.particles = (wrap(pipe.detect_particles)
                          if pipe.particle_groups else None)

    def __call__(self, state):
        r, p = state.rigid, state.particles
        return (None if self.rigid is None else self.rigid(r),
                None if self.particles is None
                else self.particles(p.x, p.v, p.inv_mass, r))

    def active(self, state):
        return tuple(None if c is None else float(c.mask.sum())
                     for c in self(state))


def roll(t, j, tpipe, jpipe, steps=STEPS, detect_steps=STEPS):
    """Both scenes stepped ``steps`` times with the pipelines ``tpipe`` and
    ``jpipe`` (JAX's on to ``detect_steps``); the deviation after each step
    while the active sets agree, the step they first differ (None), JAX's
    states before each step and the port's path."""
    jf = jax.jit(lambda s: jstep(s, j.cset, j.config, jpipe))
    tf = make_step_fn(t.cset, t.config, device="cpu", pipeline=tpipe)
    td = jd = None
    if tpipe is not None and tpipe.active:
        td, jd = Detect(tpipe), Detect(jpipe, jit=True)
    ts, js, devs, parted, jstates = t.state, j.state, [], None, []
    for i in range(max(steps, detect_steps)):
        jstates.append(js)
        if i < steps:
            if parted is None and td is not None and \
                    td.active(ts) != jd.active(js):
                parted = i
            ts = tf(ts)
        js = jf(js)
        if i < steps:
            if parted is None:
                devs.append(_state_dev(ts, js))
            assert float(ts.overflow) == float(js.overflow) == 0.0
    return np.array(devs), parted, jstates, tf.path


def _double(o):
    """A dataclass tree with every float32 tensor in float64."""
    if isinstance(o, torch.Tensor):
        return o.double() if o.dtype == torch.float32 else o
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.replace(o, **{
            f.name: _double(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.init})
    if isinstance(o, (tuple, list)):
        return type(o)(_double(x) for x in o)
    return o


def detection_on_jax_states(t, j, jstates):
    """The loaded pipelines' detection on JAX's states (every other one
    from step 10): masks and indices equal to JAX's, every row field of
    the active rows within the module docstring's bar. Returns the active
    rows compared and, per field, the port's and JAX's largest distance
    from float64."""
    td, jd = Detect(t.pipeline), Detect(j.pipeline, jit=True)
    d64 = Detect(_double(t.pipeline))
    seen, diffs = 0, {}
    for s in jstates[10::2]:
        st = scenes.from_jax(t.state, s)
        for tc, jc, c64, index in zip(td(st), jd(s), d64(_double(st)),
                                      (RIGID_INDEX, PARTICLE_INDEX)):
            if jc is None:
                continue
            mask = np.asarray(jc.mask)
            np.testing.assert_array_equal(tc.mask.numpy(), mask)
            for f in index:
                np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                              np.asarray(getattr(jc, f)))
            act = mask > 0.5
            seen += int(act.sum())
            for f in dataclasses.fields(jc):
                if f.name in index or f.name in ("mask", "overflow"):
                    continue
                a, b, c = (np.asarray(v, np.float64)[act].ravel()
                           for v in (getattr(tc, f.name).numpy(),
                                     getattr(jc, f.name),
                                     getattr(c64, f.name).numpy()))
                d = diffs.setdefault(f.name, ([], [], [], [0.0]))
                d[0].append(a - c)
                d[1].append(b - c)
                d[2].append(a - b)
                d[3][0] = max(d[3][0], np.abs(b).max(initial=0.0))
    rms = {}
    for name, (port64, jax64, port_jax, mag) in diffs.items():
        port_jax = np.abs(np.concatenate(port_jax)).max(initial=0.0)
        rms[name] = [float(np.sqrt(np.mean(np.concatenate(v) ** 2)))
                     if sum(map(len, v)) else 0.0 for v in (port64, jax64)]
        assert (port_jax <= TOL_ROWS * max(1.0, mag[0])
                or rms[name][0] <= 2.0 * rms[name][1]), (name, rms[name],
                                                         port_jax)
    return seen, rms


def test_small_pile(tmp_path):
    """The floor, 3 cylinders and 2 baked bodies, stepped on both
    pipelines rebuilt from the loaded builders on the batched broad phase:
    XLA's compile of JAX's step over the loaded pipeline (18 unrolled
    gates over cubic SDF grids) runs the CPU out of memory. The loaded
    pipelines are held to each other by detection on JAX's states."""
    data, base = files.small_pile(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    assert t.pipeline.broad_phase == j.pipeline.broad_phase == "unrolled"
    tol = t.pipeline.tolerance
    tpipe = t.builder.build_collision_pipeline(
        tolerance=tol, broad_phase="batched", device="cpu")
    jpipe = j.builder.build_collision_pipeline(tolerance=tol,
                                               broad_phase="batched")
    devs, parted, jstates, path = roll(t, j, tpipe, jpipe,
                                       detect_steps=DETECT_STEPS)
    print(f"pile: max dev {devs.max()!r} over {len(devs)} steps, active "
          f"sets part at {parted}")
    assert path == "torch_rigid"
    assert len(devs) >= STEPS // 2, parted
    assert devs.max() <= TOL, devs.max()
    seen, cond = detection_on_jax_states(t, j, jstates)
    print(f"pile: {seen} active rows compared; from float64 (port, JAX): "
          f"{cond}")
    assert seen > 0


def test_cloth(tmp_path):
    """ClothOnBunny's stand-in at 11×11 landing on its baked body."""
    data, base = files.cloth(str(tmp_path))
    t, j = load_both(data, base, str(tmp_path / "cache"))
    devs, parted, jstates, path = roll(t, j, t.pipeline, j.pipeline,
                                       detect_steps=DETECT_STEPS)
    print(f"cloth: max dev {devs.max()!r} over {len(devs)} steps, active "
          f"sets part at {parted}")
    assert path == "torch_rigid"
    assert len(devs) >= STEPS // 2, parted
    assert devs.max() <= TOL, devs.max()
    seen, cond = detection_on_jax_states(t, j, jstates)
    print(f"cloth: {seen} active rows compared; from float64 (port, JAX): "
          f"{cond}")
    assert seen > 0
