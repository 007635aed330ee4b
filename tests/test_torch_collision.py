"""The port's collision detection and contact solves
(``positionbaseddynamics_tpu_torch/collision/{detection,batched,contacts}
.py``) against the JAX package's, on JAX's own states, on the CPU.

Each scene (``torch_collision_scenes``) is built by both packages; JAX's
jitted step runs it, and at several of its steps both packages detect on
JAX's state. Masks and index fields must be equal, ``overflow`` equal,
and every active row's values within 1e-6 of JAX's (relative above 1:
``p_max`` and ``nkn_inv`` are quotients). Detection thresholds decide
each row (``dist − tolerance < 0``), so comparing on one package's states
keeps a rounding from switching a contact on in one package a step before
the other; rollouts are compared in ``test_torch_collision_step.py``.
The contact solves take JAX's contact rows, converted, and are held to
1e-6 in both ``contact_solver_mode``s."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_collision_scenes as scenes
from positionbaseddynamics_tpu.collision import contacts as jcontacts
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver.step import step as jstep
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.collision import contacts as tcontacts
from positionbaseddynamics_tpu_torch.collision.detection import (
    ParticleRigidContacts, RigidContacts)

TOL = 1e-6
RIGID_INDEX = ("body0", "body1")
PARTICLE_INDEX = ("particle", "body1")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_run(scene, steps, **kw):
    """The scene of both packages and JAX's states after each step count in
    ``steps`` (one jitted step), kept for the tests that share them."""
    js, jc, jp = scene("jax", **kw)
    ts, tc, tp = scene("torch", **kw)
    f = jax.jit(lambda s: jstep(s, jc, JConfig(), jp))
    out, s = {}, js
    for i in range(max(steps) + 1):
        if i in steps:
            out[i] = s
        s = f(s)
    return jp, ts, tp, out


def _jax_states(scene, steps, **kw):
    return _jax_run(scene, tuple(steps), **kw)


_DETECT = {}


def _jax_detect(jp, kind):
    """JAX's detection of ``kind`` jitted, as its step runs it (one
    compile a pipeline)."""
    key = (id(jp), kind)
    if key not in _DETECT:
        _DETECT[key] = jax.jit(jp.detect_rigid if kind == "rigid"
                               else jp.detect_particles)
    return _DETECT[key]


def _tangent_scale(t, state):
    """Per active row, how far an ulp of the relative velocity moves the
    unit tangent: ``|u_rel| / |u_t|`` (at least 1), from the port's rows
    and state in float64. The tangent normalises the tangential relative
    velocity ``u_t``; where that is small against ``u_rel`` (a resting
    contact), the roundings of ``u_rel`` in JAX's fused form and the
    port's come out magnified by this factor."""
    r = state.rigid
    rx, rv, rom = (getattr(r, f).double() for f in ("x", "v", "omega"))
    n = t.normal.double()
    b1 = t.body1
    u = -(rv[b1] + torch.linalg.cross(rom[b1], t.cp1.double() - rx[b1]))
    if hasattr(t, "body0"):
        b0 = t.body0
        u = u + rv[b0] + torch.linalg.cross(rom[b0],
                                            t.cp0.double() - rx[b0])
    else:
        u = u + state.particles.v.double()[t.particle]
    ut = u - (u * n).sum(-1, keepdim=True) * n
    return (torch.linalg.norm(u, dim=-1)
            / torch.linalg.norm(ut, dim=-1).clamp_min(1e-3)).clamp_min(
                1.0).numpy()


def assert_rows(t, j, index, scale=None):
    """Masks and the ``index`` fields equal, every active row within
    ``TOL`` (relative above 1); ``scale`` maps a field to its per-row
    conditioning factor (:func:`_tangent_scale`), which multiplies the
    bar."""
    mask = np.asarray(j.mask)
    np.testing.assert_array_equal(t.mask.numpy(), mask)
    for f in index:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    act = mask > 0.5
    for f in dataclasses.fields(t):
        if f.name in index or f.name in ("mask", "overflow"):
            continue
        a = getattr(t, f.name).numpy()[act].astype(np.float64)
        b = np.asarray(getattr(j, f.name))[act].astype(np.float64)
        bar = TOL * np.maximum(1.0, np.abs(b))
        if scale and f.name in scale:
            c = scale[f.name][act]
            bar = bar * c.reshape(c.shape + (1,) * (bar.ndim - 1))
        assert np.all(np.abs(a - b) <= bar), (f.name, np.abs(a - b).max())
    return int(act.sum())


@pytest.mark.parametrize("broad_phase", ["unrolled", "batched"])
def test_rigid_detection_on_jax_states(broad_phase):
    """Three spheres falling onto the box floor and onto each other: the
    ported pipeline and JAX's (converted by ``convert``) detect on JAX's
    states."""
    jp, ts, tp, states = _jax_states(
        scenes.spheres_on_box, (0, 10, 20, 30), broad_phase=broad_phase,
        height=0.33)
    cp = convert.collision_pipeline_from_numpy(scenes.flatten(jp),
                                               device="cpu")
    assert tp.broad_phase == cp.broad_phase == broad_phase
    seen = 0
    for s in states.values():
        jr = _jax_detect(jp, "rigid")(s.rigid)
        st = scenes.rigid_from_jax(ts, s)
        for pipe in (tp, cp):
            tr = pipe.detect_rigid(st.rigid)
            seen += assert_rows(tr, jr, RIGID_INDEX,
                                {"tangent": _tangent_scale(tr, st)})
            if broad_phase == "batched":
                assert float(tr.overflow) == float(jr.overflow) == 0.0
            else:
                assert tr.overflow is None and jr.overflow is None
    assert seen > 0


def test_batched_overflow_is_counted():
    """A pair capacity of 4 per shape kind on the 12-body pile drops active
    pairs; the port drops the same ones and counts them as JAX does."""
    js, _, jp = scenes.pile("jax", pair_capacity=4)
    ts, _, tp = scenes.pile("torch", pair_capacity=4)
    jr, tr = jax.jit(jp.detect_rigid)(js.rigid), tp.detect_rigid(ts.rigid)
    assert float(jr.overflow) > 0
    assert float(tr.overflow) == float(jr.overflow)
    assert_rows(tr, jr, RIGID_INDEX)


@pytest.mark.parametrize("broad_phase,n", [("unrolled", 12),
                                           ("unrolled", 24),
                                           ("batched", 12)])
def test_particle_rigid_detection_on_jax_states(broad_phase, n):
    """The flat cloth landing on the sphere. At 24×24 the unrolled rows
    (576) pass the 512-row cap, so the active-first compaction runs."""
    jp, ts, tp, states = _jax_states(
        scenes.cloth_on_sphere, (0, 30, 40, 50), broad_phase=broad_phase,
        n=n)
    seen = 0
    for s in states.values():
        p = s.particles
        jr = _jax_detect(jp, "particles")(p.x, p.v, p.inv_mass, s.rigid)
        st = scenes.from_jax(ts, s)
        tr = tp.detect_particles(st.particles.x, st.particles.v,
                                 st.particles.inv_mass, st.rigid)
        seen += assert_rows(tr, jr, PARTICLE_INDEX,
                            {"tangent": _tangent_scale(tr, st)})
        if jr.overflow is None:
            assert tr.overflow is None
        else:
            assert float(tr.overflow) == float(jr.overflow) == 0.0
        assert tr.mask.shape[-1] == (512 if n == 24 else jr.mask.shape[0])
    assert seen > 0


def _contacts_to_torch(j, cls):
    return cls(**{f.name: None if getattr(j, f.name) is None else
                  torch.tensor(np.asarray(getattr(j, f.name)),
                               dtype=(torch.int64 if f.name in RIGID_INDEX
                                      + PARTICLE_INDEX else torch.float32))
                  for f in dataclasses.fields(cls)})


def _bodies(s):
    r = s.rigid
    iw = np.asarray(r.inertia_world()[1]) * (np.asarray(r.inv_mass)
                                             > 0)[:, None, None]
    return [np.asarray(a) for a in (r.x, r.v, r.omega, r.inv_mass)] + [iw]


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["jacobi", "gauss_seidel"])
def test_rigid_contact_solve_matches_jax(sequential):
    """Two passes over JAX's rb–rb rows on the settling spheres, the impulse
    sums carried."""
    jp, ts, tp, states = _jax_states(
        scenes.spheres_on_box, (0, 10, 20, 30), broad_phase="unrolled",
        height=0.33)
    s = states[30]
    jr = _jax_detect(jp, "rigid")(s.rigid)
    assert float(np.asarray(jr.mask).sum()) > 0
    tr = _contacts_to_torch(jr, RigidContacts)
    rx, rv, rom, w, iw = _bodies(s)
    jsolve = (jcontacts.solve_rigid_contacts_sequential if sequential
              else jcontacts.solve_rigid_contacts)
    jo = (jnp.asarray(rv), jnp.asarray(rom),
          jnp.zeros(jr.mask.shape, jnp.float32))
    to = (torch.tensor(rv), torch.tensor(rom),
          torch.zeros(tr.mask.shape))
    for _ in range(2):
        jo = jsolve(jr, jnp.asarray(rx), jo[0], jo[1], jnp.asarray(w),
                    jnp.asarray(iw), jo[2], 1.0)
        to = tcontacts.solve_rigid_contacts(
            tr, torch.tensor(rx), to[0], to[1], torch.tensor(w),
            torch.tensor(iw), to[2], 1.0, sequential=sequential)
    for a, b in zip(to, jo):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= TOL * max(1.0,
                                                        np.abs(b).max())
    assert np.abs(to[0].numpy() - rv).max() > 1e-3


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["jacobi", "gauss_seidel"])
def test_particle_rigid_contact_solve_matches_jax(sequential):
    """Two passes over JAX's particle–rigid rows on the cloth lying on the
    sphere (stiffness 100, ``StepConfig``'s)."""
    jp, ts, tp, states = _jax_states(
        scenes.cloth_on_sphere, (0, 30, 40, 50), broad_phase="unrolled",
        n=12)
    s = states[50]
    p = s.particles
    jr = _jax_detect(jp, "particles")(p.x, p.v, p.inv_mass, s.rigid)
    assert float(np.asarray(jr.mask).sum()) > 0
    tr = _contacts_to_torch(jr, ParticleRigidContacts)
    rx, rv, rom, w, iw = _bodies(s)
    pv, pw = np.asarray(p.v), np.asarray(p.inv_mass)
    jsolve = (jcontacts.solve_particle_rigid_contacts_sequential
              if sequential else jcontacts.solve_particle_rigid_contacts)
    jo = (jnp.asarray(pv), jnp.asarray(rv), jnp.asarray(rom),
          jnp.zeros(jr.mask.shape, jnp.float32))
    to = (torch.tensor(pv), torch.tensor(rv), torch.tensor(rom),
          torch.zeros(tr.mask.shape))
    for _ in range(2):
        jo = jsolve(jr, p.x, jo[0], jnp.asarray(pw), jnp.asarray(rx),
                    jo[1], jo[2], jnp.asarray(w), jnp.asarray(iw), jo[3],
                    100.0)
        to = tcontacts.solve_particle_rigid_contacts(
            tr, torch.tensor(np.asarray(p.x)), to[0], torch.tensor(pw),
            torch.tensor(rx), to[1], to[2], torch.tensor(w),
            torch.tensor(iw), to[3], 100.0, sequential=sequential)
    for a, b in zip(to, jo):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= TOL * max(1.0,
                                                        np.abs(b).max())
    assert np.abs(to[0].numpy() - pv).max() > 1e-3


def test_mesh_built_body_collider():
    """A body built from its mesh with a baked grid SDF: the collider keeps
    the mesh frame (``frame_rot``/``frame_t``), its vertices and its
    radii as JAX's, and detection on JAX's states agrees as it lands."""
    jp, ts, tp, states = _jax_states(scenes.mesh_body_on_box, (0, 10, 20))
    jc, tc = jp.rigid_colliders[1], tp.rigid_colliders[1]
    for f in ("frame_rot", "frame_t", "verts"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), f)
    assert tc.block_centers is None and jc.block_centers is None
    assert (tc.verts_radius, tc.shape_radius) == (jc.verts_radius,
                                                  jc.shape_radius)
    assert tc.shape.kind == jc.shape.kind == "grid"
    np.testing.assert_array_equal(tc.shape.grid_values.numpy(),
                                  np.asarray(jc.shape.grid_values))
    seen = 0
    for s in states.values():
        jr = _jax_detect(jp, "rigid")(s.rigid)
        st = scenes.rigid_from_jax(ts, s)
        tr = tp.detect_rigid(st.rigid)
        seen += assert_rows(tr, jr, RIGID_INDEX,
                            {"tangent": _tangent_scale(tr, st)})
    assert seen > 0
