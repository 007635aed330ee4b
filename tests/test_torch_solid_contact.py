"""The port's particle–tet contacts (``positionbaseddynamics_tpu_torch/
collision/solid.py``) against the JAX package's, on the CPU.

``TetCollider.create`` runs the same numpy code in both, so its arrays
must be equal. The queries and the detection run on JAX's own states of
``deformable_collision_demo.py``'s two bars: masks and indices equal, the
other fields of active rows within 1e-6, ``overflow`` equal. Two fields
divide by a small difference: the normal is ``cp1 − x`` normalised (an
ulp of the O(1) positions over the depth), the tangent the tangential
relative velocity normalised; their bar is 1e-6 times that conditioning
factor (``|cp1| / |cp1 − x|`` and ``|u_rel| / |u_t|``), which JAX's own
fused arithmetic (FMA contractions) meets no better; the tangent also
carries the normal's factor. The solves take JAX's
contact rows, converted, and are held to 1e-6."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_collision_scenes as scenes
from positionbaseddynamics_tpu.collision import solid as jsolid
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver.step import step as jstep
from positionbaseddynamics_tpu_torch.collision import solid as tsolid

TOL = 1e-6
INDEX = ("particle", "tet_verts")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _run(steps=(), **kw):
    """Both packages' two bars and JAX's states after each step count in
    ``steps``."""
    js, jc, jp = scenes.two_bars("jax", **kw)
    ts, tc, tp = scenes.two_bars("torch", **kw)
    f = jax.jit(lambda s: jstep(s, jc, JConfig(), jp))
    out, s = {}, js
    for i in range(max(steps) + 1 if steps else 0):
        if i in steps:
            out[i] = s
        s = f(s)
    return js, jp, ts, tp, out


def _colliders(jp, tp):
    jt = [tc for _, tc in jp.solid_pairs]
    tt = [tc for _, tc in tp.solid_pairs]
    return jt, tt


def test_tet_collider_create_is_exact():
    js, jp, ts, tp, _ = _run()
    assert [pg for pg, _ in tp.solid_pairs] == \
        [tuple(pg) for pg, _ in jp.solid_pairs]
    for jt, tt in zip(*_colliders(jp, tp)):
        for f in dataclasses.fields(tt):
            a, b = getattr(tt, f.name), getattr(jt, f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype in (torch.float32, torch.int64)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              f.name)
            else:
                assert a == b, f.name


def test_lookup_and_closest_surface_point():
    """The ref-tet grid lookup exactly and the exact closest point on the
    rest surface within 1e-6, at points in and around the bar."""
    _, jp, _, tp, _ = _run()
    rng = np.random.default_rng(0)
    for jt, tt in zip(*_colliders(jp, tp)):
        p = rng.uniform(-0.8, 0.8, (500, 3)).astype(np.float32) \
            * np.float32([1.0, 0.5, 0.5])
        np.testing.assert_array_equal(
            tt.lookup_tet(torch.from_numpy(p)).numpy(),
            np.asarray(jt.lookup_tet(jnp.asarray(p))))
        cj = np.asarray(jt.closest_surface_point(jnp.asarray(p)))
        ct = tt.closest_surface_point(torch.from_numpy(p)[None])[0].numpy()
        assert np.abs(ct - cj).max() <= TOL


def test_gated_surface_and_tet_queries(monkeypatch):
    """The block-gated closest point (its threshold lowered to 0 in both
    packages so that it runs at this size) and the block-gated containing
    tet, called with the same inputs: equal tets, the same drops,
    closest points within 1e-6."""
    monkeypatch.setattr(jsolid, "_SURF_GATE_MIN_PAIRS", 0)
    monkeypatch.setattr(tsolid, "_SURF_GATE_MIN_PAIRS", 0)
    js, jp, ts, tp, _ = _run(dims=(10, 4, 4))
    rng = np.random.default_rng(1)
    # the static bottom bar, the target of the top bar's points
    jt, tt = _colliders(jp, tp)[0][1], _colliders(jp, tp)[1][1]
    assert tt.offset == 0
    assert tt.surf_blocks.shape[0] > tt.k_surf_blocks
    p = (rng.uniform(-0.7, 0.7, (300, 3)) * [1.0, 0.3, 0.4]).astype(
        np.float32)
    need = rng.uniform(size=300) < 0.7
    for cap in (None, 64):
        cj, dj = jax.jit(functools.partial(
            jt.closest_surface_point_gated, refine_capacity=cap))(
            jnp.asarray(p), need=jnp.asarray(need))
        ct, dt = tt.closest_surface_point_gated(
            torch.from_numpy(p)[None], need=torch.from_numpy(need)[None],
            refine_capacity=cap)
        assert float(dt[0]) == float(dj)
        assert np.abs(ct[0].numpy() - np.asarray(cj)).max() <= TOL
    x = np.asarray(js.particles.x)
    xt0 = x[np.asarray(jt.tets)[:, 0]]
    a = np.stack([x[np.asarray(jt.tets)[:, k]] - xt0 for k in (1, 2, 3)],
                 -1)
    inv_a = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
    for cap in (None, 40):
        oj = jax.jit(functools.partial(jsolid._gated_containing_tet, jt,
                                       capacity=cap))(
            jnp.asarray(x), jnp.asarray(p), jnp.asarray(xt0),
            jnp.asarray(inv_a))
        ot = tsolid._gated_containing_tet(
            tt, torch.from_numpy(x)[None], torch.from_numpy(p)[None],
            torch.from_numpy(xt0)[None], torch.from_numpy(inv_a)[None],
            capacity=cap)
        for a, b in zip(ot, oj):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
        assert np.asarray(oj[1]).any()


def _scales(c, state):
    """The normal's and the tangent's per-row conditioning factors (see
    the module docstring), from the port's rows and state in float64;
    ``p_max`` is the tangential velocity along the tangent."""
    x = state.particles.x.double()
    v = state.particles.v.double()
    cp1 = c.cp1_frozen.double()
    d = torch.linalg.norm(cp1 - x[c.particle], dim=-1)
    normal = (torch.linalg.norm(cp1, dim=-1) / d.clamp_min(1e-12))
    u = v[c.particle] - (c.bary.double()[..., None]
                         * v[c.tet_verts]).sum(-2)
    n = c.normal.double()
    ut = u - (u * n).sum(-1, keepdim=True) * n
    tangent = torch.linalg.norm(u, dim=-1) / torch.linalg.norm(
        ut, dim=-1).clamp_min(1e-3)
    return {"normal": normal.clamp_min(1.0).numpy(),
            "tangent": tangent.clamp_min(1.0).numpy(),
            "p_max": tangent.clamp_min(1.0).numpy()}


def assert_solid_rows(t, j, state):
    mask = np.asarray(j.mask)
    np.testing.assert_array_equal(t.mask.numpy(), mask)
    act = mask > 0.5
    for f in INDEX:
        np.testing.assert_array_equal(getattr(t, f).numpy()[act],
                                      np.asarray(getattr(j, f))[act])
    scale = _scales(t, state)
    for f in ("tangent", "p_max"):
        # the tangent takes the normal's rounding too, magnified by u_t
        scale[f] = scale[f] * scale["normal"]
    for f in ("bary", "cp1_frozen", "normal", "tangent", "nkn_inv",
              "p_max", "friction"):
        a = getattr(t, f).numpy()[act].astype(np.float64)
        b = np.asarray(getattr(j, f))[act].astype(np.float64)
        bar = TOL * np.maximum(1.0, np.abs(b))
        if f in scale:
            s = scale[f][act]
            bar = bar * s.reshape(s.shape + (1,) * (bar.ndim - 1))
        assert np.all(np.abs(a - b) <= bar), (f, np.abs(a - b).max())
    np.testing.assert_allclose(t.inv_cnt.numpy(), np.asarray(j.inv_cnt),
                               rtol=0, atol=TOL)
    assert float(t.overflow) == float(j.overflow)
    return int(act.sum())


def test_detect_solid_contacts_on_jax_states():
    """The falling bar's contacts with the static one at the steps where
    they touch (``detect_solids`` of both pipelines)."""
    js, jp, ts, tp, states = _run(steps=(41, 43, 45, 49))
    detect = jax.jit(jp.detect_solids)
    seen = 0
    for s in states.values():
        p = s.particles
        jcn = detect(p.x, p.v, p.inv_mass)
        st = scenes.particles_from_jax(ts, s)
        q = st.particles
        seen += assert_solid_rows(tp.detect_solids(q.x, q.v, q.inv_mass),
                                  jcn, st)
    assert seen > 0


def test_detect_with_the_point_pre_gate():
    """A 8×8×8 top bar (512 points, ``_PRE_GATE_MIN_PTS``) lowered into the
    static bar: the per-tet sphere pre-gate compacts its points to 256
    before the inside test, in both packages."""
    js, jp, ts, tp, _ = _run(top_dims=(8, 8, 8), top_y=0.2)
    assert tp.solid_pairs[1][0][1] >= tsolid._PRE_GATE_MIN_PTS
    p = js.particles
    jcn = jax.jit(jp.detect_solids)(p.x, p.v, p.inv_mass)
    q = ts.particles
    assert assert_solid_rows(tp.detect_solids(q.x, q.v, q.inv_mass), jcn,
                             ts) > 0


def _to_torch(j):
    return tsolid.SolidContacts(**{
        f.name: torch.tensor(np.asarray(getattr(j, f.name)),
                             dtype=torch.int64 if f.name in INDEX
                             else torch.float32)
        for f in dataclasses.fields(tsolid.SolidContacts)})


def test_solid_solves_match_jax():
    """One position pass (corrections and λ) and the friction pass with
    that λ and without it, on JAX's contacts at a touching step."""
    js, jp, ts, tp, states = _run(steps=(45,))
    p = states[45].particles
    jcn = jax.jit(jp.detect_solids)(p.x, p.v, p.inv_mass)
    assert float(np.asarray(jcn.mask).sum()) > 0
    tcn = _to_torch(jcn)
    x, v, w = (torch.tensor(np.asarray(a)) for a in (p.x, p.v, p.inv_mass))
    dxj, lj = jsolid.solve_solid_contacts_position(jcn, p.x, p.inv_mass)
    dxt, lt = tsolid.solve_solid_contacts_position(tcn, x, w)
    assert np.abs(dxt.numpy() - np.asarray(dxj)).max() <= TOL
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= TOL
    assert np.abs(np.asarray(dxj)).max() > 1e-5
    for lam in (None, "last"):
        dvj = jsolid.solve_solid_contacts_velocity(
            jcn, p.x, p.v, p.inv_mass, lam=None if lam is None else lj)
        dvt = tsolid.solve_solid_contacts_velocity(
            tcn, x, v, w, lam=None if lam is None else lt)
        assert np.abs(dvt.numpy() - np.asarray(dvj)).max() <= TOL
