"""The port's rod route (``solver/step.py``'s ``torch_rods``: the
orientation integration, the rod pass after the particle families, the
angular velocity updates) against the JAX package's jitted ``rollout``,
on the CPU: the Cosserat helix of ``examples/cosserat_rods_demo.py`` at 12
segments (the unstructured batches), 4 rods of 12 points on the rod
lattice, and the ghost-point rod of ``examples/elastic_rods_demo.py`` at
10 points, each built by both packages' ``SceneBuilder`` from the same
arguments and run 20 steps.

Tolerances: positions and quaternions 1e-5 (XLA contracts products into
FMAs where the port rounds each operation); a velocity or ω is a
difference over the substep ``h``, held to 2e-5 / h; K = 3 jittered
rollouts on a leading axis equal each rollout run alone to 1e-6. The
second-order velocity update amplifies an ulp by 1/h, and the reference
itself does not define the helix and the lattice rods to 1e-5 there:
JAX's eager and jitted rollouts part by 1.6e-5 and 1.08e-5 in 20 steps
(ROADMAP §C). Those cases are held to 1e-4, and the test asserts that
spread above 1e-5 (:func:`_eager_spread`). A pinned frame moves by one
ulp at the first renormalisation, in JAX as in the port, and then
stays."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_rod_scenes as scenes
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver import rollout as jrollout
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout

ATOL = 1e-5
MAX_BAR = 1e-4
N_STEPS = 20


def _diff(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


def _eager_spread(js, jc, cfg, n, jfin):
    """The reference's own float32 spread: JAX's eager rollout (under
    ``jax.disable_jit``) against its jitted one, the largest position
    difference after ``n`` steps."""
    from positionbaseddynamics_tpu.solver.step import step as jstep

    with jax.disable_jit():
        s = js
        for _ in range(n):
            s = jstep(s, jc, cfg)
    return float(np.abs(np.asarray(s.particles.x)
                        - np.asarray(jfin.particles.x)).max())


def _compare(scene, cfg_kw=None, n_steps=N_STEPS, atol=ATOL, **scene_kw):
    cfg_kw = cfg_kw or {}
    js, jc = scene("jax", **scene_kw)
    ts, tc = scene("torch", **scene_kw)
    fn = make_step_fn(tc, TConfig(**cfg_kw), device="cpu")
    jfin, _ = jax.jit(lambda s: jrollout(s, jc, JConfig(**cfg_kw),
                                         n_steps))(js)
    tfin, _ = trollout(ts, tc, TConfig(**cfg_kw), n_steps)
    if atol > ATOL:
        spread = _eager_spread(js, jc, JConfig(**cfg_kw), n_steps, jfin)
        print(f"{scene.__name__} {cfg_kw}: JAX eager against jitted "
              f"{spread!r}, port {_diff(tfin.particles.x, jfin.particles.x)!r}")
        assert spread > ATOL
    cfg = TConfig(**cfg_kw)
    h = cfg.dt / cfg.substeps
    p, jp = tfin.particles, jfin.particles
    for f in ("x", "old_x", "last_x"):
        assert _diff(getattr(p, f), getattr(jp, f)) <= atol, f
    assert _diff(p.v, jp.v) <= 2 * atol / h
    if ts.orientations is not None:
        o, jo = tfin.orientations, jfin.orientations
        for f in ("q", "old_q", "last_q"):
            assert _diff(getattr(o, f), getattr(jo, f)) <= atol, f
        assert _diff(o.omega, jo.omega) <= 2 * atol / h
        # a pinned frame is renormalised as the reference renormalises
        # every quaternion: it moves by an ulp at most once, then stays
        pinned = ts.orientations.inv_mass == 0
        first = trollout(ts, tc, TConfig(**cfg_kw), 1)[0].orientations.q
        assert torch.equal(o.q[pinned], first[pinned])
        assert (o.q[pinned] - ts.orientations.q[pinned]).abs().max() <= 1.2e-7
    pinned = ts.particles.inv_mass == 0
    assert torch.equal(p.x[pinned], ts.particles.x[pinned])
    assert (p.x - ts.particles.x).abs().max().item() > 1e-3   # it moved
    np.testing.assert_allclose(tfin.time.numpy(), np.asarray(jfin.time),
                               atol=1e-7)
    return fn, ts, tfin


@pytest.mark.parametrize("method", [0, 1])
def test_helix_matches_jax(method):
    fn, _, fin = _compare(scenes.helix,
                          dict(velocity_update_method=method),
                          atol=MAX_BAR if method else ATOL)
    assert fn.path == "torch_rods"
    norms = torch.linalg.vector_norm(fin.orientations.q, dim=-1)
    assert (norms - 1.0).abs().max().item() <= 1e-4


def test_helix_gauss_seidel_matches_jax():
    _compare(scenes.helix, dict(solver_mode="gauss_seidel"))


@pytest.mark.parametrize("method", [0, 1])
def test_lattice_rods_match_jax(method):
    fn, _, _ = _compare(scenes.rods, dict(velocity_update_method=method),
                        atol=MAX_BAR if method else ATOL)
    assert fn.path == "torch_rods"


def test_ghost_rod_matches_jax():
    fn, _, _ = _compare(scenes.ghost_rod, dict(damping=0.001))
    assert fn.path == "torch_unstructured"


def _batched(ts, k, seed, sigma=5e-3):
    """``k`` rollouts of ``ts`` on a leading axis, the free particles
    jittered by a seeded ``sigma``."""
    rng = np.random.default_rng(seed)
    p, o = ts.particles, ts.orientations
    free = (p.inv_mass > 0).numpy()[None, :, None]
    x = p.x.numpy()[None] + sigma * rng.normal(size=(k,) + tuple(p.x.shape))
    x = torch.from_numpy(np.where(free, x, p.x.numpy()[None]).astype(
        np.float32))

    def lead(a):
        return a.unsqueeze(0).expand(k, *a.shape).clone()

    return dataclasses.replace(
        ts, particles=dataclasses.replace(p, x=x, v=torch.zeros_like(x),
                                          old_x=x.clone(), last_x=x.clone()),
        orientations=dataclasses.replace(
            o, q=lead(o.q), omega=lead(o.omega), old_q=lead(o.old_q),
            last_q=lead(o.last_q)))


@pytest.mark.parametrize("scene", [scenes.helix, scenes.rods],
                         ids=["helix", "lattice"])
def test_rollouts_match_themselves_alone(scene):
    """K = 3 jittered rollouts stepped as one batched state, each against
    itself stepped alone, 10 steps, ≤ 1e-6."""
    ts, tc = scene("torch")
    fn = make_step_fn(tc, TConfig(), device="cpu")
    st = _batched(ts, 3, seed=8)
    alone = [dataclasses.replace(
        st, particles=dataclasses.replace(st.particles, **{
            f: getattr(st.particles, f)[k] for f in ("x", "v", "old_x",
                                                     "last_x")}),
        orientations=dataclasses.replace(st.orientations, **{
            f: getattr(st.orientations, f)[k]
            for f in ("q", "omega", "old_q", "last_q")}))
        for k in range(3)]
    for _ in range(10):
        st = fn(st)
        alone = [fn(a) for a in alone]
    for k in range(3):
        assert (st.particles.x[k] - alone[k].particles.x).abs().max() <= 1e-6
        assert (st.orientations.q[k]
                - alone[k].orientations.q).abs().max() <= 1e-6
