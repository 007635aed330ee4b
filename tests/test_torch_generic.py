"""The port's generic constraints (``ops/generic.py``,
``GenericConstraintBatch``, ``GenericRigidBatch`` and their passes in
``solver/step.py``) against the JAX package's, after JAX's
``tests/test_generic_constraints.py``. Each constraint function is written
twice, in JAX and in torch (``torch_rod_scenes``); JAX differentiates its
own with ``jax.jacfwd``, the port with ``torch.func.jacfwd``.

Tolerances: one solve 1e-6; 20-step rollouts against jitted JAX 1e-5;
the generic distance cloth against the classic distance-batch cloth
2e-4 over 50 steps, JAX's own bar for the same pair."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rod_scenes as scenes
from positionbaseddynamics_tpu.ops import generic as jgen
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver import rollout as jrollout
from positionbaseddynamics_tpu_torch.ops import generic as tgen
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout

ATOL = 1e-6
STEP_ATOL = 1e-5


def _diff(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


def _unit(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_generic_distance_is_the_closed_form():
    """``test_generic_matches_closed_form_distance``: the generic distance
    projection is ``Δx0 = w0/(w0+w1)·C·n``, ``Δx1 = −w1/(w0+w1)·C·n``."""
    rest = 0.7
    pts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.4, -0.2]])
    w = torch.tensor([1.0, 2.0])
    corr = tgen.solve_generic_particle_constraint(
        lambda p: (torch.linalg.vector_norm(p[1] - p[0]) - rest).reshape(1),
        pts, w).numpy()
    d = (pts[1] - pts[0]).numpy()
    n = d / np.linalg.norm(d)
    c = np.linalg.norm(d) - rest
    np.testing.assert_allclose(corr[0], c * n / 3.0, atol=1e-5)
    np.testing.assert_allclose(corr[1], -2.0 * c * n / 3.0, atol=1e-5)


@pytest.mark.parametrize("which", ["distance", "bend"])
def test_particle_op_matches_jax(which):
    rng = np.random.default_rng(0)
    k = 2 if which == "distance" else 4
    pts = rng.normal(size=(32, k, 3)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (32, k)).astype(np.float32)
    s = rng.uniform(0.1, 1.0, 32).astype(np.float32)
    prm = rng.uniform(0.2, 1.0, (32, 1)).astype(np.float32)
    if which == "distance":
        jf, tf = scenes.distance_fn("jax"), scenes.distance_fn("torch")
        want = jax.vmap(lambda p, ww, ss, pr: jgen.
                        solve_generic_particle_constraint(
                            lambda q: jf(q, pr), p, ww, ss))(
            *map(jnp.asarray, (pts, w, s, prm)))
        got = tgen.rowwise(
            lambda p, ww, ss, pr: tgen.solve_generic_particle_constraint(
                lambda q: tf(q, pr), p, ww, ss),
            tuple(map(torch.from_numpy, (pts, w, s, prm))), (2, 1, 0, 1))
    else:
        jf, tf = scenes.bend_fn("jax"), scenes.bend_fn("torch")
        want = jax.vmap(lambda p, ww, ss: jgen.
                        solve_generic_particle_constraint(jf, p, ww, ss))(
            *map(jnp.asarray, (pts, w, s)))
        got = tgen.rowwise(
            lambda p, ww, ss: tgen.solve_generic_particle_constraint(
                tf, p, ww, ss),
            tuple(map(torch.from_numpy, (pts, w, s))), (2, 1, 0))
    assert got.shape == (32, k, 3)
    assert _diff(got, want) <= ATOL


def test_rigid_op_matches_jax():
    """One generic rigid solve per row: the ball joint between random
    bodies, θ-Jacobians through ``½ (0, θ) ⊗ q``."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 2, 3)).astype(np.float32)
    q = _unit(rng, (16, 2))
    w = rng.uniform(0.0, 2.0, (16, 2)).astype(np.float32)
    a = rng.normal(size=(16, 2, 3, 3))
    iw = (a @ np.swapaxes(a, -1, -2) + np.eye(3)).astype(np.float32)
    s = np.ones(16, np.float32)
    jf, tf = scenes.ball_fn("jax"), scenes.ball_fn("torch")
    want = jax.vmap(lambda *r: jgen.solve_generic_rigid_constraint(jf, *r))(
        *map(jnp.asarray, (x, q, w, iw, s)))
    got = tgen.rowwise(
        lambda *r: tgen.solve_generic_rigid_constraint(tf, *r),
        tuple(map(torch.from_numpy, (x, q, w, iw, s))), (2, 2, 1, 3, 0))
    for g, j in zip(got, want):
        assert _diff(g, j) <= ATOL


def _rollouts(scene, n_steps, **kw):
    js, jc = scene("jax", **kw)
    ts, tc = scene("torch", **kw)
    jfin, _ = jax.jit(lambda s: jrollout(s, jc, JConfig(), n_steps))(js)
    tfin, _ = trollout(ts, tc, TConfig(), n_steps)
    return ts, tc, tfin, jfin


@pytest.mark.parametrize("bend", [False, True])
def test_generic_cloth_matches_jax(bend):
    """The 8×8 generic distance cloth (and with the generic bend), 20
    steps against JAX's jitted rollout."""
    ts, tc, tfin, jfin = _rollouts(scenes.generic_cloth, 20, bend=bend)
    assert [n for n, _ in tc.particle_batches()] == (
        ["generic0", "generic1"] if bend else ["generic0"])
    assert make_step_fn(tc, TConfig(), device="cpu").path == \
        "torch_unstructured"
    assert _diff(tfin.particles.x, jfin.particles.x) <= STEP_ATOL
    pinned = ts.particles.inv_mass == 0
    assert torch.equal(tfin.particles.x[pinned], ts.particles.x[pinned])


def test_generic_cloth_matches_distance_cloth():
    """``test_generic_cloth_matches_distance_cloth``: the generic distance
    cloth and the classic distance-batch cloth, 50 steps, 2e-4."""
    cfg = TConfig()
    fins = []
    for generic in (True, False):
        ts, tc = scenes.generic_cloth("torch", generic=generic)
        fins.append(trollout(ts, tc, cfg, 50)[0].particles.x)
    assert torch.isfinite(fins[0]).all()
    assert (fins[0] - fins[1]).abs().max().item() < 2e-4


def test_generic_pendulum_matches_jax():
    """``generic_rigidbody_demo.py``'s pendulum, 20 steps against JAX, then
    JAX's own checks at 200 steps: the connector stays at the anchor
    (0.02), the bob falls below −0.3."""
    js, jc = scenes.pendulum("jax")
    ts, tc = scenes.pendulum("torch")
    assert make_step_fn(tc, TConfig(), device="cpu").path == "torch_rigid"
    jfin, _ = jax.jit(lambda s: jrollout(s, jc, JConfig(), 20))(js)
    tfin, _ = trollout(ts, tc, TConfig(), 20)
    assert _diff(tfin.rigid.x, jfin.rigid.x) <= STEP_ATOL
    assert _diff(tfin.rigid.q, jfin.rigid.q) <= STEP_ATOL
    fin, _ = trollout(ts, tc, TConfig(), 200)
    from positionbaseddynamics_tpu_torch.ops import quaternion as quat
    c1 = quat.rotate(fin.rigid.q[1], torch.tensor([-1.0, 0.0, 0.0])) \
        + fin.rigid.x[1]
    assert (c1 - torch.tensor([1.0, 0.0, 0.0])).abs().max().item() < 0.02
    assert fin.rigid.x[1, 1].item() < -0.3
    assert torch.equal(fin.rigid.x[0], ts.rigid.x[0])
