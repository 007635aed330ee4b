"""Rollouts of the port's collision scenes (``make_step_fn(pipeline=)``,
``rollout(pipeline=)``) against the JAX package's jitted step, on the CPU.

Contacts switch on at a threshold (``dist − tolerance < 0``), so a
rounding can turn one on a step earlier in one package, and the two
trajectories then part by a jump: JAX's own broad phases differ by 2e-4
over 40 steps (``tests/test_batched_broadphase.py``). The scenes here stay
within 1e-5 of JAX while their active sets agree: the three spheres, the
12-body batched pile and the cloth landing on the sphere. One sphere
resting or bouncing for 120 steps is held to 1e-4, since JAX itself
parts from itself there by more than 1e-5 under float32 noise. The two
bars part where a particle–tet contact
switches: they are compared over the steps before, and the test shows
that JAX itself, with one float32 step of noise in x after every step,
parts from itself there by more than 1e-4 (ROADMAP §C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_collision_scenes as scenes
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver import rollout as jrollout
from positionbaseddynamics_tpu.solver.step import step as jstep
from positionbaseddynamics_tpu_torch.mpc.planners import _expand_state
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout

ATOL = 1e-5


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


def _steps(scene, n_steps, cfg=None, **kw):
    """Both packages' scene stepped ``n_steps`` times; returns the largest
    deviation after each step, the final states and the port's path."""
    cfg = cfg or {}
    js, jc, jp = scene("jax", **kw)
    ts, tc, tp = scene("torch", **kw)
    jf = jax.jit(lambda s: jstep(s, jc, JConfig(**cfg), jp))
    tf = make_step_fn(tc, TConfig(**cfg), device="cpu", pipeline=tp)
    devs = []
    for _ in range(n_steps):
        js, ts = jf(js), tf(ts)
        devs.append(_state_dev(ts, js))
        assert float(ts.overflow) == float(js.overflow) == 0.0
    return np.array(devs), js, ts, tf.path


def _rigid_spread(scene, n_steps, **kw):
    """The scene's float32 sensitivity in the reference itself: JAX against
    JAX whose dynamic bodies take one float32 step of noise in x after
    every step (alternating in sign); the largest difference of x and q."""
    js, jc, jp = scene("jax", **kw)
    jf = jax.jit(lambda s: jstep(s, jc, JConfig(), jp))
    a = b = js
    out = 0.0
    for i in range(n_steps):
        a, b = jf(a), jf(b)
        r = b.rigid
        x = np.asarray(r.x).copy()
        dyn = np.asarray(r.inv_mass) > 0
        x[dyn] = np.nextafter(x[dyn], np.float32((-1) ** i * np.inf))
        b = dataclasses.replace(b, rigid=dataclasses.replace(
            r, x=jnp.asarray(x)))
        out = max(out, _dev(torch.from_numpy(np.asarray(a.rigid.x)),
                            b.rigid.x),
                  _dev(torch.from_numpy(np.asarray(a.rigid.q)), b.rigid.q))
    return out


@pytest.mark.parametrize("restitution,height", [(0.4, 0.33), (0.9, 0.8)],
                         ids=["rests", "bounces"])
def test_sphere_on_box(restitution, height):
    """One sphere resting on the box floor for 120 steps, and one dropped
    from 0.8 with restitution 0.9 that bounces back up. A resting contact's
    friction acts along the tangent of a near-zero sliding velocity, so the
    reference is not defined to 1e-5 here: JAX with one float32 step of
    noise after every step parts from itself by more than 1e-5 (1.6e-5 and
    2.6e-5, ROADMAP §C), and the port is held to 1e-4."""
    kw = dict(n=1, restitution=restitution, height=height)
    devs, js, ts, path = _steps(scenes.spheres_on_box, 120, **kw)
    spread = _rigid_spread(scenes.spheres_on_box, 120, **kw)
    print(f"port from JAX {devs.max()!r}, JAX from itself {spread!r}")
    assert path == "torch_rigid"
    assert devs.max() <= 1e-4, devs.max()
    assert spread > ATOL
    y = np.asarray(js.rigid.x)[1, 1]
    if restitution < 0.5:
        assert abs(y - 0.3) < 0.03
    else:
        assert y > 0.32              # back up after the bounce


def test_spheres_settle_on_box_and_each_other():
    devs, _, ts, _ = _steps(scenes.spheres_on_box, 60, n=3, height=0.33)
    assert devs.max() <= ATOL, devs.max()


def test_cloth_lands_on_sphere():
    """The 12×12 cloth lands on the sphere (first contacts at step ~35) and
    stays outside it within the tolerance."""
    devs, js, ts, path = _steps(scenes.cloth_on_sphere, 50)
    assert path == "torch_rigid"
    assert devs.max() <= ATOL, devs.max()
    r = np.linalg.norm(ts.particles.x.numpy(), axis=-1)
    assert r.min() >= 0.6 - 0.02 - 1e-3


def test_batched_pile():
    """The 12-body pile on the batched broad phase, 40 steps."""
    devs, js, ts, _ = _steps(scenes.pile, 40)
    assert devs.max() <= ATOL, devs.max()
    assert np.asarray(js.rigid.x)[1:, 1].min() > 0.2


def test_batched_against_unrolled():
    """The port's two broad phases on a 6-body pile, Jacobi contacts: equal
    up to the row order of the contact sums (JAX's own two paths,
    ``tests/test_batched_broadphase.py:43-68``, allow 2e-4 over 40
    steps)."""
    out = []
    for bp in ("batched", "unrolled"):
        ts, tc, tp = scenes.pile("torch", n=6, broad_phase=bp)
        tf = make_step_fn(tc, TConfig(), device="cpu", pipeline=tp)
        for _ in range(40):
            ts = tf(ts)
        out.append(ts.rigid.x.numpy())
    assert np.abs(out[0] - out[1]).max() <= 2e-4


def _nudge(s, sign):
    p = s.particles
    x = np.asarray(p.x).copy()
    dyn = np.asarray(p.inv_mass) > 0
    x[dyn] = np.nextafter(x[dyn], np.float32(sign * np.inf))
    return dataclasses.replace(s, particles=dataclasses.replace(
        p, x=jnp.asarray(x)))


def test_two_bars_until_a_contact_switches():
    """``deformable_collision_demo.py``: the top bar falls, touches the
    static one from step 41 (contacts on every other step as it
    settles). The port holds 1e-5 while the two packages' contact sets
    agree (through step 57 here); JAX with one float32 step of noise in x
    after every step parts from itself by more than 1e-4 by step 64."""
    js, jc, jp = scenes.two_bars("jax")
    ts, tc, tp = scenes.two_bars("torch")
    jf = jax.jit(lambda s: jstep(s, jc, JConfig(), jp))
    tf = make_step_fn(tc, TConfig(), device="cpu", pipeline=tp)
    detect = jax.jit(jp.detect_solids)
    ja, agree, touched = js, True, 0
    spread, dev_agree, last = 0.0, 0.0, -1
    for i in range(64):
        pj, pt = js.particles, ts.particles
        nj = int(np.asarray(detect(pj.x, pj.v, pj.inv_mass).mask).sum())
        nt = int(tp.detect_solids(pt.x, pt.v, pt.inv_mass).mask.sum())
        agree = agree and nj == nt
        touched += nj > 0
        js, ts, ja = jf(js), tf(ts), _nudge(jf(ja), (-1) ** i)
        if agree:
            dev_agree, last = max(dev_agree, _state_dev(ts, js)), i
            assert _state_dev(ts, js) <= ATOL, (i, _state_dev(ts, js))
        spread = max(spread, float(np.abs(np.asarray(ja.particles.x)
                                          - np.asarray(js.particles.x)
                                          ).max()))
        assert float(ts.overflow) == 0.0
    print(f"sets agree through step {last}: port from JAX {dev_agree!r}; "
          f"after: {_state_dev(ts, js)!r}; JAX from itself {spread!r}")
    assert touched >= 5
    assert spread > 1e-4
    assert tf.path == "torch_stencil"


def test_rollout_with_a_pipeline():
    """``rollout(pipeline=, collect=True)`` against JAX's on the three
    spheres: the trajectory of particle positions (none here) and the
    final bodies."""
    js, jc, jp = scenes.spheres_on_box("jax", height=0.33)
    ts, tc, tp = scenes.spheres_on_box("torch", height=0.33)
    jfin, jtraj = jax.jit(lambda s: jrollout(
        s, jc, JConfig(), 15, collect=True, pipeline=jp))(js)
    tfin, ttraj = trollout(ts, tc, TConfig(), 15, collect=True, pipeline=tp)
    assert tuple(ttraj.shape) == tuple(jtraj.shape)
    assert _state_dev(tfin, jfin) <= ATOL
    assert float(tfin.overflow) == 0.0


def test_rollouts_of_a_batch_equal_each_rollout_alone():
    """K 3 rollouts of the 12-body pile with different start velocities,
    stepped as one batched state (each compacting its own pairs), equal
    each rollout stepped alone within 1e-6."""
    ts, tc, tp = scenes.pile("torch")
    tf = make_step_fn(tc, TConfig(), device="cpu", pipeline=tp)
    g = torch.Generator().manual_seed(0)
    kick = 0.5 * torch.randn((3,) + tuple(ts.rigid.v.shape), generator=g)
    batch = _expand_state(ts, 3)
    batch = dataclasses.replace(batch, rigid=dataclasses.replace(
        batch.rigid, v=batch.rigid.v + kick))
    alone = [dataclasses.replace(ts, rigid=dataclasses.replace(
        ts.rigid, v=ts.rigid.v + kick[k])) for k in range(3)]
    for _ in range(12):
        batch = tf(batch)
        alone = [tf(a) for a in alone]
    assert tuple(batch.overflow.shape) == (3,)
    for k in range(3):
        assert float((batch.rigid.x[k] - alone[k].rigid.x).abs().max()) \
            <= 1e-6
        assert float((batch.rigid.q[k] - alone[k].rigid.q).abs().max()) \
            <= 1e-6
    assert float((batch.rigid.x[0] - batch.rigid.x[1]).abs().max()) > 1e-3


@pytest.mark.slow
def test_big_pile_matches_jax():
    """``bench.py --pile-big`` at its 100 bodies, 20 steps (JAX compiles
    this scene for tens of seconds)."""
    devs, js, ts, _ = _steps(scenes.big_pile, 20)
    assert devs.max() <= 1e-4, devs.max()
