"""The port's joint batches (``solver/joints.py``) against the JAX package's,
on the CPU: every field ``make_joint_batch`` builds, each of the 13 kinds'
position-level solve and both velocity motors' velocity-level solve on the
same random states, the motor targets' interpolation, and the leading
rollout axis.

Each case (``torch_rigid_scenes.joint_case``) has five joints over six
bodies: a joint to a static body (``w = 0, iw = 0``), one between two
static bodies, and bodies shared by two joints. The state is the build
state moved by ~3 cm and turned by 0.08 rad, so every 6×6 system is well
conditioned. Tolerances: the build fields exactly (the same float64 numpy,
cast once); the solves 1e-5 absolute (corrections of up to ~0.1, rounded
in another order by the batched 6×6 solve), and λ also 1e-5 relative: the
joint between two static bodies solves ``1e-9·Δλ = −C``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.solver import joints as jjoints
from positionbaseddynamics_tpu.solver.step import (
    _masked_inv_inertia_w as j_masked_iw)
from positionbaseddynamics_tpu_torch.solver import joints as tjoints
from positionbaseddynamics_tpu_torch.solver.step import (
    _masked_inv_inertia_w as t_masked_iw)
from torch_rigid_scenes import KINDS, MASSES, VELOCITY_KINDS, joint_case, \
    perturbed

ATOL = 1e-5
FIELDS = ("bodies", "color", "local0", "local1", "aux0", "aux1", "frame_q",
          "pr", "rest", "rest3", "stiffness", "stiffness3", "target",
          "seq_times", "seq_values", "seq_repeat")


def _batches(kind, seed=0, **extra):
    bodies, conflict, x, q, kw = joint_case(kind, seed)
    kw.update(extra)
    jb = jjoints.make_joint_batch(kind, bodies, conflict, x, q, **kw)
    tb = tjoints.make_joint_batch(kind, bodies, conflict, x, q,
                                  device="cpu", **kw)
    return jb, tb, x, q, kw


def _state(x, q, seed, kw):
    """Inputs of a solve, as numpy float32: positions, rotations, inverse
    masses, masked world inverse inertias, multipliers, and the particles
    of ``rb_particle_ball``."""
    rng = np.random.default_rng(100 + seed)
    xs, qs = perturbed(x, q, rng)
    w = np.where(MASSES > 0, 1.0 / np.where(MASSES > 0, MASSES, 1.0),
                 0.0).astype(np.float32)
    inertia0 = rng.uniform(0.1, 0.4, (len(MASSES), 3)).astype(np.float32)
    iw = np.asarray(j_masked_iw(jnp.asarray(qs), jnp.asarray(inertia0),
                                jnp.asarray(w)))
    lam = (0.01 * rng.normal(size=(5, 6))).astype(np.float32)
    px = pw = None
    if "particle_x" in kw:
        px = (kw["particle_x"] + 0.03 * rng.normal(size=(4, 3))).astype(
            np.float32)
        pw = np.array([1.0, 0.5, 0.0, 2.0], np.float32)
    return dict(x=xs, q=qs, w=w, iw=iw, lam=lam, px=px, pw=pw,
                inertia0=inertia0)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("kind", KINDS)
def test_make_joint_batch_fields_equal_jax(kind):
    jb, tb, *_ = _batches(kind)
    assert tb.kind == jb.kind and tb.num_colors == jb.num_colors
    for f in FIELDS:
        a, b = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)


@pytest.mark.parametrize("kind", KINDS)
def test_solve_position_matches_jax(kind):
    jb, tb, x, q, kw = _batches(kind)
    s = _state(x, q, 0, kw)
    time, dt = 0.37, 0.001
    j = jb.solve_position(_j(s["x"]), _j(s["q"]), _j(s["w"]), _j(s["iw"]),
                          jnp.float32(time), dt, _j(s["lam"]),
                          px=_j(s["px"]), pw=_j(s["pw"]))
    t = tb.solve_position(_t(s["x"]), _t(s["q"]), _t(s["w"]), _t(s["iw"]),
                          torch.tensor(time), dt, _t(s["lam"]),
                          px=_t(s["px"]), pw=_t(s["pw"]))
    for name, a, b in zip(("corr_x", "corr_q", "lam"), t, j):
        # the joint between two static bodies solves 1e-9·Δλ = −C: its λ
        # is ~1e8 and compares relative
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=ATOL if name == "lam" else 0,
                                   err_msg=name)
    # the joint between two static bodies moves nothing
    if kind != "rb_particle_ball":
        assert not t[0][4].any() and not t[1][4].any()
    assert np.abs(np.asarray(j[0])).max() > 1e-4      # the case does work


@pytest.mark.parametrize("kind", VELOCITY_KINDS)
def test_solve_velocity_matches_jax(kind):
    jb, tb, x, q, kw = _batches(kind)
    s = _state(x, q, 1, kw)
    rng = np.random.default_rng(7)
    v = rng.normal(size=x.shape).astype(np.float32)
    om = rng.normal(size=x.shape).astype(np.float32)
    v[MASSES == 0] = 0.0
    om[MASSES == 0] = 0.0
    j = jb.solve_velocity(_j(s["x"]), _j(s["q"]), _j(v), _j(om), _j(s["w"]),
                          _j(s["iw"]), jnp.float32(0.2))
    t = tb.solve_velocity(_t(s["x"]), _t(s["q"]), _t(v), _t(om), _t(s["w"]),
                          _t(s["iw"]), torch.tensor(0.2))
    for name, a, b in zip(("corr_v", "corr_omega"), t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=name)
    assert np.abs(np.asarray(j[0])).max() > 1e-3


@pytest.mark.parametrize("kind", ["hinge", "stretch_bending_twisting",
                                  "rb_particle_ball", "distance"])
def test_solve_position_over_rollouts_equals_each_rollout(kind):
    """A ``(K, R, ...)`` state with the joint data and inverse masses
    shared gives each rollout's solve as alone."""
    _, tb, x, q, kw = _batches(kind)
    states = [_state(x, q, k, kw) for k in range(3)]

    def stack(f):
        return None if states[0][f] is None else torch.stack(
            [_t(s[f]) for s in states])

    out = tb.solve_position(stack("x"), stack("q"), _t(states[0]["w"]),
                            stack("iw"), torch.tensor(0.1), 0.001,
                            stack("lam"), px=stack("px"),
                            pw=_t(states[0]["pw"]))
    for k, s in enumerate(states):
        alone = tb.solve_position(_t(s["x"]), _t(s["q"]), _t(s["w"]),
                                  _t(s["iw"]), torch.tensor(0.1), 0.001,
                                  _t(s["lam"]), px=_t(s["px"]),
                                  pw=_t(states[0]["pw"]))
        for a, b in zip(out, alone):
            np.testing.assert_allclose(a[k].numpy(), b.numpy(), atol=1e-7,
                                       rtol=0)


def test_motor_targets_interpolate_as_jax():
    """Sequences of unequal length (edge-padded, so repeated knots), one
    without a sequence, wrap-around and none; times before the first knot,
    on knots, between knots, at and past the end. 1e-6: jitted
    ``jnp.interp`` contracts ``f0 + (Δt/Δx)·Δf`` into an FMA."""
    seqs = [[0.0, 0.0, 1.0, 0.8, 2.0, 0.0], [0.0, 0.1, 0.5, 0.2],
            None, [0.25, -0.3, 0.75, 0.6, 1.5, 0.1, 3.0, 0.4],
            [0.0, 1.0]]
    repeat = [True, False, False, True, True]
    target = [0.0, 0.0, 0.3, 0.0, 0.0]
    ts, vs = [], []
    for s, tg in zip(seqs, target):
        a = (np.array([[0.0, tg]]) if s is None
             else np.asarray(s, np.float64).reshape(-1, 2))
        ts.append(a[:, 0])
        vs.append(a[:, 1])
    smax = max(len(t) for t in ts)
    seq_times = np.stack([np.pad(t, (0, smax - len(t)), mode="edge")
                          for t in ts])
    seq_values = np.stack([np.pad(v, (0, smax - len(v)), mode="edge")
                           for v in vs])
    bodies, conflict, x, q, kw = joint_case("target_angle_motor_hinge")
    args = dict(kw, target=np.asarray(target), seq_times=seq_times,
                seq_values=seq_values, seq_repeat=np.asarray(repeat))
    jb = jjoints.make_joint_batch("target_angle_motor_hinge", bodies,
                                  conflict, x, q, **args)
    tb = tjoints.make_joint_batch("target_angle_motor_hinge", bodies,
                                  conflict, x, q, device="cpu", **args)
    for time in (-0.1, 0.0, 0.25, 0.5, 0.6, 1.0, 1.7, 2.0, 2.5, 3.0, 4.25,
                 7.1):
        j = np.asarray(jb.current_target(jnp.float32(time)))
        t = tb.current_target(torch.tensor(time, dtype=torch.float32))
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=0,
                                   err_msg=f"time {time}")
    # a batch without a sequence holds its static target; no target: None
    _, tb2, *_ = _batches("target_velocity_motor_slider")
    np.testing.assert_array_equal(tb2.current_target(torch.tensor(5.0)),
                                  tb2.target)
    assert _batches("ball")[1].current_target(torch.tensor(0.0)) is None


def test_interp_equals_jnp_interp_on_random_knots():
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0.0, 2.0, (6, 7)), axis=1).astype(np.float32)
    xp[:, 3] = xp[:, 2]                        # a zero-width knot pair
    fp = rng.normal(size=(6, 7)).astype(np.float32)
    for t in rng.uniform(-0.5, 2.5, 20).astype(np.float32):
        j = np.array([np.asarray(jnp.interp(t, xp[i], fp[i]))
                      for i in range(6)])
        out = tjoints.interp(torch.full((6,), float(t)), torch.from_numpy(xp),
                             torch.from_numpy(fp))
        # jitted jnp.interp contracts f0 + (Δt/Δx)·Δf into an FMA
        np.testing.assert_allclose(out.numpy(), j, atol=1e-6, rtol=0)


def test_unknown_kind_raises():
    bodies, conflict, x, q, _ = joint_case("ball")
    with pytest.raises(ValueError):
        tjoints.make_joint_batch("weld", bodies, conflict, x, q,
                                 device="cpu")


def test_masked_inverse_inertia_matches_jax():
    rng = np.random.default_rng(4)
    q = np.asarray(perturbed(np.zeros((6, 3)), np.tile([1.0, 0, 0, 0],
                                                       (6, 1)), rng,
                             angle=0.7)[1])
    inertia0 = rng.uniform(0.1, 0.4, (6, 3)).astype(np.float32)
    inertia0[2, 1] = 0.0                      # a zero moment: no inverse
    w = np.array([0.0, 1.0, 1.0, 0.5, 0.0, 2.0], np.float32)
    j = np.asarray(j_masked_iw(jnp.asarray(q), jnp.asarray(inertia0),
                               jnp.asarray(w)))
    t = t_masked_iw(torch.from_numpy(q), torch.from_numpy(inertia0),
                    torch.from_numpy(w))
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0)
    assert not t[0].any() and not t[4].any()
