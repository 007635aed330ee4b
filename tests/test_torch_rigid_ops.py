"""The port's rigid-body ops (``ops/rigidbody.py``) against the JAX
package's, on the CPU: the quaternion matrices, the row builders, the
rotational projection rows, each joint kind's rows, the masked 6×6
``solve_rows`` on every kind's rows (static bodies and a joint between
two static bodies included), and the contact set-ups and impulses that
the collision slice wires in.

The JAX functions take one joint or contact and are ``vmap``-ed; the
port's take the leading axis. Tolerances: 1e-6 for the row and matrix
algebra; 1e-5 for the contact impulses. The solve is held to 1e-5 (plus
1e-5 relative for λ: two static bodies solve ``1e-9·Δλ = −C``) plus 3× the
reference's own distance from the same system solved in float64
(:func:`_f64_solve_rows`): a stretch-bending-twisting system mixes a
stretch compliance of 1e-4 with bend compliances of ~1e4, and there the
float32 solves of JAX and of the port (``solve_ex`` and
``jnp.linalg.solve``, LU with partial pivoting each, rounding in their
own order) are 1e-4 relative from the exact answer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.ops import rigidbody as jrb
from positionbaseddynamics_tpu.solver import joints as jjoints
from positionbaseddynamics_tpu.solver.step import (
    _masked_inv_inertia_w as j_masked_iw)
from positionbaseddynamics_tpu_torch.ops import rigidbody as trb
from positionbaseddynamics_tpu_torch.solver import joints as tjoints
from torch_rigid_scenes import KINDS, MASSES, joint_case, perturbed, unit

N = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=1e-6, rtol=0.0, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol,
                               rtol=rtol, err_msg=msg)


def test_quaternion_matrices_and_rotation_correction_match_jax():
    rng = np.random.default_rng(0)
    q = unit(rng, N).astype(np.float32)
    ot = rng.normal(size=(N, 3)).astype(np.float32)
    for name in ("quat_mat_q", "quat_mat_qhat", "quat_mat_g"):
        np.testing.assert_array_equal(getattr(trb, name)(_t(q)).numpy(),
                                      np.asarray(getattr(jrb, name)(
                                          jnp.asarray(q))), name)
    _close(trb.rotation_correction(_t(ot), _t(q)),
           jax.vmap(jrb.rotation_correction)(jnp.asarray(ot),
                                             jnp.asarray(q)))


def test_row_builders_and_rotational_rows_match_jax():
    rng = np.random.default_rng(1)
    d, r0, r1 = (rng.normal(size=(N, 3)).astype(np.float32)
                 for _ in range(3))
    for t, j in zip(trb.pos_row(_t(d), _t(r0), _t(r1)),
                    jax.vmap(jrb.pos_row)(*map(jnp.asarray, (d, r0, r1)))):
        _close(t, j)
    for t, j in zip(trb.pos_row_com(_t(d)),
                    jax.vmap(jrb.pos_row_com)(jnp.asarray(d))):
        _close(t, j)
    for t, j in zip(trb.rot_row(_t(d)), jax.vmap(jrb.rot_row)(
            jnp.asarray(d))):
        _close(t, j)
    q0, q1 = unit(rng, N).astype(np.float32), unit(rng, N).astype(np.float32)
    for rows in (2, 3):
        pr = rng.normal(size=(N, rows, 4)).astype(np.float32)
        for t, j in zip(trb.rotational_rows(_t(pr), _t(q0), _t(q1)),
                        jax.vmap(jrb.rotational_rows)(
                            *map(jnp.asarray, (pr, q0, q1)))):
            _close(t, j)


def _jax_rows(kind, seed=0, time=0.37, dt=0.001):
    """A case's gathered inputs and JAX's rows of ``kind``, as numpy."""
    bodies, conflict, x, q, kw = joint_case(kind, seed)
    jb = jjoints.make_joint_batch(kind, bodies, conflict, x, q, **kw)
    tb = tjoints.make_joint_batch(kind, bodies, conflict, x, q,
                                  device="cpu", **kw)
    rng = np.random.default_rng(200 + seed)
    xs, qs = perturbed(x, q, rng)
    w = np.where(MASSES > 0, 1.0 / np.where(MASSES > 0, MASSES, 1.0),
                 0.0).astype(np.float32)
    inertia0 = rng.uniform(0.1, 0.4, (len(MASSES), 3)).astype(np.float32)
    iw = j_masked_iw(jnp.asarray(qs), jnp.asarray(inertia0), jnp.asarray(w))
    px = pw = None
    if "particle_x" in kw:
        px = jnp.asarray(kw["particle_x"].astype(np.float32))
        pw = jnp.asarray(np.array([1.0, 0.5, 0.0, 2.0], np.float32))
    g0, g1 = jb._gather(jnp.asarray(xs), jnp.asarray(qs), jnp.asarray(w),
                        iw, px, pw)
    target = jb.current_target(jnp.float32(time))
    prep = jjoints._PREPARE[kind]
    rows = jax.vmap(lambda d, a, b, c, e, tg: prep(d, a, b, c, e, dt, tg)
                    )(jb._data(), g0[0], g0[1], g1[0], g1[1], target)
    gathered = [np.asarray(a) for a in g0 + g1]
    return tb, gathered, target, [np.asarray(r) for r in rows]


@pytest.mark.parametrize("kind", KINDS)
def test_joint_rows_match_jax(kind):
    """Each kind's six padded rows, compliances and row mask."""
    tb, (x0, q0, w0, iw0, x1, q1, w1, iw1), target, j = _jax_rows(kind)
    target = None if tb.target is None else _t(target)
    rows, alpha, active = tjoints._PREPARE[kind](
        tb._data(), _t(x0), _t(q0), _t(x1), _t(q1), 0.001, target)
    for name, a, b in zip(("c", "l0", "a0", "l1", "a1"), rows, j[:5]):
        _close(a, b, atol=1e-6, msg=name)
    alpha = np.zeros_like(j[5]) if alpha is None else alpha.numpy()
    np.testing.assert_allclose(alpha, j[5], rtol=1e-6, atol=0)
    active = tjoints._mask_tensor(active, torch.device("cpu"))
    np.testing.assert_array_equal(
        np.broadcast_to(active.numpy().astype(np.float32), j[6].shape), j[6])


def _f64_solve_rows(c, l0, a0, l1, a1, w0, iw0, w1, iw1, alpha, lam, act,
                    ka0=None, ka1=None):
    """``ops/rigidbody.py:131-172`` in float64 numpy on the same inputs."""
    f = [np.asarray(a, np.float64) for a in (c, l0, a0, l1, a1, w0, iw0,
                                             w1, iw1, alpha, lam)]
    c, l0, a0, l1, a1, w0, iw0, w1, iw1, alpha, lam = f
    ka0 = a0 if ka0 is None else np.asarray(ka0, np.float64)
    ka1 = a1 if ka1 is None else np.asarray(ka1, np.float64)
    tr = np.swapaxes
    k = (w0[:, None, None] * l0 @ tr(l0, -1, -2) + ka0 @ iw0 @ tr(ka0, -1, -2)
         + w1[:, None, None] * l1 @ tr(l1, -1, -2)
         + ka1 @ iw1 @ tr(ka1, -1, -2))
    m = np.asarray(act, np.float64)
    k = (k + alpha[:, :, None] * np.eye(6)) * (m[:, :, None] * m[:, None, :])
    k = k + (1.0 - m)[:, :, None] * np.eye(6) + 1e-9 * np.eye(6)
    dlam = np.linalg.solve(k, (-(c + alpha * lam) * m)[..., None])[..., 0]
    return (dlam, w0[:, None] * np.einsum("nij,ni->nj", l0, dlam),
            np.einsum("nij,nkj,nk->ni", iw0, a0, dlam),
            w1[:, None] * np.einsum("nij,ni->nj", l1, dlam),
            np.einsum("nij,nkj,nk->ni", iw1, a1, dlam))


def _assert_solve_close(t, j, exact, names=("dlam", "dx0", "ot0", "dx1",
                                            "ot1")):
    """Each joint's largest difference within 1e-5 plus 3× the largest
    distance of JAX's solve from the float64 one (plus 1e-5 of |λ|)."""
    for name, a, b, e in zip(names, t, j, exact):
        a, b = a.numpy(), np.asarray(b)
        bar = (1e-5 + 3.0 * np.abs(b - e).max(-1)
               + (1e-5 * np.abs(b).max(-1) if name == "dlam" else 0.0))
        assert (np.abs(a - b).max(-1) <= bar).all(), (
            name, np.abs(a - b).max(), np.abs(b - e).max())


@pytest.mark.parametrize("kind", KINDS)
def test_solve_rows_matches_jax_on_each_kinds_rows(kind):
    """The masked 6×6 solve on JAX's rows of ``kind``, with its static
    bodies (``w = 0, iw = 0``) and a joint between two static bodies."""
    _, (x0, q0, w0, iw0, x1, q1, w1, iw1), _, (c, l0, a0, l1, a1, alpha,
                                               act) = _jax_rows(kind, 1)
    lam = (0.01 * np.random.default_rng(5).normal(size=c.shape)).astype(
        np.float32)
    args = (c, l0, a0, l1, a1, w0, iw0, w1, iw1, alpha, lam)
    j = jax.vmap(jrb.solve_rows)(*map(jnp.asarray, args),
                                 jnp.asarray(act > 0.5))
    t = trb.solve_rows(*map(_t, args), _t(act > 0.5))
    _assert_solve_close(t, j, _f64_solve_rows(*args, act > 0.5))
    static0 = w0 == 0.0
    assert not t[1][static0].any() and not t[2][static0].any()


@pytest.mark.parametrize("kind", ["target_velocity_motor_slider",
                                  "target_velocity_motor_hinge"])
def test_velocity_rows_and_their_solve_match_jax(kind):
    """The velocity motors' rows and the angular rows of their K assembly
    (the slider builds K from ``t`` but applies identity angular rows:
    ``k_a0 / k_a1``), and the solve on them without compliance."""
    tb, (x0, q0, w0, iw0, x1, q1, w1, iw1), target, _ = _jax_rows(kind, 2)
    rng = np.random.default_rng(9)
    v0, om0, v1, om1 = (rng.normal(size=x0.shape).astype(np.float32)
                        for _ in range(4))
    jprep = jjoints._PREPARE_VEL[kind]
    jb_data = jjoints.make_joint_batch(kind, *joint_case(kind, 2)[:4],
                                       **joint_case(kind, 2)[4])._data()
    j = [np.asarray(a) for a in jax.vmap(jprep)(
        jb_data, *map(jnp.asarray, (x0, q0, v0, om0, x1, q1, v1, om1)),
        target)]
    rows, ka0, ka1 = tjoints._PREPARE_VEL[kind](
        tb._data(), *map(_t, (x0, q0, v0, om0, x1, q1, v1, om1)),
        _t(target))
    for name, a, b in zip(("c", "l0", "a0", "l1", "a1", "ka0", "ka1"),
                          rows + (ka0, ka1), j[:5] + j[7:]):
        _close(a, b, atol=1e-6, msg=name)
    z6 = np.zeros_like(j[0])
    args = tuple(j[:5]) + (w0, iw0, w1, iw1, z6, z6)
    jr = jax.vmap(jrb.solve_rows)(*map(jnp.asarray, args),
                                  jnp.asarray(j[6] > 0.5),
                                  jnp.asarray(j[7]), jnp.asarray(j[8]))
    tr = trb.solve_rows(*map(_t, args[:9]), None, None, _t(j[6] > 0.5),
                        k_a0=_t(j[7]), k_a1=_t(j[8]))
    _assert_solve_close(tr, jr, _f64_solve_rows(*args, j[6] > 0.5, j[7],
                                                j[8]))


def _contact_inputs(rng, n=N):
    f = {}
    for k in ("x0", "v0", "omega0", "x1", "v1", "omega1"):
        f[k] = rng.normal(size=(n, 3)).astype(np.float32)
    f["cp0"] = (f["x0"] + 0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    f["cp1"] = (f["x1"] + 0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    f["normal"] = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    for k in ("w0", "w1"):
        f[k] = rng.uniform(0.2, 2.0, n).astype(np.float32)
    f["w1"][::3] = 0.0
    for k in ("iw0", "iw1"):
        m = rng.normal(size=(n, 3, 3))
        f[k] = (0.2 * np.einsum("nij,nkj->nik", m, m)
                + 0.1 * np.eye(3)).astype(np.float32)
    f["iw1"][::3] = 0.0
    f["restitution"] = rng.uniform(0.0, 0.8, n).astype(np.float32)
    return f


def test_compute_matrix_k_matches_jax():
    f = _contact_inputs(np.random.default_rng(7))
    args = (f["cp0"], f["w0"], f["x0"], f["iw0"])
    _close(trb.compute_matrix_k(*map(_t, args)),
           jax.vmap(jrb.compute_matrix_k)(*map(jnp.asarray, args)),
           atol=1e-5)


def test_rigid_contact_init_and_impulse_match_jax():
    rng = np.random.default_rng(8)
    f = _contact_inputs(rng)
    keys = ("w0", "x0", "v0", "iw0", "omega0", "w1", "x1", "v1", "iw1",
            "omega1", "cp0", "cp1", "normal")
    args = [f[k] for k in keys] + [f["restitution"]]
    j_init = jax.vmap(jrb.init_rigid_contact)(*map(jnp.asarray, args))
    t_init = trb.init_rigid_contact(*map(_t, args))
    for a, b in zip(t_init, j_init):
        _close(a, b, atol=1e-5, rtol=1e-5)
    extra = [np.asarray(a) for a in j_init] + [
        np.full((N,), 1.0, np.float32), np.full((N,), 0.3, np.float32),
        rng.uniform(0.0, 0.5, N).astype(np.float32)]
    jv = jax.vmap(jrb.velocity_solve_rigid_contact)(
        *map(jnp.asarray, [f[k] for k in keys] + extra))
    tv = trb.velocity_solve_rigid_contact(*map(_t, [f[k] for k in keys]
                                               + extra))
    for a, b in zip(tv, jv):
        _close(a, b, atol=1e-5, rtol=1e-5)


def test_particle_rigid_contact_init_and_impulse_match_jax():
    rng = np.random.default_rng(9)
    f = _contact_inputs(rng)
    keys = ("w0", "x0", "v0", "w1", "x1", "v1", "iw1", "omega1", "cp0",
            "cp1", "normal")
    args = [f[k] for k in keys] + [f["restitution"]]
    j_init = jax.vmap(jrb.init_particle_rigid_contact)(*map(jnp.asarray,
                                                            args))
    t_init = trb.init_particle_rigid_contact(*map(_t, args))
    for a, b in zip(t_init, j_init):
        _close(a, b, atol=1e-5, rtol=1e-5)
    vkeys = ("w0", "v0", "w1", "x1", "v1", "iw1", "omega1", "cp0", "cp1",
             "normal")
    extra = [np.asarray(a) for a in j_init] + [
        np.full((N,), 100.0, np.float32), np.full((N,), 0.2, np.float32),
        rng.uniform(0.0, 0.5, N).astype(np.float32)]
    jv = jax.vmap(jrb.velocity_solve_particle_rigid_contact)(
        *map(jnp.asarray, [f[k] for k in vkeys] + extra))
    tv = trb.velocity_solve_particle_rigid_contact(
        *map(_t, [f[k] for k in vkeys] + extra))
    for a, b in zip(tv, jv):
        _close(a, b, atol=1e-5, rtol=1e-5)
