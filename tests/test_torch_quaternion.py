"""The port's quaternion algebra (``ops/quaternion.py``), the rotation half of
``ops/integration.py``, ``mathutils.extract_rotation``,
``pbd.solve_shape_matching`` and the build-time numpy helpers
(``utils/npquat.py``, ``utils/massprops.py``) against the JAX package's, on
the CPU.

Inputs come from numpy seeds; the JAX functions are ``vmap``-ed where they
take one item, the port's take the leading axis. Tolerances: 1e-6 absolute
for the float32 ops (JAX's ``rsqrt`` is not correctly rounded, and its
jitted and eager forms differ by an ulp); the numpy copies equal JAX's
exactly. A ω from the quaternion difference is an ulp of ``q`` over ``h``,
held to 2e-6/h."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.ops import integration as jint
from positionbaseddynamics_tpu.ops import mathutils as jmu
from positionbaseddynamics_tpu.ops import pbd as jpbd
from positionbaseddynamics_tpu.ops import quaternion as jq
from positionbaseddynamics_tpu.utils import massprops as jmass
from positionbaseddynamics_tpu.utils import npquat as jnpq
from positionbaseddynamics_tpu_torch.ops import integration as tint
from positionbaseddynamics_tpu_torch.ops import mathutils as tmu
from positionbaseddynamics_tpu_torch.ops import pbd as tpbd
from positionbaseddynamics_tpu_torch.ops import quaternion as tq
from positionbaseddynamics_tpu_torch.utils import massprops as tmass
from positionbaseddynamics_tpu_torch.utils import npquat as tnpq

ATOL = 1e-6
N = 64


def _unit(rng, n=N):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _vec(rng, n=N, scale=1.0):
    return (scale * rng.normal(size=(n, 3))).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["multiply", "conjugate", "normalize",
                                  "rotate", "rotate_inv", "to_matrix",
                                  "from_axis_angle", "third_director",
                                  "vec", "from_vec", "integrate_angular"])
def test_quaternion_op_matches_jax(name):
    rng = np.random.default_rng(0)
    a, b = _unit(rng), _unit(rng)
    raw = rng.normal(size=(N, 4)).astype(np.float32)
    v = _vec(rng)
    angle = rng.uniform(-3.0, 3.0, N).astype(np.float32)
    axis = _vec(rng)
    axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    args = {"multiply": (raw, b), "conjugate": (raw,), "normalize": (raw,),
            "rotate": (a, v), "rotate_inv": (a, v), "to_matrix": (a,),
            "from_axis_angle": (axis, angle), "third_director": (a,),
            "vec": (a,), "from_vec": (v,),
            "integrate_angular": (a, v, np.float32(0.004))}[name]
    j = getattr(jq, name)(*[jnp.asarray(x) for x in args])
    t = getattr(tq, name)(*[torch.from_numpy(np.asarray(x)) for x in args])
    _close(t, j)


def test_quaternion_ops_take_any_leading_shape():
    rng = np.random.default_rng(1)
    a = _unit(rng, 24).reshape(2, 3, 4, 4)
    v = _vec(rng, 24).reshape(2, 3, 4, 3)
    flat = tq.rotate(torch.from_numpy(a.reshape(-1, 4)),
                     torch.from_numpy(v.reshape(-1, 3)))
    np.testing.assert_array_equal(
        tq.rotate(torch.from_numpy(a), torch.from_numpy(v)).numpy(),
        flat.numpy().reshape(2, 3, 4, 3))
    # one quaternion against many vectors broadcasts as JAX's does
    _close(tq.rotate(torch.from_numpy(a[0, 0, 0]), torch.from_numpy(v)),
           jq.rotate(jnp.asarray(a[0, 0, 0]), jnp.asarray(v)))
    assert tq.identity((2, 5)).shape == (2, 5, 4)
    np.testing.assert_array_equal(tq.identity((3,)).numpy(),
                                  np.asarray(jq.identity((3,))))


def _inertia(rng, n):
    i0 = rng.uniform(0.1, 0.5, (n, 3)).astype(np.float32)
    q = _unit(rng, n)
    r = np.asarray(jq.to_matrix(jnp.asarray(q)))
    iw = np.einsum("nij,nj,nkj->nik", r, i0, r).astype(np.float32)
    inv_iw = np.einsum("nij,nj,nkj->nik", r, 1.0 / i0, r).astype(np.float32)
    return q, iw, inv_iw


def test_semi_implicit_euler_rotation_matches_jax():
    """ω += h I⁻¹(τ − ω × Iω), then the quaternion step; static items
    (inv_mass 0) keep their q and ω."""
    rng = np.random.default_rng(2)
    q, iw, inv_iw = _inertia(rng, N)
    inv_mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    inv_mass[::5] = 0.0
    omega, torque = _vec(rng, scale=3.0), _vec(rng)
    h = 0.001
    jq_new, jw = jint.semi_implicit_euler_rotation(
        h, *[jnp.asarray(a) for a in (inv_mass, iw, inv_iw, q, omega,
                                      torque)])
    tq_new, tw = tint.semi_implicit_euler_rotation(
        h, *[torch.from_numpy(a) for a in (inv_mass, iw, inv_iw, q, omega,
                                           torque)])
    _close(tq_new, jq_new)
    _close(tw, jw, atol=1e-5)       # |ω| ~ 5: 1e-6 relative
    np.testing.assert_array_equal(tq_new.numpy()[::5], q[::5])
    np.testing.assert_array_equal(tw.numpy()[::5], omega[::5])


def test_isotropic_rotation_and_angular_velocity_updates_match_jax():
    rng = np.random.default_rng(3)
    q, old_q, last_q = _unit(rng), _unit(rng), _unit(rng)
    # a small rotation apart, as after one substep
    dq = np.asarray(jq.from_axis_angle(jnp.asarray(_vec(rng) / 2.0),
                                       jnp.full((N,), 0.01)))
    q_new = np.asarray(jq.normalize(jq.multiply(jnp.asarray(dq),
                                                jnp.asarray(old_q))))
    inv_mass = np.where(np.arange(N) % 4 == 0, 0.0, 1.0).astype(np.float32)
    omega = _vec(rng)
    h = 0.001
    j = jint.semi_implicit_euler_rotation_isotropic(
        h, jnp.asarray(inv_mass), jnp.asarray(q), jnp.asarray(omega))
    t = tint.semi_implicit_euler_rotation_isotropic(
        h, torch.from_numpy(inv_mass), torch.from_numpy(q),
        torch.from_numpy(omega))
    _close(t[0], j[0])
    np.testing.assert_array_equal(t[1].numpy(), omega)
    for jf, tf, extra in (
            (jint.angular_velocity_update_first_order,
             tint.angular_velocity_update_first_order, ()),
            (jint.angular_velocity_update_second_order,
             tint.angular_velocity_update_second_order, (last_q,))):
        args = (inv_mass, q_new, old_q) + extra + (omega,)
        jw = jf(h, *[jnp.asarray(a) for a in args])
        tw = tf(h, *[torch.from_numpy(np.array(a)) for a in args])
        _close(tw, jw, atol=2 * ATOL / h)
        np.testing.assert_array_equal(tw.numpy()[::4], omega[::4])


def test_extract_rotation_matches_jax():
    """Müller's iteration warm-started within 0.3 rad of the answer, as a
    shape-matching step starts from the last step's rotation:
    rotation-dominated matrices (a rotation times a stretch near 1). From
    a far start ten passes do not converge, and rounding picks the path."""
    rng = np.random.default_rng(4)
    q_true = _unit(rng, 32)
    r = np.asarray(jq.to_matrix(jnp.asarray(q_true)))
    stretch = np.eye(3) + 0.1 * rng.normal(size=(32, 3, 3))
    a = (r @ stretch).astype(np.float32)
    turn = np.asarray(jq.from_axis_angle(
        jnp.asarray(tq.normalize(torch.from_numpy(_vec(rng, 32))).numpy()),
        jnp.full((32,), 0.3)))
    q0 = np.asarray(jq.multiply(jnp.asarray(turn), jnp.asarray(q_true)))
    j = jax.vmap(jmu.extract_rotation)(jnp.asarray(a), jnp.asarray(q0))
    t = tmu.extract_rotation(torch.from_numpy(a), torch.from_numpy(q0))
    _close(t, j, atol=1e-5)
    # the result is the rotation of R·S up to sign
    rt = tq.to_matrix(t).numpy()
    assert np.abs(np.abs(np.einsum("nij,nij->n", rt, r)) - 3.0).max() < 0.1


def test_solve_shape_matching_matches_jax():
    """A cluster of 6 members moved rigidly and jittered, one member
    static, the warm start within 0.2 rad of the motion (see
    ``test_extract_rotation_matches_jax``): the correction and the
    extracted rotation."""
    rng = np.random.default_rng(5)
    c, k = 16, 6
    x0 = rng.normal(size=(c, k, 3)).astype(np.float32)
    q_move = _unit(rng, c)
    r = np.asarray(jq.to_matrix(jnp.asarray(q_move)))
    x = (np.einsum("cij,ckj->cki", r, x0) + rng.normal(size=(c, 1, 3))
         + 0.05 * rng.normal(size=(c, k, 3))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (c, k)).astype(np.float32)
    w[:, 0] = 0.0
    rest_cm = x0.mean(1).astype(np.float32)
    stiff = rng.uniform(0.2, 1.0, c).astype(np.float32)
    turn = np.asarray(jq.from_axis_angle(
        jnp.asarray(tq.normalize(torch.from_numpy(_vec(rng, c))).numpy()),
        jnp.full((c,), 0.2)))
    q_prev = np.asarray(jq.multiply(jnp.asarray(turn), jnp.asarray(q_move)))
    jc, jqn = jax.vmap(lambda *a: jpbd.solve_shape_matching(
        a[0], a[1], a[2], a[3], None, a[4], a[5]))(
        *[jnp.asarray(v) for v in (x, x0, w, rest_cm, stiff, q_prev)])
    tc, tqn = tpbd.solve_shape_matching(
        *[torch.from_numpy(v) for v in (x, x0, w, rest_cm)], None,
        torch.from_numpy(stiff), torch.from_numpy(q_prev))
    _close(tc, jc, atol=1e-5)
    _close(tqn, jqn, atol=1e-5)
    assert np.all(tc.numpy()[:, 0] == 0.0)


def _box_mesh(half=(0.5, 0.3, 0.2), offset=(0.1, -0.2, 0.3)):
    """A closed, outward-oriented box: 8 corners, 12 triangles."""
    h = np.asarray(half, np.float64)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64) * h + offset
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return corners, np.asarray(faces, np.int32)


def test_massprops_on_a_closed_box_equal_jax():
    rng = np.random.default_rng(6)
    verts, faces = _box_mesh()
    r = np.asarray(jnpq.to_matrix(rng.normal(size=4) / 2.0 + [1, 0, 0, 0]))
    r = np.linalg.qr(r)[0]
    verts = verts @ r.T
    jm = jmass.mass_properties(verts, faces, density=3.0)
    tm = tmass.mass_properties(verts, faces, density=3.0)
    assert jm[0] == tm[0]
    np.testing.assert_array_equal(jm[1], tm[1])
    np.testing.assert_array_equal(jm[2], tm[2])
    # the box's exact mass: 8·0.5·0.3·0.2 at density 3
    assert abs(tm[0] - 3.0 * 8 * 0.5 * 0.3 * 0.2) < 1e-12
    for a, b in zip(jmass.principal_frame(jm[2]),
                    tmass.principal_frame(tm[2])):
        np.testing.assert_array_equal(a, b)


def test_npquat_helpers_equal_jax():
    rng = np.random.default_rng(7)
    q0 = rng.normal(size=(8, 4))
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    q1 = rng.normal(size=(8, 4))
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    d = rng.normal(size=(8, 3))
    d[0] = (0.0, 1.0, 0.0)       # the basis switches branch near (1, 0, 0)
    d[1] = (1.0, 0.0, 0.0)
    for name, args in (("multiply", (q0, q1)), ("conjugate", (q0,)),
                       ("normalize", (q0 * 3.0,)), ("to_matrix", (q0,)),
                       ("rotate", (q0, d)), ("mat_q", (q0,)),
                       ("mat_qhat", (q0,)), ("orthonormal_basis", (d,))):
        np.testing.assert_array_equal(getattr(tnpq, name)(*args),
                                      getattr(jnpq, name)(*args), name)
    mats = jnpq.to_matrix(q0)
    mats[2] = np.diag([1.0, -1.0, -1.0])     # trace < 0 branches
    mats[3] = np.diag([-1.0, 1.0, -1.0])
    mats[4] = np.diag([-1.0, -1.0, 1.0])
    np.testing.assert_array_equal(tnpq.from_matrix(mats),
                                  jnpq.from_matrix(mats))
    for i in range(8):
        for rows in (2, 3):
            np.testing.assert_array_equal(
                tnpq.rotational_projection(q0[i], q1[i], d[i], rows),
                jnpq.rotational_projection(q0[i], q1[i], d[i], rows))
