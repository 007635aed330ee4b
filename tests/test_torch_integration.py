"""The port's integration functions (ops/integration.py) against the JAX
package's, on the same seeded inputs with pinned entries. Tolerance 1e-6:
the same float32 arithmetic on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.ops import integration as jint
from positionbaseddynamics_tpu_torch.ops import integration as tint

ATOL = 1e-6


def _inputs(seed, lead=()):
    rng = np.random.default_rng(seed)
    n = 37
    shape = lead + (n, 3)
    arrs = {k: rng.normal(size=shape).astype(np.float32)
            for k in ("x", "v", "old_x", "last_x", "a")}
    inv_mass = rng.uniform(0.5, 2.0, lead + (n,)).astype(np.float32)
    inv_mass[..., ::5] = 0.0                      # pinned entries
    arrs["inv_mass"] = inv_mass
    return arrs


def _both(arrs, *names):
    return ([jnp.asarray(arrs[k]) for k in names],
            [torch.from_numpy(arrs[k]) for k in names])


@pytest.mark.parametrize("lead", [(), (3,)])
def test_semi_implicit_euler_matches_jax(lead):
    arrs = _inputs(0, lead)
    j, t = _both(arrs, "inv_mass", "x", "v", "a")
    xj, vj = jint.semi_implicit_euler(0.001, *j)
    xt, vt = tint.semi_implicit_euler(0.001, *t)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    pinned = arrs["inv_mass"] == 0.0
    np.testing.assert_array_equal(xt.numpy()[pinned], arrs["x"][pinned])
    np.testing.assert_array_equal(vt.numpy()[pinned], arrs["v"][pinned])


@pytest.mark.parametrize("lead", [(), (2,)])
def test_velocity_update_first_order_matches_jax(lead):
    arrs = _inputs(1, lead)
    j, t = _both(arrs, "inv_mass", "x", "old_x", "v")
    vj = jint.velocity_update_first_order(0.001, *j)
    vt = tint.velocity_update_first_order(0.001, *t)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    pinned = arrs["inv_mass"] == 0.0
    np.testing.assert_array_equal(vt.numpy()[pinned], arrs["v"][pinned])


@pytest.mark.parametrize("lead", [(), (2,)])
def test_velocity_update_second_order_matches_jax(lead):
    arrs = _inputs(2, lead)
    j, t = _both(arrs, "inv_mass", "x", "old_x", "last_x", "v")
    vj = jint.velocity_update_second_order(0.001, *j)
    vt = tint.velocity_update_second_order(0.001, *t)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    pinned = arrs["inv_mass"] == 0.0
    np.testing.assert_array_equal(vt.numpy()[pinned], arrs["v"][pinned])
