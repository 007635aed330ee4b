"""The port's SPH kernel (fluids/sph.py) and hash neighbor search
(fluids/neighborhood.py) against the JAX package on the same seeded
inputs.

Tolerances: the kernel functions within 1e-6 relative (float32 math in
the same order; XLA may contract into FMAs); the neighbor candidates as
sets, exactly, against JAX and against a brute-force search; the
overflow counter exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.fluids import neighborhood as jnb
from positionbaseddynamics_tpu.fluids import sph as jsph
from positionbaseddynamics_tpu_torch.fluids import neighborhood as tnb
from positionbaseddynamics_tpu_torch.fluids import sph as tsph

H = 0.1


def _rvecs(seed=0, n=4000):
    """Displacements spanning r = 0, tiny r, q near 1/2, q near 1 and
    beyond the support."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.concatenate([rng.uniform(0.0, 1.3 * H, n - 40),
                        np.full(10, 0.5 * H), np.full(10, H),
                        np.full(10, 1e-7), np.zeros(10)])
    return (d * r[:, None]).astype(np.float32)


def _close(a, b, rtol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


@pytest.mark.parametrize("fn", ["w", "grad_w"])
def test_kernel_of_vectors_matches_jax(fn):
    rv = _rvecs()
    _close(getattr(tsph, fn)(torch.tensor(rv), H).numpy(),
           getattr(jsph, fn)(jnp.asarray(rv), H))


@pytest.mark.parametrize("fn", ["w_r", "grad_w_coef"])
def test_kernel_of_distances_matches_jax(fn):
    rl = np.linalg.norm(_rvecs(1), axis=1).astype(np.float32)
    _close(getattr(tsph, fn)(torch.tensor(rl), H).numpy(),
           getattr(jsph, fn)(jnp.asarray(rl), H))


def test_w_zero_matches_jax():
    assert tsph.w_zero(H).item() == float(jsph.w_zero(H))
    assert tsph.w_zero(0.037).dtype == torch.float32


def test_sqrt_is_correctly_rounded_on_cpu():
    a = np.random.default_rng(2).uniform(0, 4, 10000).astype(np.float32)
    np.testing.assert_array_equal(tsph.sqrt(torch.tensor(a)).numpy(),
                                  np.sqrt(a))


def _cloud(seed, n=700, extent=0.6):
    """Points in a box, some on exact cell faces and some at negative
    coordinates (the hash's mirror-image collisions)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-extent / 2, extent, size=(n, 3))
    x[:40] = np.round(x[:40] / H) * H
    return x.astype(np.float32)


def _sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [set(idx[i][valid[i]].tolist()) for i in range(idx.shape[0])]


@pytest.mark.parametrize("seed,cap", [(0, 48), (1, 12)])
def test_neighbor_candidates_match_jax_as_sets(seed, cap):
    x = _cloud(seed)
    it, vt = tnb.neighbor_candidates(torch.tensor(x), H, cap)
    ij, vj = jnb.neighbor_candidates(jnp.asarray(x), H, cap)
    assert tuple(it.shape) == tuple(ij.shape)
    assert _sets(it, vt) == _sets(ij, vj)


def test_neighbor_candidates_match_brute_force():
    x = _cloud(3)
    idx, valid = tnb.neighbor_candidates(torch.tensor(x), H, 64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = [set(np.nonzero((d2[i] < H * H)
                           & (np.arange(len(x)) != i))[0].tolist())
            for i in range(len(x))]
    got = _sets(idx, valid)
    # brute force in float64 and the float32 sum may disagree only on
    # pairs at the edge of the support
    for i in range(len(x)):
        for j in got[i] ^ want[i]:
            assert abs(np.sqrt(d2[i, j]) - H) < 1e-6
    assert sum(len(s) for s in got) > 2 * len(x)


@pytest.mark.parametrize("cap", [1, 3, 12])
def test_cell_overflow_matches_jax(cap):
    x = _cloud(4, n=900, extent=0.4)
    got = tnb.cell_overflow(torch.tensor(x), H, cap).item()
    assert got == int(jnb.cell_overflow(jnp.asarray(x), H, cap))
    if cap == 1:
        assert got > 0
