"""The tet step's two modes (``make_tet_step(fuse_substeps=True)``, one
cooperative launch a step, and ``fuse_substeps=False``, one launch an
iteration) on the CPU, where both run the plain PyTorch version, against
the JAX package's ``make_pallas_tet_step`` in interpret mode, as
``tests/test_grid_tet_pallas.py`` runs it. The multi-substep kernel itself
is held against the per-iteration kernel and the plain version on the card
(``chip_smoke.py`` phase 14 and ``tests/test_torch_kernel_card.py``).

Tolerance 1e-5 over 3 steps: the Pallas kernel computes the same float32
math in another order, and at two iterations the reference's own λ update
breaks the bar down only after step 5 (``tests/test_torch_tet_step.py``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver.grid_tet_pallas import (
    make_pallas_tet_step)
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc
from positionbaseddynamics_tpu_torch.solver.grid_tet import GridTetBatch

N_STEPS = 3
TOL = 1e-5


def _build(builder, dims, **build_kw):
    b = builder()
    tm = b.add_regular_tet_model(*dims, scale=(2.0, 0.5, 0.5))
    for j in range(dims[1]):
        for k in range(dims[2]):
            b.set_mass(tm.offset + j * dims[2] + k, 0.0)
    b.add_solid_constraints(tm, method=3, stiffness=1e5, poisson_ratio=0.3)
    return b.build(**build_kw)


def _start(dims):
    """A seeded start: every free vertex moved up to 1 cm and moving up to
    0.1 m/s, so that every tet is strained from the first substep."""
    rng = np.random.default_rng(7)
    n = dims[0] * dims[1] * dims[2]
    free = np.arange(n) >= dims[1] * dims[2]
    dx = np.where(free[:, None], 0.01 * rng.standard_normal((n, 3)), 0.0)
    v = np.where(free[:, None], 0.1 * rng.standard_normal((n, 3)), 0.0)
    return dx.astype(np.float32), v.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_result(dims, iters):
    js, jc = _build(JBuilder, dims)
    dx, v = _start(dims)
    step = make_pallas_tet_step(jc.grid_tets[0], js.particles.inv_mass,
                                dt=0.005, substeps=5, max_iterations=iters,
                                n_steps=N_STEPS)
    x, v = jax.block_until_ready(step(js.particles.x + dx, v))
    return np.asarray(x), np.asarray(v)


def _torch_result(dims, iters, fuse):
    ts, tc = _build(TBuilder, dims, device="cpu")
    dx, v = _start(dims)
    p = ts.particles
    step = gtc.make_tet_step(tc.grid_tets[0], p.inv_mass, dt=0.005,
                             substeps=5, max_iterations=iters,
                             n_steps=N_STEPS, fuse_substeps=fuse,
                             device="cpu")
    return step(p.x + torch.from_numpy(dx), torch.from_numpy(v))


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per_iteration"])
@pytest.mark.parametrize("iters", [1, 2], ids=["it1", "it2"])
@pytest.mark.parametrize("dims", [(7, 4, 5), (10, 4, 4)],
                         ids=["7x4x5", "10x4x4"])
def test_tet_step_modes_match_the_pallas_kernel(dims, iters, fuse):
    xj, vj = _jax_result(dims, iters)
    x, v = _torch_result(dims, iters, fuse)
    assert torch.isfinite(x).all() and torch.isfinite(v).all()
    np.testing.assert_allclose(x.numpy(), xj, atol=TOL)
    n_pin = dims[1] * dims[2]
    assert np.array_equal(x.numpy()[:n_pin], xj[:n_pin])


@pytest.mark.parametrize("iters,damping", [(1, 0.0), (2, 0.01)],
                         ids=["it1", "it2_damped"])
def test_tet_step_modes_are_equal_on_the_cpu(iters, damping):
    """On the CPU both modes run the plain substep ``n_steps·substeps``
    times: their results are equal bit for bit."""
    dims = (7, 4, 5)
    ts, tc = _build(TBuilder, dims, device="cpu")
    p = ts.particles
    out = [gtc.make_tet_step(tc.grid_tets[0], p.inv_mass, dt=0.005,
                             substeps=5, max_iterations=iters,
                             damping=damping, n_steps=2, fuse_substeps=fuse,
                             device="cpu")(p.x, p.v)
           for fuse in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_fused_is_the_default():
    """``make_tet_step`` fuses unless told not to, as the TPU kernel always
    does: its default is the multi-substep mode."""
    import inspect

    sig = inspect.signature(gtc.make_tet_step)
    assert sig.parameters["fuse_substeps"].default is True


def _plain_batch(offset=0, inversion=False):
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_tet_grid)

    x0, _ = regular_tet_grid(5, 3, 4)
    x0 = np.concatenate([np.zeros((offset, 3), np.float32), x0])
    return GridTetBatch.create(5, 3, 4, offset, x0, 1e5, 0.3,
                               inversion_handling=inversion, device="cpu")


def test_fused_wrapper_refuses_cpu_tensors():
    b = _plain_batch()
    xp = torch.zeros(3, 60)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gtc.tet_fused_cuda(xp, xp.clone(), torch.ones(60), torch.ones(60),
                           gtc.kernel_params(b, h=1e-3), (5, 3, 4), 1, 5)
    assert gtc.tet_fused_cuda.launches == 0


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per_iteration"])
@pytest.mark.parametrize("kw,err", [
    (dict(offset=3), NotImplementedError),
    (dict(inversion=True), NotImplementedError),
    (dict(max_iterations=0), ValueError)],
    ids=["offset", "inversion_handling", "no_iteration"])
def test_refusals_are_the_same_in_both_modes(kw, err, fuse):
    """Offset ≠ 0 and ``inversion_handling`` are refused as JAX refuses them
    (``grid_tet_pallas.py:57-62``), and no iteration at all, whichever the
    mode."""
    kw = dict(kw)
    iters = kw.pop("max_iterations", 1)
    b = _plain_batch(**kw)
    with pytest.raises(err):
        gtc.make_tet_step(b, np.ones(60 + 3 * ("offset" in kw)), dt=0.005,
                          substeps=5, max_iterations=iters,
                          fuse_substeps=fuse, device="cpu")


@pytest.mark.parametrize("substeps,iters,want", [
    (1, 1, (False, False, False, False, False)),
    (5, 1, (True, True, False, False, False)),
    (1, 2, (True, False, True, True, False)),
    (5, 3, (True, True, True, True, True))],
    ids=["one_pass", "bench_step", "one_substep_it2", "it3"])
def test_fused_scratch_holds_what_the_launch_needs(substeps, iters, want):
    """The launch's scratch: positions past one pass, velocities past one
    substep, start positions and a λ plane past one iteration, a second λ
    plane past two; allocated once for a shape and kept."""
    xp = torch.zeros(2, 3, 60)
    scratch = gtc.FusedScratch()
    bufs = scratch.get(xp, 24, substeps, iters)
    assert tuple(b is not None for b in bufs) == want
    for b, shape in zip(bufs, [(2, 3, 60)] * 3 + [(2, 5, 24)] * 2):
        assert b is None or tuple(b.shape) == shape
    again = scratch.get(xp, 24, substeps, iters)
    assert all(a is b for a, b in zip(bufs, again))
    other = scratch.get(torch.zeros(3, 60), 24, substeps, iters)
    assert want[0] == (other[0] is not None)
    assert other[0] is None or tuple(other[0].shape) == (3, 60)
