"""The port's fused tet step (solver/grid_tet_cuda.py) on the CPU, where it
runs its plain PyTorch version, against the JAX package's
``make_pallas_tet_step`` in interpret mode, as
``tests/test_grid_tet_pallas.py`` runs it. The CUDA kernel itself is held
against the plain version on the card (``chip_smoke.py`` and
``tests/test_torch_kernel_card.py``).

Tolerances: 2e-5 against the Pallas kernel over 20 steps, the JAX
package's own bar for that kernel against its stencil path
(``tests/test_grid_tet_pallas.py``): the two compute the same float32 math
in another order. The plain version against the port's stepper: equal,
since both run the same operations."""
import jax
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver.grid_tet_pallas import (
    make_pallas_tet_step)
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc
from positionbaseddynamics_tpu_torch.solver.grid_tet import GridTetBatch

DIMS = (10, 6, 6)


def _build(builder, dims=DIMS, stiffness=1e5, **build_kw):
    b = builder()
    tm = b.add_regular_tet_model(*dims, scale=(2.0, 0.5, 0.5))
    for j in range(dims[1]):
        for k in range(dims[2]):
            b.set_mass(tm.offset + j * dims[2] + k, 0.0)
    b.add_solid_constraints(tm, method=3, stiffness=stiffness,
                            poisson_ratio=0.3)
    return b.build(**build_kw)


def test_tet_step_matches_pallas_kernel():
    js, jc = _build(JBuilder)
    ts, tc = _build(TBuilder, device="cpu")
    jstep = make_pallas_tet_step(jc.grid_tets[0], js.particles.inv_mass,
                                 dt=0.005, substeps=5, n_steps=20)
    tstep = gtc.make_tet_step(tc.grid_tets[0], ts.particles.inv_mass,
                              dt=0.005, substeps=5, n_steps=20, device="cpu")
    xj, _ = jax.block_until_ready(jstep(js.particles.x, js.particles.v))
    xt, vt = tstep(ts.particles.x, ts.particles.v)
    assert torch.isfinite(xt).all() and torch.isfinite(vt).all()
    x0 = ts.particles.x.numpy()
    assert np.abs(xt.numpy() - x0).max() > 1e-3          # the bar sagged
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5)
    n_pin = DIMS[1] * DIMS[2]
    np.testing.assert_array_equal(xt.numpy()[:n_pin], x0[:n_pin])


@pytest.mark.parametrize("cfg", [
    StepConfig(), StepConfig(max_iterations=3, damping=0.01)],
    ids=["default", "iterations3_damping"])
def test_plain_version_equals_the_stepper(cfg):
    """The plain substep, stepped by ``make_tet_step``, is the stepper's
    substep for a scene that is the tet grid alone."""
    ts, tc = _build(TBuilder, dims=(7, 4, 5), device="cpu")
    gt, p = tc.grid_tets[0], ts.particles
    step = gtc.make_tet_step(gt, p.inv_mass, dt=cfg.dt,
                             substeps=cfg.substeps,
                             max_iterations=cfg.max_iterations,
                             damping=cfg.damping, n_steps=2, device="cpu")
    x, v = step(p.x, p.v)
    fn = make_step_fn(tc, cfg, device="cpu")
    s = fn(fn(ts))
    assert torch.equal(x, s.particles.x) and torch.equal(v, s.particles.v)


def test_zero_stiffness_is_free_fall():
    """Stiffness 0 disables the solve: the substep is the integration and
    the velocity update alone, bit for bit."""
    from positionbaseddynamics_tpu_torch.ops import integration

    ts, tc = _build(TBuilder, dims=(5, 3, 4), stiffness=0.0, device="cpu")
    gt, p = tc.grid_tets[0], ts.particles
    x, v = gtc.tet_substep_reference(gt, p.x, p.v, p.inv_mass, h=1e-3)
    g = torch.tensor([0.0, -9.81, 0.0]).expand_as(p.x)
    xi, vi = integration.semi_implicit_euler(1e-3, p.inv_mass, p.x, p.v, g)
    assert torch.equal(x, xi)
    assert torch.equal(v, integration.velocity_update_first_order(
        1e-3, p.inv_mass, xi, p.x, vi))
    assert not torch.equal(x, p.x)


def test_kernel_params_match_hand_values():
    _, tc = _build(TBuilder, device="cpu")
    gt = tc.grid_tets[0]
    p = gtc.kernel_params(gt, h=1e-3, gravity=(0.5, -9.81, 0.25),
                          damping=0.01)
    assert p.dtype == np.float32 and p.shape == (gtc.N_PARAMS,)
    np.testing.assert_array_equal(p[0:45], gt.inv_rest_even.numpy().ravel())
    np.testing.assert_array_equal(p[45:90], gt.inv_rest_odd.numpy().ravel())
    np.testing.assert_array_equal(p[90:95], gt.rest_vol_even.numpy())
    np.testing.assert_array_equal(p[95:100], gt.rest_vol_odd.numpy())
    mu, lame = 0.5 / 1.3, 0.3 / (1.3 * 0.4)
    np.testing.assert_allclose(p[100:104], [mu, lame, 2 * mu, lame / 2],
                               rtol=1e-6)
    # the same float32 values the plain version computes
    tmu, tlame = gt.lame_parameters()
    assert p[100] == tmu.item() and p[101] == tlame.item()
    np.testing.assert_allclose(p[104], 1.0 / (1e5 * 1e-6), rtol=1e-6)
    assert p[105] == 1.0
    np.testing.assert_allclose(p[106:111], [1e-3, 0.5, -9.81, 0.25, 0.99],
                               rtol=1e-6)
    assert p[111] == 1.0
    # stiffness 0 switches the solve off; no damping switches it off
    off = gtc.kernel_params(_plain_batch(stiffness=0.0), h=1e-3)
    assert off[104] == 0.0 and off[105] == 0.0 and off[111] == 0.0


def _plain_batch(offset=0, inversion=False, stiffness=1e5):
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_tet_grid)

    x0, _ = regular_tet_grid(5, 3, 4)
    x0 = np.concatenate([np.zeros((offset, 3), np.float32), x0])
    return GridTetBatch.create(5, 3, 4, offset, x0, stiffness, 0.3,
                               inversion_handling=inversion, device="cpu")


@pytest.mark.parametrize("kw", [dict(offset=3), dict(inversion=True)],
                         ids=["offset", "inversion_handling"])
def test_unsupported_batches_raise(kw):
    b = _plain_batch(**kw)
    assert gtc.unsupported_reason(b) is not None
    with pytest.raises(NotImplementedError):
        gtc.make_tet_step(b, np.ones(60), dt=0.005, substeps=5,
                          device="cpu")


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = _plain_batch()
    with pytest.raises(RuntimeError):
        gtc.make_tet_step(b, np.ones(60), dt=0.005, substeps=5)


def test_kernel_wrapper_refuses_cpu_tensors():
    b = _plain_batch()
    xp = torch.zeros(3, 60)
    with pytest.raises(ValueError):
        gtc.tet_substep_cuda(xp, xp.clone(), torch.ones(60), torch.ones(60),
                             gtc.kernel_params(b, h=1e-3), (5, 3, 4))


def test_planes_round_trip():
    x = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    p = gtc.to_planes(x)
    assert p.shape == (3, 10) and p.is_contiguous()
    assert torch.equal(p[1], x[:, 1])
    assert torch.equal(gtc.from_planes(p), x)


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5])
def test_lambda_plan_reads_what_the_launch_before_wrote(iters):
    """λ starts at 0 (the first launch reads no plane), the last launch
    writes none, and no launch reads the plane it writes: a block solves
    halo cells again whose λ another block may read."""
    plan = gtc.lambda_plan(iters)
    assert len(plan) == iters
    assert plan[0][0] is None and plan[-1][1] is None
    for (_, wrote), (read, write) in zip(plan, plan[1:]):
        assert read == wrote is not None
        assert read != write
    assert {p for rw in plan for p in rw} <= {None, 0, 1}
