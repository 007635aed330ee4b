"""The port's fused cloth step (solver/grid_cloth_cuda.py) on the CPU,
where it runs its plain PyTorch version, against the JAX package's
``make_pallas_cloth_step`` in interpret mode, as
``tests/test_grid_cloth_pallas.py`` runs it. The CUDA kernel itself is
held against the plain version on the card (``chip_smoke.py`` and
``tests/test_torch_kernel_card.py``).

Tolerances: 2e-5 against the Pallas kernel, the JAX package's own bar for
its kernel against its stencil path over 25 steps (the two compute the
same float32 math in another order); 1e-6 between a batch's rollouts and
the single-rollout run, which share every operation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver import grid_cloth_pallas as jpl
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
from positionbaseddynamics_tpu_torch.solver.grid_cloth import GridClothBatch
from positionbaseddynamics_tpu_torch.utils import telemetry


def _build(builder, n, m=None, **build_kw):
    m = n if m is None else m
    b = builder()
    tm = b.add_regular_triangle_model(n, m, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + n - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(**build_kw)


def _steps(n, substeps, **kw):
    js, jc = _build(JBuilder, n)
    ts, tc = _build(TBuilder, n, device="cpu")
    jg, tg = jc.grid_cloths[0], tc.grid_cloths[0]
    jstep = jpl.make_pallas_cloth_step(
        jg, js.particles.inv_mass, jg.inv_cnt_dist, jg.inv_cnt_bend,
        dt=0.005, substeps=substeps, **kw)
    tstep = gcc.make_cloth_step(
        tg, ts.particles.inv_mass, tg.inv_cnt_dist, tg.inv_cnt_bend,
        dt=0.005, substeps=substeps, device="cpu", **kw)
    return js, ts, jstep, tstep


def test_cloth_step_matches_pallas_kernel():
    js, ts, jstep, tstep = _steps(24, 5)
    xj, vj = js.particles.x, js.particles.v
    xt, vt = ts.particles.x, ts.particles.v
    for _ in range(25):
        xj, vj = jstep(xj, vj)
        xt, vt = tstep(xt, vt)
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5)
    np.testing.assert_array_equal(xt.numpy()[[0, 23]],
                                  ts.particles.x.numpy()[[0, 23]])


def test_cloth_step_batched():
    js, ts, jstep, tstep = _steps(16, 3, n_batch=3)
    _, _, _, tstep1 = _steps(16, 3)
    x1 = np.asarray(js.particles.x)
    xs = np.stack([x1, x1, x1 + 0.001])
    xj, vj = jnp.asarray(xs), jnp.zeros(xs.shape, jnp.float32)
    xt, vt = torch.tensor(xs), torch.zeros(xs.shape)
    x1t, v1t = ts.particles.x, ts.particles.v
    for _ in range(8):
        xj, vj = jstep(xj, vj)
        xt, vt = tstep(xt, vt)
        x1t, v1t = tstep1(x1t, v1t)
    assert torch.isfinite(xt).all()
    np.testing.assert_allclose(xt[0].numpy(), x1t.numpy(), atol=1e-6)
    np.testing.assert_allclose(xt[1].numpy(), x1t.numpy(), atol=1e-6)
    assert (xt[2] - x1t).abs().max() > 1e-5       # the perturbed one moved
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5)


def test_kernel_params_match_pallas_scalars():
    """The kernel's host-side scalars are the TPU kernel's."""
    js, jc = _build(JBuilder, 19, 14)
    ts, tc = _build(TBuilder, 19, 14, device="cpu")
    jg, tg = jc.grid_cloths[0], tc.grid_cloths[0]
    p = gcc.kernel_params(tg, h=0.001, damping=0.01)
    assert p.dtype == np.float32 and p.shape == (gcc.N_PARAMS,)
    np.testing.assert_array_equal(
        p[0:3], np.float32([jpl._family_rest(jg, f) for f in "hvd"]))
    svec = [jpl._family_svec(jg, f) for f in ("bh", "bv", "bd")]
    np.testing.assert_allclose(p[6:18], np.ravel([s[0] for s in svec]),
                               rtol=1e-6)
    np.testing.assert_allclose(p[18:30], np.ravel([s[1] for s in svec]),
                               rtol=1e-6)
    np.testing.assert_allclose(p[3:6], 1.0 / (1e5 * 1e-6), rtol=1e-6)
    np.testing.assert_allclose(p[30:33], 1.0 / (0.05 * 1e-6), rtol=1e-6)
    np.testing.assert_allclose(p[33:38], [1e-3, 0.0, -9.81, 0.0, 0.99],
                               rtol=1e-6)
    assert p[38] == 1.0


def _batch(jitter=False, xpbd=True, offset=0):
    from positionbaseddynamics_tpu_torch.models.builders import (
        regular_triangle_grid)

    x0, _ = regular_triangle_grid(9, 7)
    if jitter:
        x0 = x0 + np.random.default_rng(0).normal(0, 0.01, x0.shape)
    x0 = np.concatenate([np.zeros((offset, 3)), x0])
    return GridClothBatch.create(7, 9, offset, x0, 1e4, 0.05,
                                 xpbd_distance=xpbd, xpbd_bending=xpbd,
                                 device="cpu")


@pytest.mark.parametrize("kw", [dict(jitter=True), dict(xpbd=False),
                                dict(offset=4)],
                         ids=["nonuniform", "classic", "offset"])
def test_unsupported_batches_raise(kw):
    b = _batch(**kw)
    assert gcc.unsupported_reason(b) is not None
    with pytest.raises(NotImplementedError):
        gcc.make_cloth_step(b, np.ones(63), b.inv_cnt_dist, b.inv_cnt_bend,
                            dt=0.005, substeps=5, device="cpu")


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = _batch()
    _, tc = _build(TBuilder, 6, device="cpu")
    with pytest.raises(RuntimeError):
        gcc.make_cloth_step(b, np.ones(63), b.inv_cnt_dist, b.inv_cnt_bend,
                            dt=0.005, substeps=5)
    with pytest.raises(RuntimeError):
        make_step_fn(tc, StepConfig())


def test_make_step_fn_on_cpu_takes_the_stencil_path():
    ts, tc = _build(TBuilder, 8, device="cpu")
    fn = make_step_fn(tc, StepConfig(), device="cpu")
    assert fn.path == "torch_stencil"
    out = fn(ts)
    assert torch.isfinite(out.particles.x).all()
    assert telemetry.launches("cloth_substep") == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    b = _batch()
    xp = torch.zeros(1, 3, 7, 9)
    with pytest.raises(ValueError):
        gcc.cloth_substep_cuda(xp, xp.clone(), torch.ones(7, 9),
                               torch.ones(7, 9), torch.ones(7, 9),
                               gcc.kernel_params(b, h=1e-3))
