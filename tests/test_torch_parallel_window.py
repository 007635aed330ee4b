"""The cloth kernel's fused-substep and row-window modes
(``solver/grid_cloth_cuda.py``) on the CPU, where they run their plain
versions, against the JAX package's ``make_pallas_cloth_step`` in
interpret mode: ``fuse_substeps=True`` on the whole grid, and its
``height_override``/``global_height``/``external_params`` call on each of 4
row windows of a jittered, moving cloth; then ``parallel/intra_cuda.py``'s
plain route on a gloo group of 4 CPU processes against
``make_pallas_intra_step_fn`` on 4 virtual devices, as
``tests/test_intra_sharding.py`` runs it. The CUDA kernel is held against
the same plain versions on the card (``tests/test_torch_parallel_cuda.py``,
``chip_smoke.py``).

Tolerances: x 2e-5, the JAX package's bar for its kernel against its
stencil path (the two add in other orders); v 2e-2 on the windows, whose
random start velocities make v = Δx/h carry 1/h = 1000 times x's
rounding; the sharded run x 1e-6 and v 1e-4, JAX's bars for its sharded
kernel against its unsharded one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.parallel.intra_pallas import (
    make_pallas_intra_step_fn)
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver import grid_cloth_pallas as jpl
from positionbaseddynamics_tpu_torch import parallel as par
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig
from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

N, SUBSTEPS = 24, 2


def _scenes(n=N):
    js, jc = ranks.grid_cloth(JBuilder, n)
    ts, tc = ranks.grid_cloth(TBuilder, n, device="cpu")
    return js, jc.grid_cloths[0], ts, tc.grid_cloths[0]


@pytest.mark.parametrize("iters", [1, 2])
def test_fused_matches_pallas_fused(iters):
    js, jg, ts, tg = _scenes()
    kw = dict(dt=ranks.DT, substeps=SUBSTEPS, max_iterations=iters,
              fuse_substeps=True)
    jstep = jpl.make_pallas_cloth_step(
        jg, js.particles.inv_mass, jg.inv_cnt_dist, jg.inv_cnt_bend, **kw)
    tstep = gcc.make_cloth_step(
        tg, ts.particles.inv_mass, tg.inv_cnt_dist, tg.inv_cnt_bend,
        device="cpu", **kw)
    xj, vj = js.particles.x, js.particles.v
    xt, vt = ts.particles.x, ts.particles.v
    for _ in range(10):
        xj, vj = jstep(xj, vj)
        xt, vt = tstep(xt, vt)
    assert torch.isfinite(xt).all()
    assert (xt - ts.particles.x).abs().max() > 1e-3
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5)


def test_windows_match_pallas_window_mode():
    """Four windows of 6 + 2·8 rows cut from a jittered, moving 24×24 cloth
    at offsets 6r − 8, each stepped by both packages' window mode; every
    row of each window is compared, the zero margins included."""
    js, jg, ts, tg = _scenes()
    r_loc, exch = N // 4, 8
    rows = r_loc + 2 * exch
    kw = dict(dt=ranks.DT, substeps=SUBSTEPS, fuse_substeps=True,
              height_override=rows, global_height=N, external_params=True)
    jstep = jpl.make_pallas_cloth_step(jg, js.particles.inv_mass, None, None,
                                       **kw)
    tstep = gcc.make_cloth_step(tg, None, None, None, device="cpu", **kw)
    rng = np.random.default_rng(7)
    grid = {"x": np.asarray(js.particles.x).reshape(N, N, 3)
            + rng.normal(0.0, 0.01, (N, N, 3)).astype(np.float32),
            "v": rng.normal(0.0, 0.1, (N, N, 3)).astype(np.float32),
            "w": np.asarray(js.particles.inv_mass).reshape(N, N),
            "icd": np.asarray(jg.inv_cnt_dist).reshape(N, N),
            "icb": np.asarray(jg.inv_cnt_bend).reshape(N, N)}

    def cut(a, off):
        out = np.zeros((rows,) + a.shape[1:], np.float32)
        lo, hi = max(off, 0), min(off + rows, N)
        out[lo - off:hi - off] = a[lo:hi]
        return out

    for r in range(4):
        off = r * r_loc - exch
        x, v, w, icd, icb = (cut(grid[k], off)
                             for k in ("x", "v", "w", "icd", "icb"))
        xj, vj = jstep(jnp.asarray(x.reshape(-1, 3)),
                       jnp.asarray(v.reshape(-1, 3)), jnp.asarray(w.ravel()),
                       jnp.asarray(icd.ravel()), jnp.asarray(icb.ravel()),
                       jnp.int32(off))
        xt, vt = tstep(torch.tensor(x.reshape(-1, 3)),
                       torch.tensor(v.reshape(-1, 3)), w.ravel(),
                       icd.ravel(), icb.ravel(), off)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=2e-2)


def test_cuda_intra_plain_route_matches_pallas_sharded(tmp_path):
    out = ranks.run_ranks("cuda_plain", 4, tmp_path)
    state, cset = ranks.grid_cloth(JBuilder, 48)
    gc = cset.grid_cloths[0]
    cfg = JConfig(dt=ranks.DT, substeps=2, max_iterations=1)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("scene",))
    fn = make_pallas_intra_step_fn(gc, state.particles.inv_mass, cfg, mesh)
    x, v = state.particles.x, state.particles.v
    for _ in range(5):
        x, v = fn(x, v)
    assert np.abs(out["x"] - np.asarray(state.particles.x)).max() > 1e-3
    np.testing.assert_allclose(out["x"], np.asarray(x), atol=1e-6)
    np.testing.assert_allclose(out["v"], np.asarray(v), atol=1e-4)


@pytest.mark.parametrize("rows,substeps,why", [
    (50, 2, "divide"), (44, 2, "even"), (24, 5, "cover the halo")])
def test_cuda_intra_refusals(rows, substeps, why, monkeypatch):
    """JAX's refusals (``intra_pallas.py:58-70``) on 4 ranks: rows that do
    not divide, odd blocks, blocks under the halo."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    b = TBuilder()
    tm = b.add_regular_triangle_model(8, rows)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    state, cset = b.build(device="cpu")
    with pytest.raises(NotImplementedError, match=why):
        par.make_cuda_intra_step_fn(cset.grid_cloths[0],
                                    state.particles.inv_mass,
                                    StepConfig(substeps=substeps), None,
                                    device="cpu")


def test_fused_refuses_a_substep_past_one_launch():
    _, _, ts, tg = _scenes(8)
    assert gcc.fused_split(5, 1) == [5]
    assert gcc.fused_split(5, 2) == [2, 2, 1]
    with pytest.raises(NotImplementedError, match="fuse_substeps=False"):
        gcc.make_cloth_step(tg, ts.particles.inv_mass, tg.inv_cnt_dist,
                            tg.inv_cnt_bend, dt=ranks.DT, substeps=5,
                            max_iterations=gcc.FUSED_PASSES + 1,
                            fuse_substeps=True, device="cpu")


def test_window_wrappers_refuse_cpu_tensors():
    _, _, ts, tg = _scenes(8)
    p = gcc.kernel_params(tg, h=1e-3)
    xp = torch.zeros(1, 3, 8, 8)
    one = torch.ones(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gcc.cloth_fused_cuda(xp, xp.clone(), one, one, one, p, 1, 5)
    with pytest.raises(ValueError, match="CUDA"):
        gcc.cloth_window_cuda(xp, xp.clone(), one, one, one, p, 1, 5, -2, 16)
