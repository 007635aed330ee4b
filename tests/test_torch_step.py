"""The port's stepper (solver/step.py) against the JAX package's
``rollout`` on a 32×32 cut of the bench cloth (two pinned corners, XPBD
distance 1e5, XPBD isometric bending 0.05).

Tolerances: positions (``x``, ``old_x``, ``last_x``) to 1e-5, the repo's
kernel-against-stencil bar (``bench.py --check``). Both sides run the same
float32 arithmetic, but the JAX side is compiled by XLA, which contracts
products and sums into FMAs, so the two differ by an ulp at the first
substep and the stiff cloth amplifies that over the rollout. A velocity is
a position difference over the substep ``h``, so it is held to 2e-5 / h.
``time`` is a float32 sum of ``dt`` on both sides and must agree to 1e-7.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu.solver import rollout as jrollout
from positionbaseddynamics_tpu_torch import convert
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig as TConfig
from positionbaseddynamics_tpu_torch.solver import make_step_fn
from positionbaseddynamics_tpu_torch.solver import rollout as trollout

N = 32
POS_ATOL = 1e-5
POS_FIELDS = ("x", "old_x", "last_x")


def _scene(builder, **build_kw):
    b = builder()
    tm = b.add_regular_triangle_model(N, N, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + N - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(**build_kw)


def _jax_rollout(state, cset, cfg, n):
    fin, _ = jax.jit(lambda s: jrollout(s, cset, cfg, n))(state)
    return fin


def _assert_states_close(ts, js, h):
    for f in POS_FIELDS + ("x0", "inv_mass"):
        np.testing.assert_allclose(getattr(ts.particles, f).numpy(),
                                   np.asarray(getattr(js.particles, f)),
                                   atol=POS_ATOL, err_msg=f)
    np.testing.assert_allclose(ts.particles.v.numpy(),
                               np.asarray(js.particles.v),
                               atol=2 * POS_ATOL / h, err_msg="v")
    np.testing.assert_allclose(ts.time.numpy(), np.asarray(js.time),
                               atol=1e-7, err_msg="time")


@pytest.mark.parametrize("n_steps", [10, 50])
def test_trajectory_matches_jax(n_steps):
    js, jc = _scene(JBuilder)
    ts, tc = _scene(TBuilder, device="cpu")
    jfin = _jax_rollout(js, jc, JConfig(), n_steps)
    tfin, traj = trollout(ts, tc, TConfig(), n_steps, collect=True)
    _assert_states_close(tfin, jfin, TConfig().dt / TConfig().substeps)
    assert traj.shape == (n_steps, N * N, 3)
    np.testing.assert_array_equal(traj[-1].numpy(), tfin.particles.x.numpy())
    x0 = ts.particles.x.numpy()
    xf = tfin.particles.x.numpy()
    np.testing.assert_array_equal(xf[[0, N - 1]], x0[[0, N - 1]])
    assert xf[-1, 1] < x0[-1, 1] - 1e-3               # free corner fell


@pytest.mark.parametrize("overrides,n_steps", [
    (dict(max_iterations=2), 10),
    (dict(damping=0.01), 10),
    # the second-order update cancels O(1) terms, so an ulp of position
    # becomes an ulp/h of velocity: held over 2 steps
    (dict(velocity_update_method=1), 2),
    (dict(jacobi_omega=0.8), 10),
    (dict(solver_mode="gauss_seidel"), 5),
], ids=["iterations2", "damping", "second_order", "omega", "gauss_seidel"])
def test_config_variants_match_jax(overrides, n_steps):
    js, jc = _scene(JBuilder)
    ts, tc = _scene(TBuilder, device="cpu")
    jfin = _jax_rollout(js, jc, JConfig(**overrides), n_steps)
    tcfg = TConfig(**overrides)
    tfin, _ = trollout(ts, tc, tcfg, n_steps)
    _assert_states_close(tfin, jfin, tcfg.dt / tcfg.substeps)


def test_batched_state_equals_per_rollout():
    """A ``(B, N, 3)`` state steps each rollout exactly as alone."""
    ts, tc = _scene(TBuilder, device="cpu")
    rng = np.random.default_rng(0)
    p = ts.particles
    kicks = torch.from_numpy(
        rng.normal(0.0, 0.05, (3,) + tuple(p.v.shape)).astype(np.float32))
    kicks[:, [0, N - 1]] = 0.0
    singles = [dataclasses.replace(ts, particles=dataclasses.replace(
        p, v=p.v + kicks[r])) for r in range(3)]

    def stack(f):
        return torch.stack([getattr(s.particles, f) for s in singles])

    batched = dataclasses.replace(ts, particles=dataclasses.replace(
        p, **{f: stack(f) for f in ("x", "v", "old_x", "last_x", "x0",
                                    "inv_mass")}))
    fn = make_step_fn(tc, TConfig(), device="cpu")
    for _ in range(5):
        batched = fn(batched)
        singles = [fn(s) for s in singles]
    for r, s in enumerate(singles):
        for f in POS_FIELDS + ("v",):
            np.testing.assert_allclose(
                getattr(batched.particles, f)[r].numpy(),
                getattr(s.particles, f).numpy(), atol=1e-7, err_msg=f)


def _to_numpy(state, cset):
    p = state.particles
    arrays = {f: np.asarray(getattr(p, f))
              for f in ("x", "v", "old_x", "last_x", "x0", "inv_mass")}
    arrays["time"] = np.asarray(state.time)
    arrays["overflow"] = np.asarray(state.overflow)
    gcs, meta = [], []
    for gc in cset.grid_cloths:
        gcs.append({k: {f: np.asarray(a) for f, a in getattr(gc, k).items()}
                    for k in ("rest", "stiff", "q_mat", "bend_stiff")})
        gcs[-1].update(inv_cnt_dist=np.asarray(gc.inv_cnt_dist),
                       inv_cnt_bend=np.asarray(gc.inv_cnt_bend))
        meta.append({k: getattr(gc, k) for k in (
            "height", "width", "offset", "xpbd_distance", "xpbd_bending",
            "has_distance", "has_bending")})
    return arrays, gcs, meta


def test_scene_from_numpy_continues_jax_trajectory():
    """A JAX scene, stepped 3 times in JAX and carried across, continues
    on the port as it continues in JAX."""
    js, jc = _scene(JBuilder)
    assert not jc.particle_batches() and not jc.grid_tets
    js = _jax_rollout(js, jc, JConfig(), 3)
    ts, tc = convert.scene_from_numpy(*_to_numpy(js, jc), device="cpu")
    assert tc.n_particles == N * N
    jfin = _jax_rollout(js, jc, JConfig(), 10)
    tfin, _ = trollout(ts, tc, TConfig(), 10)
    _assert_states_close(tfin, jfin, TConfig().dt / TConfig().substeps)
