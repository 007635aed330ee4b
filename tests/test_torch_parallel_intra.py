"""The port's generic intra-scene sharding (``parallel/intra.py``): the
16×16 unstructured cloth's particles over a gloo group of 4 CPU processes
against the JAX package's ``make_intra_sharded_step_fn`` on 4 of its
virtual CPU devices, 20 steps. Tolerance: x 1e-5, the port's bar against
JAX on the CPU (the all_reduce sums the ranks' corrections in another
order than one scatter); v 1e-3, JAX's own bar for this path against the
unsharded step (``tests/test_intra_sharding.py``), v being Δx/h."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.parallel import intra as jintra
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu_torch import parallel as par
from positionbaseddynamics_tpu_torch.models import SceneBuilder as TBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig


def test_intra_matches_jax_intra_sharded_step(tmp_path):
    out = ranks.run_ranks("intra", 4, tmp_path)
    state, cset = ranks.grid_cloth(JBuilder, 16, structured=False)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("scene",))
    fn = jintra.make_intra_sharded_step_fn(
        state, cset, JConfig(dt=ranks.DT, substeps=5), mesh)
    st = jintra.pad_state_for_mesh(state, mesh)
    for _ in range(20):
        st = fn(st)
    x_ref = np.asarray(st.particles.x)
    assert np.isfinite(out["x"]).all()
    assert np.abs(x_ref - np.asarray(state.particles.x)).max() > 1e-2
    np.testing.assert_allclose(out["x"], x_ref, atol=1e-5)
    np.testing.assert_allclose(out["v"], np.asarray(st.particles.v),
                               atol=1e-3)
    np.testing.assert_allclose(out["time"], 20 * ranks.DT, rtol=1e-6)


def test_intra_refuses_what_it_cannot_shard():
    """JAX's refusals (``intra.py:58-65``) come before any collective:
    a structured grid, and a set without its Jacobi counts."""
    state, cset = ranks.grid_cloth(TBuilder, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="intra_grid"):
        par.make_intra_sharded_step_fn(state, cset, StepConfig(), None,
                                       device="cpu")
    state, cset = ranks.grid_cloth(TBuilder, 8, structured=False,
                                   device="cpu")
    import dataclasses
    bare = dataclasses.replace(cset, jacobi_inv_counts={})
    with pytest.raises(ValueError, match="with_jacobi_counts"):
        par.make_intra_sharded_step_fn(state, bare, StepConfig(), None,
                                       device="cpu")
