"""The port's halo-exchange intra-scene sharding
(``parallel/intra_grid.py``) on gloo groups of 4 CPU processes against
the JAX package's ``make_grid_intra_step_fn`` on 4 of its virtual CPU
devices: the 32×32 cloth by row blocks over 20 steps (2e-5, JAX's bar for
this path against the unsharded stepper, ``tests/test_intra_sharding.py``),
the transfers one row each (the counterpart of
``test_grid_halo_sharding_ici_is_o_halo``), and the 2×2 rollouts × rows
mesh on the 16×16 cloth (5e-6, JAX's bar for the 2-D mesh)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.parallel.intra_grid import (
    make_grid_intra_step_fn)
from positionbaseddynamics_tpu.solver import StepConfig as JConfig


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    return ranks.run_ranks("grid", 4, tmp_path_factory.mktemp("grid"))


def test_grid_halo_sharding_matches_jax(grid_run):
    out = grid_run
    state, cset = ranks.grid_cloth(JBuilder, 32)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("scene",))
    fn = make_grid_intra_step_fn(
        cset.grid_cloths[0], state.particles.inv_mass,
        JConfig(dt=ranks.DT, substeps=5, max_iterations=1), mesh)
    x, v = state.particles.x, state.particles.v
    for _ in range(20):
        x, v = fn(x, v)
    assert np.isfinite(out["x"]).all()
    assert np.abs(np.asarray(x) - np.asarray(state.particles.x)).max() > 1e-3
    np.testing.assert_allclose(out["x"], np.asarray(x), atol=2e-5)


def test_grid_halo_exchange_moves_one_row(grid_run):
    """Rank 0 (one neighbour) sends and receives one (1, W, k) row in each
    exchange of the 20 steps: per substep 2 passes, each a position
    exchange and a correction exchange; nothing is gathered (a gathering
    collective raises in the ranks)."""
    shapes = grid_run["p2p_shapes"]
    assert len(shapes) == 20 * 5 * 2 * 2 * 2
    assert {tuple(s) for s in shapes} == {(1, 32, 3)}


def test_dp_x_intra_mesh_matches_jax(tmp_path):
    out = ranks.run_ranks("grid_2d", 4, tmp_path)
    state, cset = ranks.grid_cloth(JBuilder, 16)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("dp", "scene"))
    fn = make_grid_intra_step_fn(
        cset.grid_cloths[0], state.particles.inv_mass,
        JConfig(dt=ranks.DT, substeps=2, max_iterations=1), mesh,
        axis="scene", dp_axis="dp")
    x = state.particles.x[None] + jnp.asarray(ranks.dp_offsets(4))
    v = jnp.zeros_like(x)
    for _ in range(5):
        x, v = fn(x, v)
    assert np.isfinite(out["x"]).all()
    np.testing.assert_allclose(out["x"], np.asarray(x), atol=5e-6)
