"""The port's rollout sharding (``parallel/sharding.py``) on a gloo group
of 4 CPU processes against the JAX package's ``make_sharded_step_fn`` on 4
of its virtual CPU devices (``tests/conftest.py``), the same 8 rollouts of
the 8×8 cloth. Tolerance 1e-5, the port's bar against JAX on the CPU (the
same float32 math; the port's stencil adds in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from positionbaseddynamics_tpu.models import SceneBuilder as JBuilder
from positionbaseddynamics_tpu.parallel import sharding as jsh
from positionbaseddynamics_tpu.solver import StepConfig as JConfig
from positionbaseddynamics_tpu_torch import parallel as par


def test_dp_matches_jax_sharded_step(tmp_path):
    out = ranks.run_ranks("dp", 4, tmp_path)
    state, cset = ranks.grid_cloth(JBuilder, 8)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("rollout",))
    batch = jsh.replicate_scene(state, 8)
    batch = dataclasses.replace(batch, particles=dataclasses.replace(
        batch.particles, x=batch.particles.x
        + jnp.asarray(ranks.dp_offsets(8))))
    fn = jsh.make_sharded_step_fn(cset, JConfig(dt=ranks.DT, substeps=5),
                                  mesh)
    batch = jsh.shard_batch(batch, mesh)
    for _ in range(5):
        batch = fn(batch)
    assert int(out["local_rollouts"]) == 2
    assert np.isfinite(out["x"]).all()
    np.testing.assert_allclose(out["x"], np.asarray(batch.particles.x),
                               atol=1e-5)
    np.testing.assert_allclose(out["v"], np.asarray(batch.particles.v),
                               atol=1e-3)
    # the rollouts differ, so the blocks came back in rank order
    assert np.abs(out["x"][7] - out["x"][0]).max() > 5e-3


def test_make_group_needs_an_initialised_process_group():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already initialised here")
    with pytest.raises(RuntimeError, match="init_process_group"):
        par.make_group(device="cpu")
