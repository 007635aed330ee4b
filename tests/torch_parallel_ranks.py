"""Ranks of the port's ``parallel/`` modules on the CPU, for the tests.

``run_ranks(case, world, tmp_path)`` starts ``world`` processes of this
file, joined in a gloo process group through a ``FileStore`` under
``tmp_path`` (no TCP port, so test workers running side by side cannot
clash), runs the case in each and returns rank 0's result as a dict of
numpy arrays. A case builds its scene with the port's ``SceneBuilder`` on
the CPU, the same scene the test builds with the JAX package's; this file
imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DT = 0.005


def grid_cloth(builder, n, structured=True, **build_kw):
    """The tests' cloth: ``n``×``n``, two corners pinned, XPBD distance 1e5
    and isometric bending 0.05, as ``tests/test_intra_sharding.py`` builds
    it: structured on a 2×2 square, or unstructured on the default one."""
    b = builder() if structured else builder(use_structured_grid=False)
    kw = {"scale": (2.0, 2.0)} if structured else {}
    tm = b.add_regular_triangle_model(n, n, **kw)
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + n - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(**build_kw)


def dp_offsets(b: int) -> np.ndarray:
    """Per-rollout position offsets ``(b, 1, 1)``: rollout k moved by
    1e-3·k, as the JAX test perturbs its rollouts."""
    return (1e-3 * np.arange(b, dtype=np.float32))[:, None, None]


# -- cases (each runs in every rank; returns rank 0's arrays) ---------------


def _port():
    import torch

    from positionbaseddynamics_tpu_torch.models import SceneBuilder
    from positionbaseddynamics_tpu_torch.solver import StepConfig
    return torch, SceneBuilder, StepConfig


def case_dp(group):
    """8 rollouts of the 8×8 cloth, 2 a rank, 5 steps."""
    torch, SB, StepConfig = _port()
    from positionbaseddynamics_tpu_torch import parallel as par

    state, cset = grid_cloth(SB, 8, device="cpu")
    cfg = StepConfig(dt=DT, substeps=5)
    batch = par.replicate_scene(state, 8)
    batch = dataclasses.replace(batch, particles=dataclasses.replace(
        batch.particles, x=batch.particles.x + torch.tensor(dp_offsets(8))))
    local = par.shard_batch(batch, group)
    fn = par.make_sharded_step_fn(cset, cfg, group, device="cpu")
    for _ in range(5):
        local = fn(local)
    out = par.gather_batch(local, group)
    return {"x": out.particles.x.numpy(), "v": out.particles.v.numpy(),
            "local_rollouts": np.int64(local.particles.x.shape[0])}


def case_intra(group):
    """The 16×16 unstructured cloth, its particles over the ranks, 20
    steps."""
    torch, SB, StepConfig = _port()
    from positionbaseddynamics_tpu_torch import parallel as par

    state, cset = grid_cloth(SB, 16, structured=False, device="cpu")
    cfg = StepConfig(dt=DT, substeps=5)
    fn = par.make_intra_sharded_step_fn(state, cset, cfg, group,
                                        device="cpu")
    local = par.shard_particles(par.pad_state_for_mesh(state, group), group)
    for _ in range(20):
        local = fn(local)
    out = par.gather_particles(local, group)
    return {"x": out.particles.x.numpy(), "v": out.particles.v.numpy(),
            "time": out.time.numpy()}


def _record_p2p():
    """Wrap ``batch_isend_irecv`` to record each transfer's shape, and
    make every gathering collective fail loudly. Returns the shapes'
    list and a function that undoes the wrapping."""
    import torch.distributed as dist

    names = ("batch_isend_irecv", "all_gather", "all_gather_into_tensor",
             "all_reduce")
    real = {k: getattr(dist, k) for k in names}
    shapes = []

    def wrapped(ops):
        shapes.extend(tuple(op.tensor.shape) for op in ops)
        return real["batch_isend_irecv"](ops)

    def refuse(*a, **k):
        raise AssertionError("the halo exchange must not gather")

    dist.batch_isend_irecv = wrapped
    for k in names[1:]:
        setattr(dist, k, refuse)

    def undo():
        for k, f in real.items():
            setattr(dist, k, f)

    return shapes, undo


def _rows(a, n, group):
    """This rank's row block of an ``(..., n·n, 3)`` array."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    r = n // world
    return a[..., rank * r * n:(rank + 1) * r * n, :].contiguous()


def _gather_rows(a, group):
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(a) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, a.contiguous(), group=group)
    return torch.cat(parts, -2)


def case_grid(group):
    """The 32×32 structured cloth by row blocks, 20 steps; the transfers'
    shapes recorded."""
    torch, SB, StepConfig = _port()
    from positionbaseddynamics_tpu_torch import parallel as par

    state, cset = grid_cloth(SB, 32, device="cpu")
    cfg = StepConfig(dt=DT, substeps=5, max_iterations=1)
    gc = cset.grid_cloths[0]
    fn = par.make_grid_intra_step_fn(gc, state.particles.inv_mass, cfg,
                                     group, device="cpu")
    x = _rows(state.particles.x, 32, group)
    v = _rows(state.particles.v, 32, group)
    shapes, undo = _record_p2p()
    for _ in range(20):
        x, v = fn(x, v)
    undo()
    return {"x": _gather_rows(x, group).numpy(),
            "p2p_shapes": np.asarray(shapes, np.int64)}


def case_grid_2d(dp_group, group):
    """4 rollouts of the 16×16 cloth on the 2×2 mesh (2 rollouts and 8
    rows a rank), 5 steps of 2 substeps."""
    torch, SB, StepConfig = _port()
    from positionbaseddynamics_tpu_torch import parallel as par

    state, cset = grid_cloth(SB, 16, device="cpu")
    cfg = StepConfig(dt=DT, substeps=2, max_iterations=1)
    gc = cset.grid_cloths[0]
    fn = par.make_grid_intra_step_fn(gc, state.particles.inv_mass, cfg,
                                     group, dp_group=dp_group, device="cpu")
    x0 = state.particles.x[None] + torch.tensor(dp_offsets(4))
    x = _rows(par.shard_batch(x0, dp_group), 16, group)
    v = torch.zeros_like(x)
    for _ in range(5):
        x, v = fn(x, v)
    x = par.gather_batch(_gather_rows(x, group), dp_group)
    return {"x": x.numpy()}


def case_cuda_plain(group):
    """The 48×48 cloth through ``intra_cuda``'s plain route, 5 steps of 2
    substeps."""
    torch, SB, StepConfig = _port()
    from positionbaseddynamics_tpu_torch import parallel as par

    state, cset = grid_cloth(SB, 48, device="cpu")
    cfg = StepConfig(dt=DT, substeps=2, max_iterations=1)
    gc = cset.grid_cloths[0]
    fn = par.make_cuda_intra_step_fn(gc, state.particles.inv_mass, cfg,
                                     group, device="cpu")
    x = _rows(state.particles.x, 48, group)
    v = _rows(state.particles.v, 48, group)
    for _ in range(5):
        x, v = fn(x, v)
    return {"x": _gather_rows(x, group).numpy(),
            "v": _gather_rows(v, group).numpy()}


CASES = {"dp": case_dp, "intra": case_intra, "grid": case_grid,
         "grid_2d": case_grid_2d, "cuda_plain": case_cuda_plain}


def _main(case, rank, world, store, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from positionbaseddynamics_tpu_torch import parallel as par

        if case == "grid_2d":
            result = CASES[case](*par.make_mesh_groups(2, device="cpu"))
        else:
            result = CASES[case](par.make_group(device="cpu"))
        if rank == 0:
            np.savez(out, **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(case: str, world: int, tmp_path, timeout: float = 240.0):
    """Run ``case`` in ``world`` gloo ranks; rank 0's result as a dict."""
    store = str(tmp_path / f"{case}.store")
    out = str(tmp_path / f"{case}.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), store, out],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5])
