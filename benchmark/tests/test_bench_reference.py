"""The reference against the program's plain PyTorch route on the CPU,
at tiny sizes: the same scene from the same configuration, stepped from
the same state, and the same MPPI period."""
import importlib

import numpy as np
import pytest
import torch

from benchmark import loops, spec
from benchmark.controls import HandleVelocity
from benchmark.reference import grid_cloth, grid_tet, pbf_dam
from benchmark.reference.mppi import Planner
from benchmark.tests import tiny

CONFIGS = ["cloth-320", "bar-80x36x36"]


def _program(name):
    from positionbaseddynamics_tpu_torch.solver import make_step_fn

    cfg = tiny.config(name)
    state, cset = spec.kind_module("scenes", cfg["kind"]).build(cfg, "cpu")
    step_cfg = loops._step_config(cfg)
    return cfg, state, cset, step_cfg, make_step_fn(cset, step_cfg, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_follows_the_programs_plain_route(name):
    cfg, state, _cset, _sc, fn = _program(name)
    ref = spec.kind_module("reference", cfg["kind"]).scene(cfg)
    assert torch.equal(ref.x0, state.particles.x)
    assert torch.equal(ref.inv_mass, state.particles.inv_mass)
    gen = torch.Generator().manual_seed(3)
    v = (torch.rand(state.particles.x.shape, generator=gen) - 0.5) * 0.2
    v = torch.where(ref.active, v, torch.zeros_like(v))
    import dataclasses
    s = dataclasses.replace(state, particles=dataclasses.replace(
        state.particles, v=v))
    x, vr = ref.x0, v
    for _ in range(10):
        s = fn(s)
        x, vr, old, last = ref.step(x, vr)
    p = s.particles
    assert (p.x - x).abs().max().item() < 2e-5
    assert (p.old_x - old).abs().max().item() < 2e-5
    assert (p.last_x - last).abs().max().item() < 2e-5
    assert (p.v - vr).abs().max().item() < 2e-2


def test_cloth_derived_quantities_match_the_programs():
    cfg, _s, cset, _sc, _fn = _program("cloth-320")
    ref = grid_cloth.scene(cfg)
    gc = cset.grid_cloths[0]
    n = cfg["width"] * cfg["height"]
    assert torch.allclose(ref.icd, gc.inv_cnt_dist.reshape(n, 1))
    assert torch.allclose(ref.icb, gc.inv_cnt_bend.reshape(n, 1))
    assert len(ref.rest) == sum(int(np.prod(gc._family_shape(f)))
                                for f in gc.rest)
    fam = torch.stack([r.reshape(-1)[0] for r in gc.rest.values()])
    assert (ref.rest[:, None] - fam[None]).abs().min(1).values.max() < 1e-6
    assert len(ref.s) == sum(int(np.prod(gc._family_shape(f)))
                             for f in gc.q_mat)


def test_tet_derived_quantities_match_the_programs():
    cfg, _s, cset, _sc, _fn = _program("bar-80x36x36")
    ref = grid_tet.scene(cfg)
    gt = cset.grid_tets[0]
    w, h, d = cfg["width"], cfg["height"], cfg["depth"]
    assert torch.allclose(ref.ic, gt.inv_cnt.reshape(-1, 1))
    cells = (w - 1) * (h - 1) * (d - 1)
    dm = ref.dm_inv.reshape(cells, 5, 3, 3)
    vol = ref.vol.reshape(cells, 5)
    odd = gt.odd
    for t in range(5):
        assert torch.allclose(dm[odd, t], gt.inv_rest_odd[t].expand(
            int(odd.sum()), 3, 3), atol=1e-4)
        assert torch.allclose(dm[~odd, t], gt.inv_rest_even[t].expand(
            int((~odd).sum()), 3, 3), atol=1e-4)
        assert torch.allclose(vol[odd, t], gt.rest_vol_odd[t].expand(
            int(odd.sum())))
        assert torch.allclose(vol[~odd, t], gt.rest_vol_even[t].expand(
            int((~odd).sum())))


@pytest.mark.parametrize("name", CONFIGS)
def test_mppi_period_matches_the_programs_planner(name):
    from positionbaseddynamics_tpu_torch import mpc

    cfg, state, cset, step_cfg, _fn = _program(name)
    mix = tiny.mix("mpc-k256")
    kind = spec.kind_module("reference", cfg["kind"])
    handle, tracked = kind.handle(cfg), kind.tracked(cfg)
    target = (kind.points(cfg).astype(np.float64)[handle].mean(0)
              + cfg["mpc"]["target_offset"])
    control = HandleVelocity(tuple(handle), cfg["mpc"]["max_speed"])
    seq = mpc.make_sequence_cost(
        cset, step_cfg, control,
        running_cost=mpc.control_effort(mix["control_effort"]),
        terminal_cost=mpc.particle_target(tracked, target), device="cpu")
    mcfg = mpc.MPPIConfig(horizon=mix["horizon"],
                          num_samples=mix["num_samples"], sigma=1.0,
                          temperature=mix["temperature"])
    gen = torch.Generator().manual_seed(5)
    eps = torch.randn((mcfg.num_samples, mcfg.horizon, 3), generator=gen)
    nominal = torch.full((mcfg.horizon, 3), 0.3)
    new, costs = mpc.mppi_update(state, nominal, seq, mcfg, eps=eps)
    planner = Planner(kind.scene(cfg), handle, tracked, target, mix,
                      cfg["mpc"]["max_speed"], cfg["step"]["dt"])
    p = state.particles
    ref_new, ref_costs = planner.update(p.x, p.v, nominal, eps)
    assert (costs - ref_costs).abs().max().item() <= 1e-5 * ref_costs.abs(
    ).median().item()
    assert (new - ref_new).abs().max().item() < 1e-5


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in {"positionbaseddynamics_tpu_torch",
                                   "positionbaseddynamics_tpu", "jax",
                                   "jaxlib", "flax", "benchmark"}, (path, n)
    assert pathlib.Path(importlib.import_module(
        "benchmark.reference.xpbd").__file__).parent.name == "reference"


@pytest.mark.parametrize("same", [True, False])
def test_dam_search_finds_every_pair_however_far_particles_fly(same):
    """The cell search against every pair by brute force, on points that
    a blown-up state gives: a few particles thrown kilometres and further,
    one with a coordinate that is not finite (it has no pair)."""
    g = torch.Generator().manual_seed(7)
    xq = torch.rand(600, 3, generator=g) * 0.6
    xq[:40] = xq[:40] * 1e4 - 3e9            # far off, in one clump
    xq[40:45] += torch.tensor([1e9, -2e8, 5e7])
    xq[45, 1] = float("nan")
    xs = xq if same else torch.rand(300, 3, generator=g) * 0.6
    h = 0.1
    d = xq[:, None, :] - xs[None, :, :]
    r2 = (d * d).sum(-1)
    want = (r2 < h * h) & torch.isfinite(r2)
    if same:
        want.fill_diagonal_(False)
    i, j = pbf_dam.pairs(xq, xs, h, same, block=128)
    got = torch.zeros_like(want)
    got[i, j] = True
    assert len(i) == int(want.sum()) and torch.equal(got, want)
    assert torch.all(i[1:] >= i[:-1])


def _dam():
    from positionbaseddynamics_tpu_torch.fluids import make_fluid_step_fn

    cfg = tiny.config("dam-100k")
    state, scene = spec.kind_module("scenes", "pbf_dam").build(cfg, "cpu")
    return cfg, state, scene, make_fluid_step_fn(scene, "cpu")


def test_dam_derived_quantities_match_the_programs():
    cfg, state, scene, fn = _dam()
    ref = pbf_dam.scene(cfg)
    assert fn.path == "torch_cells"
    assert torch.equal(ref.x0, state.x)
    assert torch.equal(ref.xb, scene.boundary_x)
    assert ref.mass == pytest.approx(float(scene.mass[0]), rel=1e-6)
    # ψ: one float32 sum over each boundary particle's neighbours, in
    # another order
    assert torch.allclose(ref.psi, scene.boundary_psi, rtol=1e-6, atol=0)
    assert float(ref.dt0) == float(state.dt)


# 24 steps (3 frames) of the tiny dam, the reference from its own state:
# float32 sums in another order, amplified through 5 iterations a step.
# The dam throws its first layers out at 35–65 m/s, so dt falls to ~3e-4 s
# and v = Δx/dt turns a gap of a few µm into some mm/s. Readings on two
# seeds: x ≤ 7.8e-6 m, v ≤ 3.3e-3 m/s, dt ≤ 3.8e-9 s.
DAM_X_TOL = 5e-5        # m
DAM_V_TOL = 2e-2        # m/s, about 1e-4 × 65 m/s
DAM_DT_TOL = 2e-8       # s: dt follows the fastest particle's speed


@pytest.mark.parametrize("seed", [3, 4])
def test_dam_reference_follows_the_programs_plain_cell_route(seed):
    import dataclasses

    cfg, state, _scene, fn = _dam()
    ref = pbf_dam.scene(cfg)
    short = pbf_dam.scene({**cfg, "step": {**cfg["step"],
                                           "max_iterations": 4}})
    gen = torch.Generator().manual_seed(seed)
    v = (torch.rand(state.x.shape, generator=gen) * 2 - 1) * 0.1
    s = dataclasses.replace(state, v=v)
    x, vr, dt = ref.x0, v, ref.dt0
    xs, vs, dts = ref.x0, v, ref.dt0
    for _ in range(24):
        s = fn(s)
        x, vr, dt, _old = ref.step(x, vr, dt)
        xs, vs, dts, _old = short.step(xs, vs, dts)
    assert float(s.overflow) == 0
    assert (s.x - x).abs().max().item() < DAM_X_TOL
    assert (s.v - vr).abs().max().item() < DAM_V_TOL
    assert abs(float(s.dt) - float(dt)) < DAM_DT_TOL
    # the tolerances are tight enough to see one density iteration left out
    assert (s.x - xs).abs().max().item() > 10 * DAM_X_TOL


def test_dam_frame_keeps_the_programs_fields():
    cfg, state, _scene, fn = _dam()
    ref = pbf_dam.scene(cfg)
    s0 = fn(state)
    s1 = fn(s0)
    r = ref.frame({"x": s0.x, "v": s0.v, "old_x": s0.old_x, "dt": s0.dt},
                  False, 1)
    assert set(r) == {"x", "v", "old_x", "last_x", "dt", "overflow"}
    assert torch.equal(r["old_x"], s0.x) and torch.equal(r["last_x"],
                                                         s0.old_x)
    assert (r["x"] - s1.x).abs().max().item() < DAM_X_TOL
