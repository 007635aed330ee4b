"""The CUDA cloth and tet kernels against their plain PyTorch versions, on
the card.

These tests import only torch and the port, so they run on a machine with
the card (``python -m pytest tests/test_torch_kernel_card.py``); without a
CUDA device they skip, since the kernel has no CPU mode. Tolerance 1e-5
over 5 steps, the repo's kernel-against-stencil bar (``bench.py --check``):
the kernel contracts products into FMAs where the plain version rounds
each operation."""
import pytest
import torch

from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import StepConfig, make_step_fn
from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc


def _build(n, m, device):
    b = SceneBuilder()
    tm = b.add_regular_triangle_model(n, m, scale=(2.0, 2.0))
    b.set_mass(tm.offset, 0.0)
    b.set_mass(tm.offset + n - 1, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("shape,iters", [((40, 37), 2), ((67, 53), 1),
                                         ((40, 37), 6)])
def test_kernel_matches_plain_version_on_card(cuda, shape, iters):
    ts, tc = _build(*shape, device=cuda)
    g = tc.grid_cloths[0]
    step = gcc.make_cloth_step(
        g, ts.particles.inv_mass, g.inv_cnt_dist, g.inv_cnt_bend, dt=0.005,
        substeps=5, max_iterations=iters, damping=0.01, n_steps=5)
    x, v = step(ts.particles.x, ts.particles.v)
    xr, vr = ts.particles.x, ts.particles.v
    for _ in range(25):
        xr, vr = gcc.cloth_substep_reference(
            g, xr, vr, ts.particles.inv_mass, h=1e-3, max_iterations=iters,
            damping=0.01)
    assert (x - xr).abs().max().item() <= 1e-5


@pytest.mark.parametrize("iters,launches_per_substep", [
    (1, 1), (gcc.FUSED_ITERATIONS + 1, 2)])
def test_step_fn_takes_the_kernel_on_card(cuda, iters, launches_per_substep):
    """More iterations than one launch holds stay on the kernel route, as
    several launches a substep with λ carried between them."""
    cfg = StepConfig(max_iterations=iters)
    ts, tc = _build(33, 33, device=cuda)
    fn = make_step_fn(tc, cfg, device=cuda)
    assert fn.path == "cuda_kernel"
    before = gcc.cloth_substep_cuda.launches
    out = fn(fn(ts))
    assert (gcc.cloth_substep_cuda.launches - before
            == 2 * cfg.substeps * launches_per_substep)
    ref = make_step_fn(tc.to("cpu"), cfg, device="cpu")
    cpu = ref(ref(ts.to("cpu")))
    for f in ("x", "old_x", "last_x"):
        dev = getattr(out.particles, f).cpu() - getattr(cpu.particles, f)
        assert dev.abs().max().item() <= 1e-5, f
    assert abs(out.time.item() - cpu.time.item()) <= 1e-7


def test_batched_state_with_own_inverse_masses_on_card(cuda):
    """A ``(B, N, 3)`` state whose rollouts pin different particles: the
    kernel reads each rollout's own inverse-mass plane."""
    import dataclasses

    ts, tc = _build(35, 18, device=cuda)
    p = ts.particles
    inv_mass = torch.stack([p.inv_mass, p.inv_mass.clone()])
    inv_mass[1, 35 * 17] = 0.0                 # pin a top corner in one
    batched = dataclasses.replace(ts, particles=dataclasses.replace(
        p, **{f: torch.stack([getattr(p, f)] * 2)
              for f in ("x", "v", "old_x", "last_x", "x0")},
        inv_mass=inv_mass))
    fn = make_step_fn(tc, StepConfig(), device=cuda)
    assert fn.path == "cuda_kernel"
    ref = make_step_fn(tc.to("cpu"), StepConfig(), device="cpu")
    out, cpu = batched, batched.to("cpu")
    for _ in range(3):
        out, cpu = fn(out), ref(cpu)
    dev = (out.particles.x.cpu() - cpu.particles.x).abs().max().item()
    assert dev <= 1e-5
    x0 = p.x[35 * 17]
    assert torch.equal(out.particles.x[1, 35 * 17], x0)
    assert not torch.equal(out.particles.x[0, 35 * 17], x0)


def _bar(dims, device, stiffness=1e5):
    b = SceneBuilder()
    tm = b.add_regular_tet_model(*dims, scale=(2.0, 0.5, 0.5))
    for j in range(dims[1]):
        for k in range(dims[2]):
            b.set_mass(tm.offset + j * dims[2] + k, 0.0)
    b.add_solid_constraints(tm, method=3, stiffness=stiffness,
                            poisson_ratio=0.3)
    return b.build(device=device)


# The 5-iteration case runs 4 steps: at more than one iteration the
# reference's own trajectory jumps by orders of magnitude at step 6 at
# this size (tests/test_torch_tet_step.py), and two runs past that point
# agree to no tolerance.
@pytest.mark.parametrize("dims,iters,damping,stiffness,steps", [
    ((13, 7, 5), 1, 0.0, 1e5, 10), ((13, 7, 5), 5, 0.01, 1e5, 4),
    ((9, 4, 6), 2, 0.0, 1e5, 3), ((13, 7, 5), 1, 0.0, 0.0, 10)],
    ids=["13x7x5", "13x7x5_it5_damped", "9x4x6_it2", "stiffness0"])
def test_tet_kernel_matches_plain_version_on_card(cuda, dims, iters, damping,
                                                  stiffness, steps):
    ts, tc = _bar(dims, cuda, stiffness)
    g, p = tc.grid_tets[0], ts.particles
    step = gtc.make_tet_step(g, p.inv_mass, dt=0.005, substeps=5,
                             max_iterations=iters, damping=damping,
                             n_steps=steps)
    x, v = step(p.x, p.v)
    xr, vr = p.x, p.v
    for _ in range(5 * steps):
        xr, vr = gtc.tet_substep_reference(g, xr, vr, p.inv_mass, h=1e-3,
                                           max_iterations=iters,
                                           damping=damping)
    assert torch.isfinite(x).all() and torch.isfinite(v).all()
    assert (x - xr).abs().max().item() <= (1e-6 if stiffness == 0 else 1e-5)
    n_pin = dims[1] * dims[2]
    assert torch.equal(x[:n_pin], p.x[:n_pin])
    assert torch.equal(v[:n_pin], p.v[:n_pin])


@pytest.mark.parametrize("iters", [1, 3])
def test_tet_step_fn_takes_the_kernel_on_card(cuda, iters):
    cfg = StepConfig(max_iterations=iters)
    ts, tc = _bar((11, 5, 6), cuda)
    fn = make_step_fn(tc, cfg, device=cuda)
    assert fn.path == "cuda_kernel"
    before = gtc.tet_substep_cuda.launches
    out = fn(fn(ts))
    assert (gtc.tet_substep_cuda.launches - before
            == 2 * cfg.substeps * 2 * iters)
    ref = make_step_fn(tc.to("cpu"), cfg, device="cpu")
    cpu = ref(ref(ts.to("cpu")))
    for f in ("x", "v", "old_x", "last_x"):
        dev = getattr(out.particles, f).cpu() - getattr(cpu.particles, f)
        tol = 1e-5 if f != "v" else 2e-5 / 1e-3
        assert dev.abs().max().item() <= tol, f
    assert out.time.item() == cpu.time.item()
