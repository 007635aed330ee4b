"""The fused cloth launch's plan on the CPU: its items, grid and scratch
planes (``solver/grid_cloth_cuda.py``), and its wrappers' refusal of CPU
tensors. The kernel itself runs only on the card, where
``tests/test_torch_parallel_cuda.py`` and ``chip_smoke.py`` phase 13 hold
it to the per-substep launches bit for bit; its plain versions are held
to the JAX package in ``tests/test_torch_parallel_window.py``.

No JAX here: these are the port's own plans, pure Python."""
import numpy as np
import pytest
import torch

from positionbaseddynamics_tpu_torch.models import SceneBuilder
from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

H100_CAPACITY = 2 * 132        # 2 blocks of 864 threads on each of 132 SMs


# the bench cloth at 1, 4 and 256 rollouts (bench.py, --batch 4,
# --mpc-big), chip_smoke.py's 116-row window, and a grid smaller than one
# tile row
@pytest.mark.parametrize("n_batch,height,width,items,grid", [
    (1, 320, 320, 200, 200), (4, 320, 320, 800, 264),
    (256, 320, 320, 51200, 264), (1, 116, 320, 80, 80),
    (64, 37, 40, 384, 264), (1, 5, 7, 1, 1)],
    ids=["bench", "batch4", "mpc_big", "window116", "k64_small", "tiny"])
def test_fused_grid_is_one_block_an_item_up_to_capacity(n_batch, height,
                                                        width, items, grid):
    """A fused launch's items are (32×16 tile, rollout) pairs, its grid
    one block an item, at most the blocks the card holds at once."""
    assert gcc.TILE == (32, 16)
    assert gcc.fused_items(n_batch, height, width) == items
    assert gcc.fused_grid(n_batch, height, width, H100_CAPACITY) == grid
    # a block takes ceil(items / grid) items a pass, or one fewer
    per_block = -(-items // grid)
    assert (per_block - 1) * grid < items <= per_block * grid


@pytest.mark.parametrize("substeps,iters,want", [
    (1, 1, (False, False, False, False, False, False)),
    (5, 1, (True, True, False, False, False, False)),
    (1, 2, (False, False, True, False, True, False)),
    (2, 2, (True, True, True, False, True, False)),
    (1, 3, (False, False, True, True, True, True))],
    ids=["one_pass", "bench_step", "one_substep_it2", "two_substeps_it2",
         "it3"])
def test_fused_scratch_holds_what_the_launch_needs(substeps, iters, want):
    """The launch's scratch: a state past one substep, positions and a λ
    plane (with a row above and below the planes' rows) between a
    substep's passes past one iteration, a second of each past two."""
    xp = torch.zeros(2, 3, 5, 7)
    scratch = gcc.FusedScratch()
    bufs = scratch.get(xp, substeps, iters)
    assert gcc.FusedScratch.NAMES == ("xs", "vs", "xp0", "xp1", "lam0",
                                      "lam1")
    assert tuple(b is not None for b in bufs) == want
    for b, shape in zip(bufs, [(2, 3, 5, 7)] * 4 + [(2, 6, 7, 7)] * 2):
        assert b is None or tuple(b.shape) == shape
    again = scratch.get(xp, substeps, iters)
    assert all(a is b for a, b in zip(bufs, again))


def test_fused_scratch_is_kept_across_a_steps_shares():
    """``fused_split(5, 2)`` launches 2, 2 and 1 substeps: the shares
    reuse one set of planes, and planes of another shape get new ones."""
    assert gcc.fused_split(5, 2) == [2, 2, 1]
    xp = torch.zeros(1, 3, 4, 6)
    scratch = gcc.FusedScratch()
    first = scratch.get(xp, 2, 2)
    last = scratch.get(xp, 1, 2)
    assert last[0] is None and last[1] is None
    assert last[2] is first[2] and last[4] is first[4]
    again = scratch.get(xp, 2, 2)
    assert all(a is b for a, b in zip(first, again))
    other = scratch.get(torch.zeros(3, 3, 4, 6), 2, 2)
    assert tuple(other[0].shape) == (3, 3, 4, 6)
    assert tuple(other[4].shape) == (3, 6, 6, 6)
    assert other[2] is not first[2]


def _cloth(n):
    b = SceneBuilder()
    tm = b.add_regular_triangle_model(n, n)
    b.set_mass(tm.offset, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    return b.build(device="cpu")


@pytest.mark.parametrize("which", ["fused", "window"])
def test_fused_wrappers_refuse_cpu_tensors(which):
    """The fused kernel has no CPU mode: given CPU planes and a scratch,
    either wrapper raises before it builds or launches anything, and
    counts no launch."""
    state, cset = _cloth(8)
    p = gcc.kernel_params(cset.grid_cloths[0], h=1e-3)
    xp = torch.zeros(1, 3, 8, 8)
    one = torch.ones(8, 8)
    scratch = gcc.FusedScratch()
    fn = gcc.cloth_fused_cuda if which == "fused" else gcc.cloth_window_cuda
    args = (xp, xp.clone(), one, one, one, p, 1, 5)
    if which == "window":
        args += (-2, 16)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, scratch=scratch)
    assert fn.launches == before
    assert scratch.bufs == {}


def test_fused_step_on_cpu_runs_the_plain_version():
    """``make_cloth_step(fuse_substeps=True)`` on the CPU takes the plain
    version, so it equals the per-substep step there bit for bit."""
    state, cset = _cloth(12)
    g, pt = cset.grid_cloths[0], state.particles
    rng = np.random.default_rng(5)
    x = pt.x + torch.as_tensor(0.01 * rng.standard_normal(pt.x.shape),
                               dtype=torch.float32)
    v = torch.as_tensor(0.1 * rng.standard_normal(pt.x.shape),
                        dtype=torch.float32)

    def step(fuse):
        return gcc.make_cloth_step(g, pt.inv_mass, g.inv_cnt_dist,
                                   g.inv_cnt_bend, dt=0.005, substeps=5,
                                   max_iterations=2, damping=0.01,
                                   n_steps=2, fuse_substeps=fuse,
                                   device="cpu")

    xf, vf = step(True)(x, v)
    xs, vs = step(False)(x, v)
    assert torch.equal(xf, xs) and torch.equal(vf, vs)
