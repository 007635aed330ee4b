"""The cloth kernel's wide tile on the CPU: the rule that decides which
per-substep launches take it (``solver/grid_cloth_cuda.py``,
``takes_wide``) and the items (blocks) of such a launch. The kernel itself
runs only on the card, where ``tests/test_torch_kernel_card.py`` holds it
to the small tile bit for bit and counts its launches through
``make_step_fn``.

No JAX here: these are the port's own plans, pure Python."""
import re

import pytest
import torch

from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc
from positionbaseddynamics_tpu_torch.utils import telemetry

H100_WIDE_CAPACITY = 2 * 132   # 2 blocks of 736 threads on each of 132 SMs


def _takes(n_batch, height=320, width=320, iters=1, row_offset=0,
           global_height=None, capacity=H100_WIDE_CAPACITY):
    gh = height if global_height is None else global_height
    return gcc.takes_wide(n_batch, height, width, iters, row_offset, gh,
                          capacity)


@pytest.mark.parametrize("n_batch,height,width,items", [
    (1, 320, 320, 64), (256, 320, 320, 16384), (256, 52, 68, 1024),
    (1, 5, 7, 1), (3, 41, 81, 18)],
    ids=["bench", "mpc_big", "ragged", "tiny", "one_past_each_side"])
def test_wide_items_are_wide_tiles_by_rollouts(n_batch, height, width,
                                               items):
    """A wide launch's items are (40×40 tile, rollout) pairs, a ragged
    edge taking a tile of its own."""
    assert gcc.WIDE_TILE == (40, 40)
    assert gcc.wide_items(n_batch, height, width) == items


@pytest.mark.parametrize("n_batch,wide", [(1, False), (2, True), (3, True),
                                          (4, True), (256, True)])
def test_bench_cloth_takes_wide_only_at_many_rollouts(n_batch, wide):
    """The 320×320 cloth on an H100: the small tile at 1 rollout (the sim
    step, the planner's executed step; 64 items, 0.24 of the 264 resident
    blocks), the wide one from 2 (128 items, 0.48), so at ``--batch 4
    --no-fuse``'s 4 and the planner's 256."""
    assert _takes(n_batch) is wide


@pytest.mark.parametrize("case", [
    dict(iters=2), dict(iters=4), dict(iters=5),
    dict(row_offset=116, global_height=320), dict(global_height=640),
    dict(row_offset=-3, global_height=320)],
    ids=["it2", "it4", "it5_two_launches", "row_window", "taller_grid",
         "window_above"])
def test_wide_never_takes_more_iterations_or_a_row_window(case):
    """More than one iteration a launch and every row window keep the
    small tile, however many rollouts fill the card."""
    assert _takes(4096, **case) is False
    assert _takes(4096) is True


# (height, width, capacity, n_batch, wide), worked by hand: items are
# n_batch x ceil(H/40) x ceil(W/40) against 0.35 of the capacity (92.4 of
# 264), and cells
# solved 46 x 46 an item against 38 x 22 for each of n_batch x ceil(H/16) x
# ceil(W/32) small items
@pytest.mark.parametrize("height,width,capacity,n_batch,wide", [
    (32, 32, 264, 256, False),     # 1 item: 2116 cells against 2 x 836
    (64, 64, 264, 64, False),      # 4 items: 8464 against 8 x 836 = 6688
    (64, 64, 264, 4096, False),
    (128, 128, 264, 256, False),   # 16 items: 33856 against 32 x 836
    (320, 320, 264, 1, False),     # 64 items < 92.4
    (320, 320, 264, 2, True),      # 128 items; 270848 against 334400
    (320, 320, 1, 1, True),
    (52, 68, 264, 256, True),      # 4 items: 8464 against 12 x 836
    (52, 68, 264, 23, False),      # 92 items < 92.4
    (52, 68, 264, 24, True),       # 96 items
    (40, 40, 264, 256, True),      # 1 item: 2116 against 6 x 836
    (100, 100, 264, 8, False),     # 72 items < 92.4
    (100, 100, 264, 16, True),     # 144 items; 19044 against 28 x 836
    (80, 80, 264, 64, True),       # 4 items: 8464 against 15 x 836
    (5, 7, 264, 1024, False),      # 2116 against 836
])
def test_takes_wide_on_hand_worked_launches(height, width, capacity,
                                            n_batch, wide):
    """The rule on launches worked by hand: the wide tile only where its
    items fill 0.35 of the resident blocks and it solves fewer cells than the
    small tile, so never on ``bench.py --mpc``'s 32x32 cloth or the
    planner route check's 64x64 one, where a 40x40 tile's halo is most of
    what it solves."""
    assert _takes(n_batch, height, width, capacity=capacity) is wide


@pytest.mark.parametrize("tile,height,width,cells", [
    ((32, 16), 320, 320, 200 * 38 * 22), ((40, 40), 320, 320, 64 * 46 * 46),
    ((32, 16), 52, 68, 12 * 38 * 22), ((40, 40), 32, 32, 46 * 46)])
def test_solved_cells_count_each_item_with_its_halo(tile, height, width,
                                                    cells):
    """Each (tile, rollout) item solves its tile and a halo of 3 cells on
    every side; two rollouts solve twice as many."""
    assert gcc.solved_cells(tile, 1, height, width) == cells
    assert gcc.solved_cells(tile, 2, height, width) == 2 * cells


def test_tiles_are_the_kernel_sources():
    """``TILE`` and ``WIDE_TILE`` are the kernel source's ``TX`` x ``TY``
    and ``kWideTX`` x ``kWideTY``, each defined once there."""
    from positionbaseddynamics_tpu_torch import _build

    src = (_build.CSRC / "grid_cloth_step.cu").read_text()
    for names, tile in ((("TX", "TY"), gcc.TILE),
                        (("kWideTX", "kWideTY"), gcc.WIDE_TILE)):
        for name, value in zip(names, tile):
            found = re.findall(rf"constexpr int {name} = (\d+);", src)
            assert found == [str(value)], name


def test_fused_step_on_cpu_counts_no_wide_launch():
    """The fused mode runs its own cooperative launch (on the CPU its plain
    version) and never a per-substep one, so no wide one either."""
    from positionbaseddynamics_tpu_torch.models import SceneBuilder

    b = SceneBuilder()
    tm = b.add_regular_triangle_model(9, 7, scale=(1.0, 1.0))
    b.set_mass(tm.offset, 0.0)
    b.add_cloth_constraints(tm, method=4, distance_stiffness=1e5)
    b.add_bending_constraints(tm, method=3, stiffness=0.05)
    ts, tc = b.build(device="cpu")
    g, p = tc.grid_cloths[0], ts.particles
    step = gcc.make_cloth_step(g, p.inv_mass, g.inv_cnt_dist,
                               g.inv_cnt_bend, dt=0.005, substeps=5,
                               fuse_substeps=True, device="cpu")
    telemetry.reset()
    x, _ = step(p.x, p.v)
    assert torch.isfinite(x).all()
    assert telemetry.counters().get(
        "kernel.cloth_substep.wide_launches", 0) == 0
    assert telemetry.launches("cloth_substep") == 0
