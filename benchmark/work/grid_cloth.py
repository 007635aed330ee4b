"""Work of one substep of a regular H×W XPBD cloth, counted from shapes
(frozen from ``chip_smoke.py``'s counts of ``csrc/grid_cloth_step.cu``).

float32 operations a particle: integration 12, velocity update and
damping 9; an iteration, per anchor, the 3 distance solves 3 × 24 and the
3 bending solves 3 × 50, the distance gather 8 terms × 3 components × 2
plus 6 and the bending gather 20 terms × 7 plus 6. Cells a block
recomputes as halo are not work the substep needs, and are not counted.

Bytes: each rollout's 6 state planes (x, v) read once and written once,
12 floats a particle, and the inverse masses and the two Jacobi weight
planes read once for all rollouts.
"""
from __future__ import annotations

FLOPS_FIXED = 12 + 9
FLOPS_PER_ITERATION = 3 * 24 + 3 * 50 + 8 * 3 * 2 + 6 + 20 * 7 + 6


def substep(config: dict, n_batch: int, iterations: int):
    """``(flops, bytes)`` of one substep of ``n_batch`` rollouts."""
    n = config["width"] * config["height"]
    flops = (FLOPS_FIXED + iterations * FLOPS_PER_ITERATION) * n * n_batch
    return flops, 4.0 * (12 * n * n_batch + 3 * n)
