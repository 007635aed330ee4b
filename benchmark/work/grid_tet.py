"""Work of one substep of a regular W×H×D XPBD FEM-tet bar, counted from
shapes (frozen from ``chip_smoke.py``'s counts of
``csrc/grid_tet_step.cu``).

float32 operations: per tet and iteration, edge vectors 9, F 45, strain
39, trace 3, stress input 12, stress 45, energy 22, gradients 63, C 3,
denominator 30, Δλ 11, corrections 28; per cell and iteration the gather
adds its 24 sums once; per vertex and iteration ``x + inv_cnt·dx``, 6;
per vertex and substep the integration 12 and the velocity update 6.
The halo a block solves or integrates again is not counted.

Bytes: each rollout's 6 state planes read once and written once, and the
inverse masses and Jacobi weights read once for all rollouts.
"""
from __future__ import annotations

FLOPS_PER_TET = 9 + 45 + 39 + 3 + 12 + 45 + 22 + 63 + 3 + 30 + 11 + 28
FLOPS_PER_CELL = 5 * FLOPS_PER_TET + 24
FLOPS_PER_VERTEX = 6
FLOPS_FIXED = 12 + 6


def substep(config: dict, n_batch: int, iterations: int):
    """``(flops, bytes)`` of one substep of ``n_batch`` rollouts."""
    w, h, d = config["width"], config["height"], config["depth"]
    n_vert, n_cells = w * h * d, (w - 1) * (h - 1) * (d - 1)
    flops = n_batch * (iterations * (FLOPS_PER_CELL * n_cells
                                     + FLOPS_PER_VERTEX * n_vert)
                       + FLOPS_FIXED * n_vert)
    return flops, 4.0 * (12 * n_batch + 2) * n_vert
