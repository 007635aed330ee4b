"""Greedy graph colouring of constraint batches (host-side, build time).

A copy of ``positionbaseddynamics_tpu/solver/coloring.py``: the reference
partitions its constraint list into groups where no two members share a
body (``SimulationModel::initConstraintGroups``,
``SimulationModel.cpp:1033-1094``, greedy first-fit over insertion
order). The colours let the projector run an exact coloured Gauss-Seidel
(a scatter within a colour is free of conflicts, so it equals sequential
application); the Jacobi mode ignores them.
"""
from __future__ import annotations

import numpy as np


def greedy_color(idx: np.ndarray) -> tuple[np.ndarray, int]:
    """First-fit greedy colouring in row order.

    ``idx (C, k)``: item indices used by each constraint. Two constraints
    conflict iff they share an item. Returns ``(color (C,) int32,
    n_colors)``; an empty set has one colour.
    """
    idx = np.asarray(idx)
    c = idx.shape[0]
    if c == 0:
        return np.zeros((0,), np.int32), 1
    # Python ints in the hot loop: arbitrary-precision bitmasks beat
    # per-element numpy indexing for the 1e5-1e6 rows of a large scene
    rows = idx.tolist()
    n_items = int(idx.max()) + 1
    used = [0] * n_items                # bitmask of colours used at each item
    colors = [0] * c
    max_color = 0
    for i, items in enumerate(rows):
        mask = 0
        for it in items:
            mask |= used[it]
        color = 0
        while (mask >> color) & 1:
            color += 1
        colors[i] = color
        if color > max_color:
            max_color = color
        bit = 1 << color
        for it in items:
            used[it] |= bit
    return np.asarray(colors, np.int32), max_color + 1
