"""Work of one step of a position-based-fluid dam, counted from the
configuration alone: the pairs of the block at rest, whatever implements
the step.

Pairs: every ordered fluid–fluid pair and every fluid–boundary pair
closer than the support ``4r``, counted by :func:`rest_pairs` on the rest
block and the box, their positions and distances in float64 (at the
98,784-particle dam, 2,453,632 fluid pairs, 26 a particle inside the
block, and 156,602 boundary pairs). A pair at exactly the support does no work
(``W`` and ``∇W`` vanish there) and is not counted, whatever the rounding
of its distance (in float32 positions, 222,264 fluid pairs two spacings
apart would read closer than the support). A running dam
compresses and splashes, so its real pairs differ from these by some
percent; the count is fixed so that the metric moves with the program's
time alone.

float32 operations (frozen from ``chip_smoke.py``'s counts of
``csrc/pbf_cells.cu``, ``PBF_PAIR_OPS`` and ``PBF_SLOT_OPS``): a density
and λ pass (B3) 44 a pair, fluid or boundary, and 15 a particle; a
correction pass (B4) 31 a fluid pair, 30 a boundary pair, 6 a particle;
the XSPH pass (B5) 31 a fluid pair and 6 a particle. A step runs
``iterations`` of B3 and B4 and one B5. The tests of candidate pairs that
lie beyond the support are not counted: how many there are depends on the
search's cells, not on the step.

Bytes: each pass reads its inputs once and writes its outputs once, as
``chip_smoke.py`` counts them: floats a particle read and written 7 + 2
(B3: x, the step's start x0, m; λ, ρ), 8 + 3 (B4: x, x0, m, λ; x), 11 + 3
(B5: x, x0, m, v, ρ; v), and each boundary particle's position and ψ
read once by B3 and once by B4.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import torch

from benchmark.reference import pbf_dam as ref

PARTICLE_FLOPS = {"density_lambda": 15, "corrections": 6, "xsph": 6}
FLUID_PAIR_FLOPS = {"density_lambda": 44, "corrections": 31, "xsph": 31}
BOUNDARY_PAIR_FLOPS = {"density_lambda": 44, "corrections": 30, "xsph": 0}
PARTICLE_FLOATS = {"density_lambda": 9, "corrections": 11, "xsph": 14}
BOUNDARY_FLOATS = {"density_lambda": 4, "corrections": 4, "xsph": 0}
# a pair at the support by float64 rounding alone is not counted
SUPPORT_SHRINK = 1.0 - 1e-9


@functools.lru_cache(maxsize=8)
def _rest_pairs(geometry: str):
    config = json.loads(geometry)
    x = torch.as_tensor(ref.fluid_points(config, np.float64))
    xb = torch.as_tensor(ref.boundary_points(config, np.float64))
    h = ref.support(config) * SUPPORT_SHRINK
    fluid = len(ref.pairs(x, x, h, same=True)[0])
    boundary = len(ref.pairs(x, xb, h, same=False)[0])
    return len(x), len(xb), fluid, boundary


def rest_pairs(config: dict):
    """``(fluid particles, boundary particles, fluid pairs, boundary
    pairs)`` of the configuration's block at rest."""
    keys = ("particle_radius", "support_factor", "block",
            "block_origin_spacings", "box_spacings")
    return _rest_pairs(json.dumps({k: config[k] for k in keys},
                                  sort_keys=True))


def substep(config: dict, n_batch: int, iterations: int):
    """``(flops, bytes)`` of one step of ``n_batch`` dams at
    ``iterations`` density iterations (the fluid step has no substeps)."""
    n, nb, fluid, boundary = rest_pairs(config)
    flops = nbytes = 0.0
    for p, times in (("density_lambda", iterations),
                     ("corrections", iterations), ("xsph", 1)):
        flops += times * (PARTICLE_FLOPS[p] * n + FLUID_PAIR_FLOPS[p] * fluid
                          + BOUNDARY_PAIR_FLOPS[p] * boundary)
        nbytes += times * 4.0 * (PARTICLE_FLOATS[p] * n
                                 + BOUNDARY_FLOATS[p] * nb)
    return n_batch * flops, n_batch * nbytes
