#!/usr/bin/env python3
"""How far the fused cloth substep (B1) and its plain version each stray
from the same plain version in float64, on the card.

Run from the root of the repository on a machine with the card:

    python3 scripts/cloth_precision_probe.py

A 64×64 cloth of the bench's constraints (two pinned corners, XPBD
distance 1e5, isometric bending 0.05) at four rollouts, each started from
its own seeded jitter of every free particle (amplitude 1 cm, 1 mm and 0;
velocities ten times the amplitude a second), stepped 10 steps of 5
substeps by the kernel (``make_cloth_step``, ``n_batch`` 4), by the plain
version in float32 and by the plain version in float64. Prints, step by
step, max|Δx| of kernel against plain float32, of kernel against float64
and of plain float32 against float64, beside the card's ``nvidia-smi``
line: a kernel that stays closer to the float32 plain version than that
version stays to float64 differs from it by rounding, not by its logic.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("cloth_precision_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    dev = torch.device("cuda", torch.cuda.current_device())
    print(cs.nvidia_smi_line())
    state, cset = cs.cloth_scene(64, 64, dev)
    g, p = cset.grid_cloths[0], state.particles
    gen = torch.Generator(device=dev).manual_seed(3)
    free = (p.inv_mass > 0).to(torch.float32)[:, None]
    step = gcc.make_cloth_step(g, p.inv_mass, g.inv_cnt_dist,
                               g.inv_cnt_bend, dt=0.005, substeps=5,
                               n_batch=4)
    for amp in (1e-2, 1e-3, 0.0):
        x = p.x + amp * free * torch.randn((4,) + tuple(p.x.shape),
                                           generator=gen, device=dev)
        v = 10 * amp * free * torch.randn((4,) + tuple(p.v.shape),
                                          generator=gen, device=dev)
        xk, vk, xr, vr = x, v, x, v
        xd, vd = x.double(), v.double()
        for s in range(10):
            xk, vk = step(xk, vk)
            for _ in range(5):
                xr, vr = gcc.cloth_substep_reference(g, xr, vr, p.inv_mass,
                                                     h=1e-3)
                xd, vd = gcc.cloth_substep_reference(
                    g, xd, vd, p.inv_mass.double(), h=1e-3)
            print(f"jitter {amp} step {s + 1}: kernel-plain32 "
                  f"{cs.max_dev(xk, xr):.3e} kernel-plain64 "
                  f"{cs.max_dev(xk.double(), xd):.3e} plain32-plain64 "
                  f"{cs.max_dev(xr.double(), xd):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
