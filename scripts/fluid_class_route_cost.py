#!/usr/bin/env python3
"""What JAX's occupancy-class route costs a step of the ``bench.py
--fluid`` dam on the card, beside the kernel route.

The class route is ``fluids/classgrid.py``, plain PyTorch in the port,
taken by ``_fluid_step_cells(partition=True)``; the kernel route is the
default on CUDA tensors (B3-B5 of ``csrc/pbf_cells.cu``). Run from the
root of the repository on a machine with the card:

    python3 scripts/fluid_class_route_cost.py [--steps 5] [--dims 80 50 25]

Both routes step the same dam, from the same state one kernel step in,
for ``--steps`` steps each, the kernel route first. Prints one JSON line:
for each route the device time of a step (CUDA events around each step;
median, lowest, highest), the host time of a step (the card synchronised
after each step), the peak device memory of its steps, and the largest
position difference between the routes after the steps; then the card's
``nvidia-smi`` line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dims", type=int, nargs=3, default=(80, 50, 25))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fluid_class_route_cost: needs a CUDA card", file=sys.stderr)
        return 1
    import bench_torch
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    dev = torch.device("cuda")
    scene, fluid = bench_torch.dam_scene(args.dims, dev)
    start = fm._fluid_step_cells(fm.FluidState.create(fluid, device=dev),
                                 scene)
    out = {"dims": list(args.dims), "steps": args.steps}
    finals = {}
    for route, partition in (("kernel", None), ("classes", True)):
        state = start
        fm._fluid_step_cells(state, scene, partition=partition)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dev_ms, host_ms = [], []
        for _ in range(args.steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            state = fm._fluid_step_cells(state, scene, partition=partition)
            e1.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(e0.elapsed_time(e1))
        finals[route] = state
        out[route] = {
            "event_ms_median": statistics.median(dev_ms),
            "event_ms_min": min(dev_ms), "event_ms_max": max(dev_ms),
            "host_ms_median": statistics.median(host_ms),
            "peak_bytes_above_start": torch.cuda.max_memory_allocated()
            - base,
            "overflow": finals[route].overflow.item(),
            "finite": bool(torch.isfinite(finals[route].x).all())}
    out["x_max_abs_diff"] = (finals["kernel"].x
                             - finals["classes"].x).abs().max().item()
    out["classes_over_kernel"] = (out["classes"]["event_ms_median"]
                                  / out["kernel"]["event_ms_median"])
    print(json.dumps(out), flush=True)
    print(bench_torch.card_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
