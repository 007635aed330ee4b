#!/usr/bin/env python3
"""The fused cloth substep kernel (B1) per launch at the 320×320 bench
cloth for other tile shapes, on the card.

Run from the root of the repository on a machine with the card:

    python3 scripts/cloth_tile_sweep.py [--source FILE] [--rollouts N ...]

Each variant is ``csrc/grid_cloth_step.cu`` (or FILE, another version of
it with the same C interface) with its tile width ``TX`` and height ``TY``
replaced, and, where the source has it, ``kExtraCells``, the cells a
thread owns beyond the iterations, built into the package's build
directory with the port's ``nvcc`` flags, and timed under
``torch.profiler`` (200 launches after a warm-up; 20 above 4 rollouts)
on the bench cloth's first substep at 1 iteration, at 1 and 4 rollouts
or the counts ``--rollouts`` names (256 is ``bench.py --mpc-big``'s
planner). Beside each time it
prints the tile's halo factor (cells a block loads over cells it
writes), the blocks of one rollout, the registers, shared memory,
resident blocks an SM and threads a block at 1 iteration as the runtime
reports them, and the largest deviation from the package's kernel's
output. A variant that the card refuses (too much shared memory or too
many threads at some iteration count) is reported with its error. The
variants run in turns, the shipped shape first and last, so that a
drift of the card shows.

A measurement tool outside the tests: it edits the kernel source by exact
text anchors, which fit the source it was written with, and stops with
an error naming the anchor where a later edit of the kernel moved one;
``tests/test_torch_pbf_tooling.py`` checks the anchors on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (TX, TY, kExtraCells or None to leave the source's)
SHIPPED = (32, 16, None)
VARIANTS = [SHIPPED, (32, 8, None), (64, 8, None), (16, 16, None),
            (64, 4, None), (16, 8, None), (32, 16, 1), (32, 16, 2),
            (40, 16, 0), (40, 20, 1), (32, 32, 1), SHIPPED]


def variant_source(src: str, tx: int, ty: int, extra=None) -> str:
    edits = [("TX", tx), ("TY", ty)]
    if extra is not None:
        edits.append(("kExtraCells", extra))
    for name, value in edits:
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};",
                         src)
        if n != 1:
            raise RuntimeError(f"{name}: anchor not found once")
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=None,
                    help="the kernel source to vary (default: csrc's)")
    ap.add_argument("--rollouts", type=int, nargs="+", default=[1, 4],
                    help="rollout counts (n_batch) to time each tile at")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cloth_tile_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    _build.build_all()
    path = args.source or _build.CSRC / "grid_cloth_step.cu"
    src = path.read_text()
    variants = [v for v in VARIANTS
                if v[2] is None or "constexpr int kExtraCells" in src]
    dev = torch.device("cuda", torch.cuda.current_device())
    g = cs.GRID
    state, cset = cs.cloth_scene(g, g, dev)
    gc, p = cset.grid_cloths[0], state.particles
    params = gcc.kernel_params(gc, h=0.001)
    w = p.inv_mass.reshape(g, g).contiguous()
    icd = gc.inv_cnt_dist.reshape(g, g).contiguous()
    icb = gc.inv_cnt_bend.reshape(g, g).contiguous()
    planes = {nb: (gcc.to_planes(torch.stack([p.x] * nb), g, g),
                   gcc.to_planes(torch.stack([p.v] * nb), g, g))
              for nb in sorted(set(args.rollouts) | {4})}
    # the package kernel's output at 4 rollouts, to hold each variant to
    ref = gcc.cloth_substep_cuda(*planes[4], w, icd, icb, params)[0]
    rows = []
    for k, (tx, ty, extra) in enumerate(variants):
        cu = _build.BUILD_DIR / f"cloth_sweep_{k}.cu"
        so = _build.BUILD_DIR / f"libcloth_sweep_{k}_{os.getpid()}.so"
        cu.write_text(variant_source(src, tx, ty, extra))
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(so), str(cu)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        fn = gcc._bind(lib)
        r = 3
        row = {"tile": [tx, ty], "extra_cells": extra,
               "halo_factor": (tx + 2 * r) * (ty + 2 * r) / (tx * ty),
               "blocks_b1": -(-g // tx) * -(-g // ty)}
        try:
            row["resources_it1"] = gcc.resources_of(lib, 1)
        except RuntimeError as e:
            row["resources_it1"] = str(e)
        for nb in args.rollouts:
            xp, vp = planes[nb]
            xo, vo = torch.empty_like(xp), torch.empty_like(vp)

            def run():
                stream = torch.cuda.current_stream(dev).cuda_stream
                e = fn(xp.data_ptr(), vp.data_ptr(), None, None,
                       xo.data_ptr(), vo.data_ptr(), None, w.data_ptr(), 0,
                       icd.data_ptr(), icb.data_ptr(), params.ctypes.data,
                       nb, g, g, 1, 0, g, stream)
                if e != 0:
                    raise RuntimeError(lib.pbd_error_string(e).decode())

            try:
                ms = cs.device_ms(run, 200 if nb <= 4 else 20,
                                  "cloth_substep_kernel")
                row[f"us_b{nb}"] = None if ms is None else ms * 1e3
                if nb == 4:
                    torch.cuda.synchronize()
                    row["max_abs_dev_from_shipped"] = cs.max_dev(xo, ref)
            except RuntimeError as e:
                row[f"us_b{nb}"] = f"refused: {e}"
        rows.append(row)
        so.unlink()
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "source": str(path), "variants": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
