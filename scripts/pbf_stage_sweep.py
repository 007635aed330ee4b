#!/usr/bin/env python3
"""B3 and B4 per launch at the 100k dam of ``bench.py --fluid`` for other
staging buffer sizes, and with parts of their work taken out, on the
card.

Run from the root of the repository on a machine with the card:

    python3 scripts/pbf_stage_sweep.py

Each variant is ``csrc/pbf_cells.cu`` with ``kStageFluid``,
``kStageBoundary`` and ``kMinBlocks`` replaced, built into the package's
build directory with the port's ``nvcc`` flags and timed with CUDA events
(100 launches after a warm-up) on the tables of the dam's 11th step,
first iteration, beside its registers, shared memory and resident blocks
an SM. The variants run in turns, the shipped sizes first and last, so
that a drift of the card shows.

The ablations keep the shipped sizes and drop work, so their results are
wrong and only their times count: ``no_walk`` tests every candidate but
walks no pair (the walk runs only for a mask no lane can hold), and
``staging_only`` stages the neighbourhood and skips the tests and walks
(the pair pass returns at once). Their differences to the full kernel
split its time into staging and the rest, tests, and walks.

A measurement tool outside the tests: it edits the kernel source by exact
text anchors, which fit the source it was written with, and stops with
an error naming the anchor where a later edit of the kernel moved one.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (fluid candidates, boundary candidates, blocks an SM, ablation)
VARIANTS = [(256, 128, 20, None), (192, 96, 24, None), (128, 64, 32, None),
            (256, 128, 20, "no_walk"), (256, 128, 20, "staging_only"),
            (256, 128, 20, None)]
ABLATIONS = {
    "no_walk": ("    while (mask) {\n",
                "    if (mask == 0x5555555555555555ull) {\n"),
    "staging_only": ("  for (int base = L.sub; base < n; base += kTests * L.g) {",
                     "  return;\n  for (int base = L.sub; base < n; "
                     "base += kTests * L.g) {"),
}


def variant_source(src: str, fluid: int, boundary: int, blocks: int,
                   ablate=None) -> str:
    for name, value in (("kStageFluid", fluid),
                        ("kStageBoundary", boundary),
                        ("kMinBlocks", blocks)):
        src, n = re.subn(rf"(constexpr int {name} = )\d+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once")
    if ablate is not None:
        old, new = ABLATIONS[ablate]
        if src.count(old) != 1:
            raise RuntimeError(f"{ablate}: anchor not found once")
        src = src.replace(old, new)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("pbf_stage_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    _build.build_all()
    src = (_build.CSRC / "pbf_cells.cu").read_text()
    dev = torch.device("cuda", torch.cuda.current_device())
    scene, fluid = cs.dam_scene(cs.DAM, dev)
    state = fm.FluidState.create(fluid, device=dev)
    step = fm.make_fluid_step_fn(scene)
    for _ in range(10):
        state = step(state)
    pi = cs.PassInputs(scene, state)
    args = fcc._cells_args(pi.spec, pi.xt, pi.xt, pi.mt, pi.count,
                           *pi.cells())
    lam_t, dens_t = torch.zeros_like(pi.mt), torch.zeros_like(pi.mt)
    x_out = pi.xt.clone()
    p = pi.params.ctypes.data
    rows = []
    for k, (fl, bd, blocks, ablate) in enumerate(VARIANTS):
        cu = _build.BUILD_DIR / f"pbf_sweep_{k}.cu"
        so = _build.BUILD_DIR / f"libpbf_sweep_{k}_{os.getpid()}.so"
        cu.write_text(variant_source(src, fl, bd, blocks, ablate))
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(so), str(cu)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        b3, b4, _ = fcc._bind(lib)
        res = {}
        for which, name in enumerate(("b3", "b4")):
            vals = (ctypes.c_int * 4)()
            lib.pbd_pbf_kernel_resources(which, vals)
            res[name] = list(vals)

        def run_b3():
            fcc._launch("b3", b3, lib, args + [lam_t.data_ptr(),
                                               dens_t.data_ptr(), p], dev)

        def run_b4():
            fcc._launch("b4", b4, lib, args + [lam_t.data_ptr(),
                                               x_out.data_ptr(), p], dev)

        rows.append({"stage_fluid": fl, "stage_boundary": bd,
                     "min_blocks": blocks, "ablation": ablate,
                     "b3_ms": cs.cuda_time_ms(run_b3, 100),
                     "b4_ms": cs.cuda_time_ms(run_b4, 100),
                     "regs_smem_local_blocks": res})
        so.unlink()
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "variants": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
