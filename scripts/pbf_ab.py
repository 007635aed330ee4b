#!/usr/bin/env python3
"""The PBF kernels (B3, B4, B5) of two versions of ``csrc/pbf_cells.cu``
per launch on the same tables, on the card, at the 100k dam of
``bench.py --fluid``.

Run from the root of the repository on a machine with the card:

    python3 scripts/pbf_ab.py OTHER_SOURCE

OTHER_SOURCE is another version of ``pbf_cells.cu`` with the same C
interface (for example the parent commit's, from ``git show``). Both are
built with the port's ``nvcc`` flags into the package's build directory
and timed under ``torch.profiler`` (100 launches after a warm-up) on the
tables of the dam's 11th step, first iteration, in turns: other, this,
this, other, so that a drift of the card shows. It prints each time and
the largest difference between the two versions' outputs.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NAMES = ("pbf_density_lambda", "pbf_corrections", "pbf_xsph")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("pbf_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for tag, path in (("this", _build.CSRC / "pbf_cells.cu"),
                      ("other", Path(sys.argv[1]))):
        cu = _build.BUILD_DIR / f"pbf_ab_{tag}.cu"
        so = _build.BUILD_DIR / f"libpbf_ab_{tag}_{os.getpid()}.so"
        cu.write_text(path.read_text())
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(so), str(cu)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        libs[tag] = ctypes.CDLL(str(so))
        so.unlink()

    dev = torch.device("cuda", torch.cuda.current_device())
    scene, fluid = cs.dam_scene(cs.DAM, dev)
    state = fm.FluidState.create(fluid, device=dev)
    step = fm.make_fluid_step_fn(scene)
    for _ in range(10):
        state = step(state)
    pi = cs.PassInputs(scene, state)
    args = fcc._cells_args(pi.spec, pi.xt, pi.xt, pi.mt, pi.count,
                           *pi.cells())
    p = pi.params.ctypes.data
    outs = {tag: (torch.zeros_like(pi.mt), torch.zeros_like(pi.mt),
                  pi.xt.clone(), pi.vt.clone()) for tag in libs}

    def runs(tag):
        lib = libs[tag]
        b3, b4, b5 = fcc._bind(lib)
        lam, dens, x_out, v_out = outs[tag]
        return {
            "pbf_density_lambda": lambda: fcc._launch(
                "b3", b3, lib, args + [lam.data_ptr(), dens.data_ptr(), p],
                dev),
            "pbf_corrections": lambda: fcc._launch(
                "b4", b4, lib, args + [lam.data_ptr(), x_out.data_ptr(), p],
                dev),
            "pbf_xsph": lambda: fcc._launch(
                "b5", b5, lib, args + [pi.vt.data_ptr(), dens.data_ptr(),
                                       v_out.data_ptr(), p], dev)}

    rows = []
    for tag in ("other", "this", "this", "other"):
        row = {"source": tag}
        for name, fn in runs(tag).items():
            ms = cs.device_ms(fn, 100, name + "_kernel")
            row[name + "_us"] = None if ms is None else ms * 1e3
        rows.append(row)
    torch.cuda.synchronize()
    names = ("lambda", "density", "x_out", "v_out")
    diff = {n: cs.max_dev(a, b)
            for n, a, b in zip(names, outs["this"], outs["other"])}
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "other": sys.argv[1], "runs": rows,
                      "max_abs_diff_this_vs_other": diff}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
