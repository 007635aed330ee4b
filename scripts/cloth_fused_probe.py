#!/usr/bin/env python3
"""The fused cloth kernel (B1's fused and row-window modes) per launch on
the card, beside five per-substep launches and beside another version of
the kernel source, timed in turns.

Run from the root of the repository on a machine with the card:

    python3 scripts/cloth_fused_probe.py --parent FILE [--out FILE]

FILE is a version of ``csrc/grid_cloth_step.cu`` whose fused entry
``pbd_cloth_fused`` takes no scratch (the grown-halo design, one window of
halo 3·passes a block), e.g. ``git show <commit>:positionbaseddynamics_tpu_
torch/csrc/grid_cloth_step.cu``. Both sources are built at once with the
port's ``nvcc`` flags into the package's build directory. On the bench
cloth (320×320, 5 substeps of one iteration, dt 0.005) at 1, 4 and 256
rollouts and on the 116-row window of ``chip_smoke.py``'s rank 1 (80 rows
and 18 each side at global row 62) it prints:

* whether the package's fused launch equals five of its per-substep
  launches and the other source's fused launch, bit for bit in x and v,
  over one step;
* each fused launch's device time (``torch.profiler``; CUDA events where
  the profiler records none) and each source's per-substep launch
  (``substeps_ms``, ``old_substeps_ms``: one launch of the five a step),
  in turns (package, other, other, package), so that a drift of the card
  shows, the fused launch over five per-substep launches, and the bound
  of ``chip_smoke.fused_bound``;
* the package's fused grid, the registers, shared memory, spills and
  resident blocks of both sources' fused and one-iteration kernels as the
  runtime and ``ptxas`` report them.

The JSON goes to stdout, and to the file ``--out`` names.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROLLOUTS = (1, 4, 256)
TIMED = {1: 200, 4: 100, 256: 4}        # fused launches a timing
SUBSTEPS = 5
RANKS = 4                               # the window: rank 1 of 4


def build(sources: dict) -> dict:
    """Build ``{tag: source text}`` at once; ``{tag: (CDLL, ptxas)}``."""
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in sources.items():
        cu = _build.BUILD_DIR / f"cloth_fused_probe_{tag}.cu"
        so = _build.BUILD_DIR / f"libcloth_fused_probe_{tag}_{os.getpid()}.so"
        cu.write_text(text)
        procs[tag] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed\n{log}")
        out[tag] = (ctypes.CDLL(str(so)), cs.ptxas_report({tag: log})[0])
        so.unlink()
    return out


def bind_parent(lib):
    """The other source's C interface: ``pbd_cloth_substep`` as the
    package's, ``pbd_cloth_fused`` without scratch and
    ``pbd_cloth_fused_resources(passes, out)``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pbd_cloth_substep.argtypes = [vp] * 8 + [ctypes.c_longlong] + \
        [vp] * 3 + [ci] * 6 + [vp]
    lib.pbd_cloth_substep.restype = ci
    lib.pbd_cloth_fused.argtypes = [vp] * 5 + [ctypes.c_longlong] + \
        [vp] * 3 + [ci] * 7 + [vp]
    lib.pbd_cloth_fused.restype = ci
    lib.pbd_cloth_fused_resources.argtypes = [ci, vp]
    lib.pbd_cloth_fused_resources.restype = ci
    lib.pbd_cloth_kernel_resources.argtypes = [ci, vp]
    lib.pbd_cloth_kernel_resources.restype = ci
    lib.pbd_error_string.argtypes = [ci]
    lib.pbd_error_string.restype = ctypes.c_char_p


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="the other version of grid_cloth_step.cu")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cloth_fused_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.parallel import intra_cuda
    from positionbaseddynamics_tpu_torch.solver import StepConfig
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    libs = build({"package": (_build.CSRC / "grid_cloth_step.cu").read_text(),
                  "parent": args.parent.read_text()})
    new, new_ptxas = libs["package"]
    old, old_ptxas = libs["parent"]
    gcc._bind(new)
    bind_parent(old)

    dev = torch.device("cuda", torch.cuda.current_device())
    g = cs.GRID
    state, cset = cs.cloth_scene(g, g, dev)
    gc, p = cset.grid_cloths[0], state.particles
    params = gcc.kernel_params(gc, h=0.005 / SUBSTEPS)
    planes = [p.inv_mass.reshape(g, g), gc.inv_cnt_dist.reshape(g, g),
              gc.inv_cnt_bend.reshape(g, g)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(lib, err):
        if err != 0:
            raise RuntimeError(lib.pbd_error_string(err).decode())

    def runners(xp, vp, w, icd, icb, off, gh):
        """The four launches of one configuration, each ``() -> (x, v)``
        from the same input."""
        b, _, h, wd = xp.shape
        scratch = gcc.FusedScratch()
        grid = ctypes.c_int(0)

        def new_fused():
            xo, vo = torch.empty_like(xp), torch.empty_like(vp)
            bufs = scratch.get(xp, SUBSTEPS, 1)
            check(new, new.pbd_cloth_fused(
                xp.data_ptr(), vp.data_ptr(), xo.data_ptr(), vo.data_ptr(),
                *(None if t is None else t.data_ptr() for t in bufs),
                w.data_ptr(), 0, icd.data_ptr(), icb.data_ptr(),
                params.ctypes.data, b, h, wd, 1, SUBSTEPS, off, gh,
                ctypes.byref(grid), stream))
            return xo, vo

        def old_fused():
            xo, vo = torch.empty_like(xp), torch.empty_like(vp)
            check(old, old.pbd_cloth_fused(
                xp.data_ptr(), vp.data_ptr(), xo.data_ptr(), vo.data_ptr(),
                w.data_ptr(), 0, icd.data_ptr(), icb.data_ptr(),
                params.ctypes.data, b, h, wd, 1, SUBSTEPS, off, gh, stream))
            return xo, vo

        def substeps(lib):
            def run():
                x, v = xp, vp
                for _ in range(SUBSTEPS):
                    xo, vo = torch.empty_like(x), torch.empty_like(v)
                    check(lib, lib.pbd_cloth_substep(
                        x.data_ptr(), v.data_ptr(), None, None,
                        xo.data_ptr(), vo.data_ptr(), None, w.data_ptr(), 0,
                        icd.data_ptr(), icb.data_ptr(), params.ctypes.data,
                        b, h, wd, 1, off, gh, stream))
                    x, v = xo, vo
                return x, v
            return run

        return ({"fused": new_fused, "old_fused": old_fused,
                 "substeps": substeps(new), "old_substeps": substeps(old)},
                grid)

    def measure(name, xp, vp, w, icd, icb, off, gh, n):
        fns, grid = runners(xp, vp, w, icd, icb, off, gh)
        outs = {k: f() for k, f in fns.items()}
        torch.cuda.synchronize()
        row = {"grid": grid.value,
               "capacity": gcc.fused_capacity(),
               "items": gcc.fused_items(xp.shape[0], xp.shape[2],
                                        xp.shape[3])}
        for other in ("substeps", "old_fused", "old_substeps"):
            row[f"bit_equal_{other}"] = bool(
                torch.equal(outs["fused"][0], outs[other][0])
                and torch.equal(outs["fused"][1], outs[other][1]))
            row[f"max_dx_{other}"] = cs.max_dev(outs["fused"][0],
                                                outs[other][0])
        del outs
        # device time a launch: the fused launch, one per-substep launch
        names = {"fused": "cloth_fused_kernel",
                 "old_fused": "cloth_substep_kernel",
                 "substeps": "cloth_substep_kernel",
                 "old_substeps": "cloth_substep_kernel"}
        # in turns: package, parent, parent, package
        for turn, keys in enumerate((("fused", "substeps"),
                                     ("old_fused", "old_substeps"),
                                     ("old_fused", "old_substeps"),
                                     ("fused", "substeps"))):
            for key in keys:
                fn = fns[key]
                ms = cs.device_ms(fn, n, names[key])
                src = "profiler"
                if ms is None:
                    ms, src = cs.cuda_time_ms(fn, n), "cuda events"
                row.setdefault(f"{key}_ms", []).append(ms)
                row[f"{key}_source"] = src
        for key in ("fused", "old_fused"):
            row[f"{key}_over_five_substeps"] = [
                a / (SUBSTEPS * b)
                for a, b in zip(row[f"{key}_ms"], row["substeps_ms"])]
        row["interval_ms"] = cs.cuda_time_ms(fns["fused"], n)
        print(f"{name}: {row}", file=sys.stderr, flush=True)
        return row

    out = {"device": torch.cuda.get_device_name(dev),
           "nvidia_smi": cs.nvidia_smi_line(), "parent": str(args.parent),
           "resources": {
               "fused": gcc.fused_resources_of(new),
               "substep_it1": gcc.resources_of(new, 1),
               "parent_fused_p5": gcc._resources(
                   old, old.pbd_cloth_fused_resources, 5),
               "parent_substep_it1": gcc.resources_of(old, 1)},
           "ptxas": {"package": new_ptxas, "parent": old_ptxas},
           "configs": {}}
    print(json.dumps(out["resources"]), file=sys.stderr, flush=True)
    w, icd, icb = (a.contiguous() for a in planes)
    for nb in ROLLOUTS:
        x = p.x.expand(nb, *p.x.shape).clone()
        v = torch.zeros_like(x)
        v[..., 2] = 0.05 * torch.arange(nb, device=dev)[:, None] / max(
            nb - 1, 1)
        xp, vp = gcc.to_planes(x, g, g), gcc.to_planes(v, g, g)
        row = measure(f"n_batch {nb}", xp, vp, w, icd, icb, 0, g, TIMED[nb])
        row["bound_ms"], row["bound_by"] = cs.fused_bound(nb)
        row["substep_bound_ms"] = SUBSTEPS * cs.fused_bound(nb,
                                                            substeps=1)[0]
        out["configs"][f"b{nb}"] = row
        del x, v, xp, vp
        torch.cuda.empty_cache()
    r_loc = g // RANKS
    exch = intra_cuda.exchange_rows(StepConfig())
    rows, off = r_loc + 2 * exch, r_loc - exch

    def cut(a):
        o = a.new_zeros((rows,) + tuple(a.shape[1:]))
        o[:] = a[off:off + rows]
        return o

    xe = cut(p.x.reshape(g, g, 3))
    ve = cut(p.v.reshape(g, g, 3))
    we, icde, icbe = (cut(a).contiguous() for a in planes)
    row = measure(f"window of {rows} rows", gcc.to_planes(xe, rows, g),
                  gcc.to_planes(ve, rows, g), we, icde, icbe, off, g,
                  TIMED[1])
    row["rows"], row["row_offset"] = rows, off
    row["bound_ms"], row["bound_by"] = cs.fused_bound(1, rows=rows)
    out["configs"]["window"] = row
    text = json.dumps(out, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    ok = all(r["bit_equal_substeps"] and r["bit_equal_old_fused"]
             for r in out["configs"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
