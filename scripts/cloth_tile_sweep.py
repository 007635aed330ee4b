#!/usr/bin/env python3
"""The cloth substep kernel (B1) per launch at the 320×320 bench cloth for
other tile shapes, for both of its one-iteration tiles, on the card.

Run from the root of the repository on a machine with the card:

    python3 scripts/cloth_tile_sweep.py [--source FILE] [--rollouts N ...]
                                        [--grids SIDE ...]
                                        [--kernels substep wide]

Each variant is ``csrc/grid_cloth_step.cu`` (or FILE, another version of
it with the same C interface) with one of its tiles replaced, built
into the package's build directory with the port's ``nvcc`` flags (all
variants at once), and timed under ``torch.profiler`` (200 launches after
a warm-up; 20 above 4 rollouts) on the bench cloth's first substep at 1
iteration, at the rollout counts ``--rollouts`` names (default 1, 4, 16,
64 and 256; 256 is the planner's, ``bench.py --mpc-big``), each rollout
its own seeded jitter of the free particles, on square cloths of the sides
``--grids`` names (default the bench cloth's 320; 32 is ``bench.py
--mpc``'s, 64 the planner route check's), one row a variant and side.

* ``substep``, the small tile (``cloth_substep_kernel``, which every launch
  but the wide ones takes): its width ``TX`` and height ``TY`` and, where
  the source has it, ``kExtraCells``, the cells a thread owns beyond the
  iterations.
* ``wide``, the wide tile (``cloth_wide_kernel``, which launches at many
  rollouts take, ``grid_cloth_cuda.takes_wide``): ``kWideTX`` ×
  ``kWideTY`` and the cells a thread owns, ``kWideCells``.

Beside each time it prints the tile's halo factor (cells a block solves
over cells it writes), the items of one rollout, the registers, shared
memory, resident blocks an SM and threads a block as the runtime reports
them, and whether the output equals the package's small tile bit for
bit (x and v; the small tile's variants at 4 rollouts, the wide ones at
every count), else the largest deviation of x. For the wide variants it
also prints each count's items over the blocks the card holds at once:
``grid_cloth_cuda.WIDE_FILL`` lies between the fills where the wide
tile's times fall below the small tile's and where they do not. A variant
that the card refuses (too much shared memory or too many threads) is
reported with its error. The variants run in turns, the shipped small
tile first and last (the package's own build where only the wide tile
varies), so that a drift of the card shows.

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
            (40, 16, 0), (40, 20, 1), (32, 32, 1), (48, 32, 2), (32, 48, 2),
            (64, 24, 2), (64, 32, 2), (40, 32, 1), (64, 16, 1), (48, 24, 1),
            SHIPPED]
# the wide tile's (kWideTX, kWideTY, kWideCells)
WIDE_VARIANTS = [(40, 40, 3), (32, 32, 2), (40, 32, 2), (32, 40, 2),
                 (40, 36, 2), (48, 32, 3), (64, 24, 3), (48, 24, 2),
                 (64, 16, 2)]
R = 3                       # the halo at one iteration


def _edit(src: str, edits) -> str:
    for name, value in edits:
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};",
                         src)
        if n != 1:
            raise RuntimeError(f"{name}: anchor not found once")
    return src


def variant_source(src: str, tx: int, ty: int, extra=None) -> str:
    """The source with the small tile ``tx`` × ``ty`` and, unless
    None, ``extra`` cells a thread beyond the iterations."""
    edits = [("TX", tx), ("TY", ty)]
    if extra is not None:
        edits.append(("kExtraCells", extra))
    return _edit(src, edits)


def wide_variant_source(src: str, tx: int, ty: int, cells: int) -> str:
    """The source with the wide tile ``tx`` × ``ty`` and ``cells`` cells a
    thread."""
    return _edit(src, [("kWideTX", tx), ("kWideTY", ty),
                       ("kWideCells", cells)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=None,
                    help="the kernel source to vary (default: csrc's)")
    ap.add_argument("--rollouts", type=int, nargs="+",
                    default=[1, 4, 16, 64, 256],
                    help="rollout counts (n_batch) to time each tile at")
    ap.add_argument("--grids", type=int, nargs="+", default=None,
                    help="sides of the square cloths to time on (default: "
                         "the bench cloth's)")
    ap.add_argument("--kernels", nargs="+", default=["substep", "wide"],
                    choices=["substep", "wide"],
                    help="whose tile to vary: the small tile's kernel, the "
                         "wide one's")
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
    jobs = []                   # (kernel, variant, source text)
    if "substep" in args.kernels:
        jobs += [("substep", v, variant_source(src, *v)) for v in VARIANTS
                 if v[2] is None or "constexpr int kExtraCells" in src]
    if "wide" in args.kernels:
        jobs += [("wide", v, wide_variant_source(src, *v))
                 for v in WIDE_VARIANTS]
        if "substep" not in args.kernels:
            # the package's small tile in turns with them
            ref = ("substep", SHIPPED, None)
            jobs = [ref] + jobs + [ref]
    # build every variant at once
    builds = []
    for k, (_, _, text) in enumerate(jobs):
        if text is None:
            builds.append((None, None))
            continue
        cu = _build.BUILD_DIR / f"cloth_sweep_{k}.cu"
        so = _build.BUILD_DIR / f"libcloth_sweep_{k}_{os.getpid()}.so"
        cu.write_text(text)
        builds.append((so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in builds:
        if so is None:
            libs.append((_build.load("grid_cloth_step"), []))
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            return 1
        libs.append((ctypes.CDLL(str(so)), cs.ptxas_report({"v": out})[1]))
        so.unlink()

    dev = torch.device("cuda", torch.cuda.current_device())
    grids = args.grids or [cs.GRID]
    gen = torch.Generator(device=dev).manual_seed(7)
    counts = sorted(set(args.rollouts) | {4})
    scenes, planes = {}, {}     # side: (w, icd, icb, params); (side, nb)
    for g in grids:
        state, cset = cs.cloth_scene(g, g, dev)
        gc, p = cset.grid_cloths[0], state.particles
        scenes[g] = (p.inv_mass.reshape(g, g).contiguous(),
                     gc.inv_cnt_dist.reshape(g, g).contiguous(),
                     gc.inv_cnt_bend.reshape(g, g).contiguous(),
                     gcc.kernel_params(gc, h=0.001))
        free = (p.inv_mass > 0).to(torch.float32)[:, None]
        for nb in counts:
            x = p.x + 1e-3 * free * torch.randn((nb,) + tuple(p.x.shape),
                                                generator=gen, device=dev)
            v = 0.1 * free * torch.randn((nb,) + tuple(p.v.shape),
                                         generator=gen, device=dev)
            planes[g, nb] = (gcc.to_planes(x, g, g), gcc.to_planes(v, g, g))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def tile_launch(fn, lib, g, nb, xo, vo):
        xp, vp = planes[g, nb]
        w, icd, icb, params = scenes[g]

        def run():
            stream = torch.cuda.current_stream(dev).cuda_stream
            e = fn(xp.data_ptr(), vp.data_ptr(), None, None, xo.data_ptr(),
                   vo.data_ptr(), None, w.data_ptr(), 0, icd.data_ptr(),
                   icb.data_ptr(), params.ctypes.data, nb, g, g, 1, 0, g,
                   stream)
            if e != 0:
                raise RuntimeError(lib.pbd_error_string(e).decode())
        return run

    def wide_launch(lib, g, nb, xo, vo):
        xp, vp = planes[g, nb]
        w, icd, icb, params = scenes[g]

        def run():
            stream = torch.cuda.current_stream(dev).cuda_stream
            e = lib.pbd_cloth_wide(xp.data_ptr(), vp.data_ptr(),
                                   xo.data_ptr(), vo.data_ptr(),
                                   w.data_ptr(), 0, icd.data_ptr(),
                                   icb.data_ptr(), params.ctypes.data, nb, g,
                                   g, stream)
            if e != 0:
                raise RuntimeError(lib.pbd_error_string(e).decode())
        return run

    # the package's small tile at each count, to hold each variant to
    pkg = _build.load("grid_cloth_step")
    pkg_fn = gcc._bind(pkg)
    refs = {}
    for key, (xp, vp) in planes.items():
        xo, vo = torch.empty_like(xp), torch.empty_like(vp)
        tile_launch(pkg_fn, pkg, *key, xo, vo)()
        refs[key] = (xo, vo)
    torch.cuda.synchronize()

    rows = []
    for ((kernel, (tx, ty, cells), _), (lib, ptxas)), g in (
            (job, g) for job in zip(jobs, libs) for g in grids):
        fn = gcc._bind(lib)
        row = {"kernel": kernel, "tile": [tx, ty], "grid": g,
               "ptxas": ptxas,
               "halo_factor": (tx + 2 * R) * (ty + 2 * R) / (tx * ty),
               "items_b1": -(-g // tx) * -(-g // ty),
               "solved_cells_b1": gcc.solved_cells((tx, ty), 1, g, g)}
        if kernel == "substep":
            row["extra_cells"] = cells
            resources = lambda: gcc.resources_of(lib, 1)  # noqa: E731
            name = "cloth_substep_kernel"
        else:
            row["cells"] = cells
            resources = lambda: gcc.wide_resources_of(lib)  # noqa: E731
            name = "cloth_wide_kernel"
        try:
            row["resources_it1"] = resources()
        except RuntimeError as e:
            row["resources_it1"] = str(e)
        if kernel == "wide":
            try:
                cap = gcc.capacity_of(lib, lib.pbd_cloth_wide_capacity)
            except RuntimeError as e:
                cap = None
                row["capacity"] = str(e)
            else:
                row["capacity"] = cap
                row["fill"] = {nb: row["items_b1"] * nb / cap
                               for nb in args.rollouts}
        for nb in args.rollouts:
            xo, vo = (torch.empty_like(planes[g, nb][0]),
                      torch.empty_like(planes[g, nb][1]))
            run = (tile_launch(fn, lib, g, nb, xo, vo)
                   if kernel == "substep" else wide_launch(lib, g, nb, xo, vo))
            try:
                ms = cs.device_ms(run, 200 if nb <= 4 else 20, name)
            except RuntimeError as e:
                row[f"us_b{nb}"] = f"refused: {e}"
                continue
            row[f"us_b{nb}"] = None if ms is None else ms * 1e3
            if kernel == "wide" or nb == 4:
                torch.cuda.synchronize()
                xr, vr = refs[g, nb]
                row[f"bit_equal_b{nb}"] = bool(torch.equal(xo, xr)
                                               and torch.equal(vo, vr))
                row[f"max_abs_dev_b{nb}"] = cs.max_dev(xo, xr)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": cs.nvidia_smi_line(), "sms": sms,
                      "source": str(path), "variants": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
