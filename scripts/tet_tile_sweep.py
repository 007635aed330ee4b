#!/usr/bin/env python3
"""The fused tet substep kernel (B2) per launch at the 80×36×36 bench bar
for other vertex boxes, cells a thread and register targets, on the card;
with ``--parent FILE``, beside the two-pass first design.

Run from the root of the repository on a machine with the card:

    python3 scripts/tet_tile_sweep.py [--parent FILE]

Each variant is ``csrc/grid_tet_step.cu`` with its box ``TI``, ``TJ``,
``TK`` (vertices a block owns along i, j, k), ``kCellsPerThread`` and
``kMinBlocks`` (resident blocks an SM the registers are held to allow)
replaced, built into the package's build directory with the port's
``nvcc`` flags (all variants at once), and timed under
``torch.profiler`` (200 launches after a warm-up) on the bench bar's
first substep at 1 iteration, the main path's configuration. Beside each
time it prints the box's layout at the bar (``box_counts``: blocks,
threads a block, the halo factor of a box inside the grid, the cells all
blocks solve over the bar's cells, the share of busy lanes that hold a
cell), the registers, shared memory, local bytes, resident blocks an SM
and threads a block as the runtime reports them, and the largest
deviation of its positions after one substep from the package's kernel
and from the plain version.

``--parent FILE`` adds the first design (a source with the
``pbd_tet_cells`` / ``pbd_tet_vertices`` C interface of two launches an
iteration, e.g. ``git show <commit>:positionbaseddynamics_tpu_torch/csrc/
grid_tet_step.cu``), timed as the sum of its two kernels. The rows run in
turns: the package's kernel, the parent, the other variants, the parent,
the package's kernel, so that a drift of the card shows.

A measurement tool outside the tests: it edits the kernel source by exact
text anchors, which fit the source it was written with, and stops with an
error naming the anchor where a later edit of the kernel moved one;
``tests/test_torch_tet_tooling.py`` checks the anchors on the CPU.
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

# (TI, TJ, TK, kCellsPerThread, kMinBlocks); None leaves the source's value
SHIPPED = (None, None, None, None, None)
VARIANTS = [(8, 6, 6, 1, 2), (8, 6, 6, 1, 3), (8, 8, 8, 1, 1),
            (8, 8, 8, 1, 2), (6, 6, 6, 1, 3), (4, 6, 6, 1, 5),
            (10, 6, 6, 1, 2), (12, 6, 6, 1, 1), (16, 6, 6, 1, 2),
            (8, 8, 4, 1, 2), (12, 6, 6, 2, 2), (8, 6, 6, 2, 3)]
ANCHORS = ("TI", "TJ", "TK", "kCellsPerThread", "kMinBlocks")


def source_values(src: str) -> dict:
    """The value of each anchored constant in ``src``."""
    out = {}
    for name in ANCHORS:
        hits = re.findall(rf"constexpr int {name} = (\d+);", src)
        if len(hits) != 1:
            raise RuntimeError(f"{name}: anchor not found once")
        out[name] = int(hits[0])
    return out


def variant_source(src: str, variant) -> str:
    """``src`` with each anchored constant of ``variant`` replaced."""
    for name, value in zip(ANCHORS, variant):
        if value is None:
            continue
        src, n = re.subn(rf"(constexpr int {name} = )\d+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"{name}: anchor not found once")
    return src


def box_counts(ti: int, tj: int, tk: int, nc: int, dims) -> dict:
    """What a box of ``ti × tj × tk`` vertices gives at a ``dims`` grid, as
    the kernel lays it out: its threads and blocks, the cells a block of a
    box inside the grid solves over the cells it owns, the cells all blocks
    solve over the grid's, and the share of the lanes of the warps that
    take a cell that hold one (each block clipped to the grid, each parity
    class in whole warps)."""
    def warps(n):
        return sum(-(-c // (32 * nc)) for c in ((n + 1) // 2, n // 2))

    box = (ti + 1) * (tj + 1) * (tk + 1)
    extents = []       # per axis, each box's cells inside the grid
    for t, n in zip((ti, tj, tk), dims):
        extents.append([min(t + 1, n - o) - (o == 0) for o in range(0, n, t)])
    solved = lanes = 0
    for ni in extents[0]:
        for nj in extents[1]:
            for nk in extents[2]:
                solved += ni * nj * nk
                lanes += 32 * nc * warps(ni * nj * nk)
    w, h, d = dims
    return {"threads": 32 * warps(box),
            "blocks": len(extents[0]) * len(extents[1]) * len(extents[2]),
            "halo_factor": box / (ti * tj * tk),
            "solved_over_cells": solved / ((w - 1) * (h - 1) * (d - 1)),
            "lane_use": solved / lanes}


def bind_parent(lib):
    """The first design's C interface: a cell and a vertex launch an
    iteration, through a (24, cells) scratch buffer."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    cells, verts = lib.pbd_tet_cells, lib.pbd_tet_vertices
    # x_in, v_in, x_cur, w, lam, scratch, params, W, H, D, iteration,
    # use_lam, stream
    cells.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    # x_in, v_in, x_cur, w, inv_cnt, scratch, x_out, v_out, params, W, H,
    # D, stream
    verts.argtypes = [vp] * 9 + [ci] * 3 + [vp]
    cells.restype = verts.restype = ci
    lib.pbd_tet_error_string.argtypes = [ci]
    lib.pbd_tet_error_string.restype = ctypes.c_char_p
    return cells, verts


def build(jobs):
    """Compile ``{tag: source text}`` at once; ``{tag: CDLL}``."""
    from positionbaseddynamics_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in jobs.items():
        cu = _build.BUILD_DIR / f"tet_sweep_{tag}.cu"
        so = _build.BUILD_DIR / f"libtet_sweep_{tag}_{os.getpid()}.so"
        cu.write_text(text)
        procs[tag] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for tag, (so, proc) in procs.items():
        logs[tag], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{logs[tag]}")
        libs[tag] = ctypes.CDLL(str(so))
        so.unlink()
    return libs, logs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="the first design's source, to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tet_tile_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    src = (_build.CSRC / "grid_tet_step.cu").read_text()
    shipped = source_values(src)
    order = ([SHIPPED] + (["parent"] if args.parent else []) + VARIANTS
             + (["parent"] if args.parent else []) + [SHIPPED])
    jobs = {f"v{k}": variant_source(src, v)
            for k, v in enumerate(VARIANTS)}
    jobs["shipped"] = src
    if args.parent:
        jobs["parent"] = args.parent.read_text()
    libs, logs = build(jobs)
    tag_of = {v: f"v{k}" for k, v in enumerate(VARIANTS)}
    tag_of[SHIPPED] = "shipped"

    dev = torch.device("cuda", torch.cuda.current_device())
    state, cset = cs.bar_scene(cs.BAR, dev)
    gt, p = cset.grid_tets[0], state.particles
    dims = (gt.width, gt.height, gt.depth)
    n_cells = (dims[0] - 1) * (dims[1] - 1) * (dims[2] - 1)
    params = gtc.kernel_params(gt, h=0.001)
    w = p.inv_mass.contiguous()
    ic = gt.inv_cnt.reshape(-1).contiguous()
    xp, vp = gtc.to_planes(p.x), gtc.to_planes(p.v)
    ref = gtc.tet_substep_cuda(xp, vp, w, ic, params, dims)[0]
    plain = gtc.to_planes(gtc.tet_substep_reference(gt, p.x, p.v,
                                                    p.inv_mass, h=0.001)[0])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for v in order:
        xo, vo = torch.empty_like(xp), torch.empty_like(vp)
        if v == "parent":
            cells, verts = bind_parent(libs["parent"])
            scratch = xp.new_empty((24, n_cells))
            lib = libs["parent"]

            def run():
                for e in (cells(xp.data_ptr(), vp.data_ptr(), None,
                                w.data_ptr(), None, scratch.data_ptr(),
                                params.ctypes.data, *dims, 0, 0, stream),
                          verts(xp.data_ptr(), vp.data_ptr(), None,
                                w.data_ptr(), ic.data_ptr(),
                                scratch.data_ptr(), xo.data_ptr(),
                                vo.data_ptr(), params.ctypes.data, *dims,
                                stream)):
                    if e != 0:
                        raise RuntimeError(
                            lib.pbd_tet_error_string(e).decode())

            row = {"variant": "parent (two passes)",
                   "source": str(args.parent)}
            parts = [cs.device_ms(run, 200, k)
                     for k in ("tet_cell_kernel", "tet_vertex_kernel")]
            row["us_parts"] = [None if ms is None else ms * 1e3
                               for ms in parts]
            row["us"] = (None if None in parts else sum(parts) * 1e3)
        else:
            tag = tag_of[v]
            lib = libs[tag]
            fn = gtc._bind(lib)
            values = dict(shipped, **{k: x for k, x in zip(ANCHORS, v)
                                      if x is not None})
            row = {"variant": values, **box_counts(
                values["TI"], values["TJ"], values["TK"],
                values["kCellsPerThread"], dims)}
            row["resources"] = gtc.kernel_resources(lib)
            if row["resources"]["threads"] != row["threads"]:
                raise RuntimeError(f"{values}: the kernel runs "
                                   f"{row['resources']['threads']} threads "
                                   f"a block, box_counts {row['threads']}")
            row["ptxas"] = [ln.strip() for ln in logs[tag].splitlines()
                            if "registers" in ln or "spill" in ln]

            def run():
                e = fn(xp.data_ptr(), vp.data_ptr(), None, w.data_ptr(),
                       ic.data_ptr(), None, None, xo.data_ptr(),
                       vo.data_ptr(), params.ctypes.data, *dims, stream)
                if e != 0:
                    raise RuntimeError(lib.pbd_tet_error_string(e).decode())

            ms = cs.device_ms(run, 200, "tet_substep_kernel")
            row["us"] = None if ms is None else ms * 1e3
        row["interval_us"] = cs.cuda_time_ms(run, 500) * 1e3
        torch.cuda.synchronize()
        row["max_abs_dev_from_shipped"] = cs.max_dev(xo, ref)
        row["max_abs_dev_from_plain"] = cs.max_dev(xo, plain)
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": cs.nvidia_smi_line(), "bar": dims,
                      "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
