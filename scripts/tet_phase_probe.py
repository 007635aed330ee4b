#!/usr/bin/env python3
"""Where a block of the fused tet substep kernel (B2) spends its cycles, on
the card, at the 80×36×36 bench bar.

Run from the root of the repository on a machine with the card:

    python3 scripts/tet_phase_probe.py [--source FILE] [--ablate-solve]
                                       [--ablate-memory]

It copies ``positionbaseddynamics_tpu_torch/csrc/grid_tet_step.cu`` (or
FILE, another version of it with the same C interface and phase headers)
into the package's build directory with ``clock64()`` stamps added at the
kernel's phase headers, each right after a ``__syncthreads()`` (stage,
solve, gather and write-back) and after a barrier added at the kernel's end, builds
it and the unchanged source with the port's ``nvcc`` flags, and runs both
on the bench bar's first substep at 1 iteration, the main path's
configuration. It prints each phase's cycles (mean, least, most over the
blocks) and share of a block, the blocks each SM ran, the cycles from an
SM's first block start to its last block end, the mean number of blocks
resident on an SM (block cycles over SM cycles), both kernels' device
times, so that the stamps' own cost shows, and both kernels' resources.
``--ablate-solve`` also runs a copy whose cells skip the 5-tet solve (it
stores zero sums), which measures what staging, gathering and writing cost
alone; ``--ablate-memory`` a copy that stages positions made from the
vertex indices in place of its global loads and stores nothing, which
measures what the solve and the gather cost alone. Both copies compute
nothing of use.

A measurement tool outside the tests: it edits the kernel source by exact
text anchors (the ``// ---- <n>.`` phase headers and the closing line of
``tet_box``, the block's pass), and stops with an error naming the anchor
where a later edit of the kernel moved one;
``tests/test_torch_tet_tooling.py`` checks the anchors on the CPU.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# phase headers of the kernel, in order
PHASES = (("  // ---- 1. stage", "stage"),
          ("  // ---- 2. solve", "solve"),
          ("  // ---- 3. the box's vertices", "gather_write"))
END = "}  // tet_box\n"
INCLUDE = "#include <cuda_runtime.h>\n"
EXPORTS = 'extern "C" {\n'
SOLVE = ("    if (odd)\n"
         "      solve_cell<1>(vx, vw, s, acc, P, lam_in, lo, cell, n_cells);\n"
         "    else\n"
         "      solve_cell<0>(vx, vw, s, acc, P, lam_in, lo, cell, n_cells);\n")
# the staging loads, and what --ablate-memory stages in their place: a
# sheared lattice, so that every tet is strained
LOADS = """      rw[u] = w_g[vi];
      ric[u] = ic_g[vi];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (x_cur != nullptr) {
          rx[u][a] = x_cur[a * n + vi];
        } else {
          rx[u][a] = x_in[a * n + vi];
          rv[u][a] = v_in[a * n + vi];
        }
      }
"""
NO_LOADS = """      rw[u] = gi > 0 ? 1.f : 0.f;
      ric[u] = 0.05f;
      rx[u][0] = 0.05f * gi + 0.001f * (gj & 3);
      rx[u][1] = 0.028f * gj;
      rx[u][2] = 0.028f * gk + 0.0005f * (gi & 1);
"""
STORES = (("      x_out[e * n + vi] = xe;\n",
           "      if (xe == 1234.5f) x_out[e * n + vi] = xe;\n"),
          ("        v_out[e * n + vi] = v;\n",
           "        if (v == 1234.5f) v_out[e * n + vi] = v;\n"))
SLOTS = 8                       # per block: smid, a stamp per phase, end
MAX_BLOCKS = 16384
PROBE = f"""
__device__ long long g_tet_probe[{MAX_BLOCKS} * {SLOTS}];
"""
STAMP = "  const long long probe_t{k} = clock64();\n"
FLUSH = """  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < {max_blocks}) {{
    unsigned probe_sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(probe_sm));
    long long* probe_out = g_tet_probe + {slots} * blockIdx.x;
    probe_out[0] = probe_sm;
{stores}    probe_out[{end}] = clock64();
  }}
"""
READ = """int pbd_tet_probe_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_tet_probe, sizeof(long long) * n);
}
"""


def _once(src: str, anchor: str) -> None:
    if src.count(anchor) != 1:
        raise RuntimeError(f"{anchor.strip()!r}: anchor not found once")


def instrument(src: str) -> str:
    """``src`` with a stamp at each phase header and the block's record
    written at the kernel's end (``g_tet_probe``, read back by
    ``pbd_tet_probe_read``)."""
    for anchor in [a for a, _ in PHASES] + [END, INCLUDE, EXPORTS]:
        _once(src, anchor)
    for k, (anchor, _) in enumerate(PHASES):
        src = src.replace(anchor, STAMP.format(k=k) + anchor)
    stores = "".join(f"    probe_out[{k + 1}] = probe_t{k};\n"
                     for k in range(len(PHASES)))
    flush = FLUSH.format(max_blocks=MAX_BLOCKS, slots=SLOTS, stores=stores,
                         end=len(PHASES) + 1)
    src = src.replace(END, flush + END)
    src = src.replace(INCLUDE, INCLUDE + PROBE)
    return src.replace(EXPORTS, EXPORTS + READ)


def ablate_solve(src: str) -> str:
    """``src`` whose cells store zero sums without solving their tets."""
    _once(src, SOLVE)
    return src.replace(SOLVE, "")


def ablate_memory(src: str) -> str:
    """``src`` that stages a lattice made from the vertex indices in place
    of its global loads and writes no output (a store behind a test that
    no value passes keeps the results live)."""
    _once(src, LOADS)
    src = src.replace(LOADS, NO_LOADS)
    for old, new in STORES:
        _once(src, old)
        src = src.replace(old, new)
    return src


def summarize(rows) -> dict:
    """Per-phase cycles over the blocks' records ``[smid, stamps..., end]``,
    and how the blocks shared the SMs."""
    names = [n for _, n in PHASES]
    phases = {}
    for k, name in enumerate(names):
        cyc = [r[k + 2] - r[k + 1] for r in rows]
        phases[name] = {"mean": statistics.mean(cyc), "min": min(cyc),
                        "max": max(cyc)}
    block = [r[-1] - r[1] for r in rows]
    for name in names:
        phases[name]["share"] = phases[name]["mean"] / statistics.mean(block)
    per_sm = collections.defaultdict(list)
    for r in rows:
        per_sm[r[0]].append(r)
    spans = [max(r[-1] for r in rs) - min(r[1] for r in rs)
             for rs in per_sm.values()]
    return {"phases": phases, "block_cycles": statistics.mean(block),
            "sms": len(per_sm),
            "blocks_per_sm": dict(collections.Counter(
                len(rs) for rs in per_sm.values())),
            "sm_span_cycles_max": max(spans),
            "sm_span_cycles_mean": statistics.mean(spans),
            "resident_blocks_mean": sum(block) / sum(spans)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=None,
                    help="the kernel source to probe (default: csrc's)")
    ap.add_argument("--ablate-solve", action="store_true",
                    help="also time a copy that skips the 5-tet solve")
    ap.add_argument("--ablate-memory", action="store_true",
                    help="also time a copy without global loads and stores")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tet_phase_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import tet_tile_sweep as sweep
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.solver import grid_tet_cuda as gtc

    path = args.source or _build.CSRC / "grid_tet_step.cu"
    src = path.read_text()
    jobs = {"plain": src, "probed": instrument(src)}
    if args.ablate_solve:
        jobs["no_solve"] = ablate_solve(src)
    if args.ablate_memory:
        jobs["no_memory"] = ablate_memory(src)
    libs, _ = sweep.build(jobs)
    values = sweep.source_values(src)

    dev = torch.device("cuda", torch.cuda.current_device())
    state, cset = cs.bar_scene(cs.BAR, dev)
    gt, p = cset.grid_tets[0], state.particles
    dims = (gt.width, gt.height, gt.depth)
    n_blocks = sweep.box_counts(values["TI"], values["TJ"], values["TK"],
                                values["kCellsPerThread"], dims)["blocks"]
    params = gtc.kernel_params(gt, h=0.001)
    w = p.inv_mass.contiguous()
    ic = gt.inv_cnt.reshape(-1).contiguous()
    xp, vp = gtc.to_planes(p.x), gtc.to_planes(p.v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"device": torch.cuda.get_device_name(dev),
           "nvidia_smi": cs.nvidia_smi_line(), "source": str(path),
           "box": values, "blocks": n_blocks}
    for tag, lib in libs.items():
        fn = gtc._bind(lib)
        xo, vo = torch.empty_like(xp), torch.empty_like(vp)

        def run():
            e = fn(xp.data_ptr(), vp.data_ptr(), None, w.data_ptr(),
                   ic.data_ptr(), None, None, xo.data_ptr(), vo.data_ptr(),
                   params.ctypes.data, *dims, stream)
            if e != 0:
                raise RuntimeError(lib.pbd_tet_error_string(e).decode())

        ms = cs.device_ms(run, 200, "tet_substep_kernel")
        out[tag] = {"us": None if ms is None else ms * 1e3,
                    "resources": gtc.kernel_resources(lib)}
        if tag == "probed":
            run()
            torch.cuda.synchronize()
            lib.pbd_tet_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            n = SLOTS * min(n_blocks, MAX_BLOCKS)
            buf = (ctypes.c_longlong * n)()
            err = lib.pbd_tet_probe_read(buf, n)
            if err != 0:
                raise RuntimeError(lib.pbd_tet_error_string(err).decode())
            rows = [list(buf[SLOTS * b:SLOTS * b + len(PHASES) + 2])
                    for b in range(n // SLOTS)]
            out[tag].update(summarize(rows))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
