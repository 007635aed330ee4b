#!/usr/bin/env python3
"""Where a warp of the PBF density kernel (B3) spends its cycles, on the
card, at the 100k dam of ``bench.py --fluid``.

Run from the root of the repository on a machine with the card:

    python3 scripts/pbf_phase_probe.py

It copies ``positionbaseddynamics_tpu_torch/csrc/pbf_cells.cu`` into the
package's build directory with ``clock64()`` stamps added to B3 (each
behind a ``__syncwarp()``, so a stamp marks the whole warp's progress),
builds it with the port's ``nvcc`` flags, and runs it on the tables of the
dam's 11th step beside the unchanged kernel. It prints, per occupied
active cell, the cycles a warp spends opening the cell (its row, count,
neighbour ids and counts, and their scan), waiting for the staged fluid
candidates, testing candidates, walking the pairs that passed, in the
rest of the pair passes (the boundary copies' wait among them), and in
the rest of the particle loop; the warps of empty cells; the mean number of warps
resident on an SM over the launch (warp-cycles over launch cycles); and
both kernels' times, so that the stamps' own cost shows. The stamps
serialise a warp at each phase boundary: read the shares, not the sum, as
the kernel's.

A measurement tool outside the tests: it edits the kernel source by exact
text anchors, which fit the source it was written with, and stops with
an error naming the anchor where a later edit of the kernel moved one.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# g_probe slots: per-phase cycle sums of the live warps, then counts
PHASES = {0: "open", 2: "staging", 4: "tests", 5: "walks", 6: "rest",
          7: "passes"}
PROBE = r"""
__device__ unsigned long long g_probe[16];
#define PROBE_MARK(k)                                                  \
  {                                                                    \
    __syncwarp();                                                      \
    const long long t_ = clock64();                                    \
    if (probe_l0) atomicAdd(&g_probe[k], (unsigned long long)(t_ - pt)); \
    pt = t_;                                                           \
  }
"""


def instrument(src: str) -> str:
    """The kernel source with B3 (and the pair walk it calls) stamped."""
    head, tail = src.split("pbf_corrections_kernel(Cells C", 1)
    head = head.replace("namespace {\n", "namespace {\n" + PROBE, 1)

    def rep(old, new):
        nonlocal head
        if head.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once: {old!r}")
        head = head.replace(old, new)

    # tests and walks inside for_passing
    rep("    unsigned long long mask = 0;\n",
        "    __syncwarp();\n    long long tq_ = clock64();\n"
        "    unsigned long long mask = 0;\n")
    rep("    while (mask) {\n",
        "    __syncwarp();\n    long long tw_ = clock64();\n"
        "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_probe[4], "
        "(unsigned long long)(tw_ - tq_));\n    while (mask) {\n")
    rep("      f(base + t * L.g);\n    }\n",
        "      f(base + t * L.g);\n    }\n    __syncwarp();\n"
        "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_probe[5], "
        "(unsigned long long)(clock64() - tw_));\n")
    # staging inside walk_hood
    rep("    if (restage) {\n      stage_chunk(C, w1, vel, S, h, ch, lane);\n"
        "      staged_fluid();\n    }\n",
        "    __syncwarp();\n    long long ts_ = clock64();\n"
        "    if (restage) {\n      stage_chunk(C, w1, vel, S, h, ch, lane);\n"
        "      staged_fluid();\n    }\n    __syncwarp();\n"
        "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_probe[2], "
        "(unsigned long long)(clock64() - ts_));\n")
    b3 = head.index("pbf_density_lambda_kernel(Cells C")
    pre, body = head[:b3], head[b3:]

    def brep(old, new):
        nonlocal body
        if body.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once: {old!r}")
        body = body.replace(old, new)

    brep("  __shared__ Stage S;\n",
         "  __shared__ Stage S;\n"
         "  const bool probe_l0 = (threadIdx.x & 31) == 0;\n"
         "  const long long pt0 = clock64();\n  long long pt = pt0;\n")
    brep("  if (n == 0) return;\n",
         "  if (n == 0) {\n    if (probe_l0) { atomicAdd(&g_probe[8], 1ull);\n"
         "      atomicAdd(&g_probe[9], (unsigned long long)(clock64() - pt0)); }"
         "\n    return;\n  }\n  PROBE_MARK(0)\n")
    brep("    walk_hood(\n", "    PROBE_MARK(6)\n    walk_hood(\n")
    brep("    rho = group_sum(rho, L.g);\n",
         "    PROBE_MARK(7)\n    rho = group_sum(rho, L.g);\n")
    brep("      lam_t[i] = lam;\n      dens_t[i] = dens;\n    }\n  }\n}\n",
         "      lam_t[i] = lam;\n      dens_t[i] = dens;\n    }\n  }\n"
         "  PROBE_MARK(6)\n  if (probe_l0) {\n"
         "    atomicAdd(&g_probe[10], 1ull);\n"
         "    atomicAdd(&g_probe[13], (unsigned long long)(clock64() - pt0));"
         "\n  }\n}\n")
    tail += r"""
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
__global__ void probe_spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}
extern "C" int probe_spin(long long cycles) {
  probe_spin_kernel<<<1, 1>>>(cycles);
  return (int)cudaGetLastError();
}
extern "C" int probe_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""
    return pre + body + "pbf_corrections_kernel(Cells C" + tail


def probe_resources(lib) -> list:
    vals = (ctypes.c_int * 4)()
    lib.pbd_pbf_kernel_resources(0, vals)
    return list(vals)     # registers, shared bytes, local bytes, blocks/SM


def main() -> int:
    if not torch.cuda.is_available():
        print("pbf_phase_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.fluids import cellgrid_cuda as fcc
    from positionbaseddynamics_tpu_torch.fluids import model as fm

    _build.build_all()
    src = (_build.CSRC / "pbf_cells.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "pbf_phase_probe.cu"
    so = _build.BUILD_DIR / f"libpbf_phase_probe_{os.getpid()}.so"
    cu.write_text(instrument(src))
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        print(out.stdout + out.stderr, file=sys.stderr)
        return 1
    _, lines = cs.ptxas_report({"pbf_phase_probe": out.stdout + out.stderr})
    for line in lines:
        if "density" in line:
            print("ptxas", line)
    lib = ctypes.CDLL(str(so))
    fn = fcc._bind(lib)[0]
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.probe_spin.argtypes = [ctypes.c_longlong]
    plain_fn = fcc._bind(_build.load("pbf_cells"))[0]

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
    tail = [lam_t.data_ptr(), dens_t.data_ptr(), pi.params.ctypes.data]

    def launch(f):
        return lambda: fcc._launch("density/lambda", f, lib, args + tail, dev)

    times = {name: cs.cuda_time_ms(launch(f), 100)
             for name, f in (("kernel_ms", plain_fn), ("probe_ms", fn),
                             ("kernel_ms_again", plain_fn))}
    torch.cuda.synchronize()
    lib.probe_reset()
    launch(fn)()
    torch.cuda.synchronize()
    vals = (ctypes.c_ulonglong * 16)()
    lib.probe_read(vals)
    v = list(vals)
    live, dead = v[10], v[8]
    per_cell = {p: v[k] / live for k, p in PHASES.items()}
    # the neighbourhood walk holds the staging, tests and walks, stamped
    # inside it
    per_cell["passes_other"] = (per_cell.pop("passes") - per_cell["staging"]
                                - per_cell["tests"] - per_cell["walks"])
    spin = 200_000_000
    clock_hz = spin / (cs.cuda_time_ms(lambda: lib.probe_spin(spin), 3)
                       * 1e-3)
    launch_cycles = times["probe_ms"] * 1e-3 * clock_hz
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = (v[13] + v[9]) / (launch_cycles * sms)
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": cs.nvidia_smi_line(),
        "live_warps": live, "empty_warps": dead,
        "cycles_per_live_warp": v[13] / live,
        "cycles_per_empty_warp": v[9] / max(dead, 1),
        "phase_cycles_per_live_warp": per_cell,
        "sm_clock_hz_spin": clock_hz,
        "mean_resident_warps_per_sm": resident,
        "probe_resources": probe_resources(lib),
        **times}, indent=1))
    so.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
