#!/usr/bin/env python3
"""Where a block of the fused cloth substep kernel (B1) spends its cycles,
on the card, at the 320×320 bench cloth.

Run from the root of the repository on a machine with the card:

    python3 scripts/cloth_phase_probe.py [--source FILE]

It copies ``positionbaseddynamics_tpu_torch/csrc/grid_cloth_step.cu`` (or
FILE, another version of it with the same C interface) into the package's
build directory with ``clock64()`` stamps added at the kernel's phase
headers (each behind a ``__syncthreads()``, so a stamp marks the whole
block's progress), builds it and the unchanged source with the port's
``nvcc`` flags, and runs the two on the bench cloth's first substep at
1 and 4 iterations and 1 and 4 rollouts. Per configuration it prints each
phase's share of a block's cycles (load and integrate, distance solve,
distance gather, bending solve, bending gather, write-back; the solve and
gather phases summed over the iterations), the cycles of a block, the
mean number of blocks resident on an SM over the launch (block-cycles
over launch cycles), both kernels' device times, so that the stamps' own
cost shows, and the kernel's resources. The stamps add a barrier at each
phase boundary: read the shares, not the sum, as the kernel's.

A measurement tool outside the tests: it edits the kernel source by exact
text anchors (the ``// ---- <phase>`` headers and the kernel's closing
line), and stops with an error naming the anchor where a later edit of
the kernel moved one; ``tests/test_torch_pbf_tooling.py`` checks the
anchors on the CPU.
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

# phase headers of the kernel, in order, and the g_cloth_probe slot of each
PHASES = (("// ---- load the tile", "load"),
          ("// ---- distance families", "distance_solve"),
          ("// ---- distance gather", "distance_gather"),
          ("// ---- isometric bending", "bending_solve"),
          ("// ---- bending gather", "bending_gather"),
          ("// ---- tile interior", "write_back"))
END = "}  // cloth_tile\n"
CONFIGS = ((1, 1), (1, 4), (4, 1), (4, 4))     # (iterations, rollouts)
PROBE = r"""
__device__ unsigned long long g_cloth_probe[16];
#define PROBE_BEGIN                                                     \
  __syncthreads();                                                      \
  const bool probe_t0_ = threadIdx.x + threadIdx.y == 0;                \
  const long long probe_start_ = clock64();                             \
  long long probe_t_ = probe_start_;                                    \
  int probe_k_ = 0;
#define PROBE_PHASE(k)                                                  \
  {                                                                     \
    __syncthreads();                                                    \
    if (probe_t0_) {                                                    \
      const long long t_ = clock64();                                   \
      atomicAdd(&g_cloth_probe[probe_k_],                               \
                (unsigned long long)(t_ - probe_t_));                   \
      probe_t_ = t_;                                                    \
    }                                                                   \
    probe_k_ = (k);                                                     \
  }
#define PROBE_END                                                       \
  {                                                                     \
    PROBE_PHASE(7)                                                      \
    if (probe_t0_) {                                                    \
      atomicAdd(&g_cloth_probe[8], 1ull);                               \
      atomicAdd(&g_cloth_probe[9],                                      \
                (unsigned long long)(clock64() - probe_start_));        \
    }                                                                   \
  }
"""
TAIL = r"""
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cloth_probe, sizeof(g_cloth_probe));
}
extern "C" int probe_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_cloth_probe, z, sizeof(z));
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
"""


def instrument(src: str) -> str:
    """The kernel source with a stamp at each phase header and at the
    kernel's end: slot k of ``g_cloth_probe`` sums the cycles of phase k
    (``PHASES``) over the blocks, slot 8 counts the blocks and slot 9 sums
    their cycles."""
    if src.count("namespace {\n") != 1:
        raise RuntimeError("probe anchor not found once: 'namespace {'")
    src = src.replace("namespace {\n", "namespace {\n" + PROBE, 1)
    lines = src.splitlines(keepends=True)
    out = []
    seen = {}
    for line in lines:
        for k, (anchor, _) in enumerate(PHASES):
            if line.lstrip().startswith(anchor):
                seen[anchor] = seen.get(anchor, 0) + 1
                indent = line[:len(line) - len(line.lstrip())]
                out.append(indent + ("PROBE_BEGIN\n" if k == 0
                                     else f"PROBE_PHASE({k})\n"))
        if line == END:
            seen[END] = seen.get(END, 0) + 1
            out.append("  PROBE_END\n")
        out.append(line)
    for anchor in [a for a, _ in PHASES] + [END]:
        if seen.get(anchor, 0) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
    return "".join(out) + TAIL


def build(text: str, tag: str):
    """Build ``text`` into the package's build directory with the port's
    flags; returns the loaded library and its ``-Xptxas -v`` lines."""
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"cloth_phase_probe_{tag}.cu"
    so = _build.BUILD_DIR / f"libcloth_phase_probe_{tag}_{os.getpid()}.so"
    cu.write_text(text)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    so.unlink()
    return lib, cs.ptxas_report({tag: out.stdout + out.stderr})[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=None,
                    help="the kernel source to probe (default: csrc's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cloth_phase_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from positionbaseddynamics_tpu_torch import _build
    from positionbaseddynamics_tpu_torch.solver import grid_cloth_cuda as gcc

    path = args.source or _build.CSRC / "grid_cloth_step.cu"
    src = path.read_text()
    real, lines = build(src, "plain")
    lib, _ = build(instrument(src), "stamped")
    for line in lines:
        print("ptxas", line, file=sys.stderr)
    probe_fn = gcc._bind(lib)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.probe_spin.argtypes = [ctypes.c_longlong]
    real_fn = gcc._bind(real)

    dev = torch.device("cuda", torch.cuda.current_device())
    g = cs.GRID
    state, cset = cs.cloth_scene(g, g, dev)
    gc, p = cset.grid_cloths[0], state.particles
    params = gcc.kernel_params(gc, h=0.001)
    w = p.inv_mass.reshape(g, g).contiguous()
    icd = gc.inv_cnt_dist.reshape(g, g).contiguous()
    icb = gc.inv_cnt_bend.reshape(g, g).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spin = 200_000_000
    clock_hz = spin / (cs.cuda_time_ms(lambda: lib.probe_spin(spin), 3)
                       * 1e-3)

    def resources(which, iters):
        try:
            return gcc.resources_of(which, iters)
        except RuntimeError as e:
            return str(e)

    rows = []
    for iters, nb in CONFIGS:
        xp = gcc.to_planes(torch.stack([p.x] * nb), g, g)
        vp = gcc.to_planes(torch.stack([p.v] * nb), g, g)
        xo, vo = torch.empty_like(xp), torch.empty_like(vp)

        def launch(fn, which):
            def run():
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = fn(xp.data_ptr(), vp.data_ptr(), None, None,
                         xo.data_ptr(), vo.data_ptr(), None, w.data_ptr(), 0,
                         icd.data_ptr(), icb.data_ptr(), params.ctypes.data,
                         nb, g, g, iters, 0, g, stream)
                if err != 0:
                    raise RuntimeError(which.pbd_error_string(err).decode())
            return run

        times = {}
        for key, fn, which in (("kernel_us", real_fn, real),
                               ("probe_us", probe_fn, lib),
                               ("kernel_us_again", real_fn, real)):
            ms = cs.device_ms(launch(fn, which), 200, "cloth_substep_kernel")
            times[key] = None if ms is None else ms * 1e3
        torch.cuda.synchronize()
        lib.probe_reset()
        launch(probe_fn, lib)()
        torch.cuda.synchronize()
        vals = (ctypes.c_ulonglong * 16)()
        lib.probe_read(vals)
        v = list(vals)
        blocks = v[8]
        names = [n for _, n in PHASES]
        per_phase = {names[k]: v[k] for k in range(len(PHASES))}
        total = sum(per_phase.values())
        launch_cycles = (times["probe_us"] or 0.0) * 1e-6 * clock_hz
        rows.append({
            "iterations": iters, "rollouts": nb, "blocks": blocks,
            "cycles_per_block": v[9] / max(blocks, 1),
            "phase_share": {k: c / total for k, c in per_phase.items()},
            "phase_cycles_per_block": {k: c / max(blocks, 1)
                                       for k, c in per_phase.items()},
            "mean_resident_blocks_per_sm": (v[9] / (launch_cycles * sms)
                                            if launch_cycles else None),
            "resources": resources(real, iters),
            "probe_resources": resources(lib, iters),
            **times})
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "source": str(path), "sm_clock_hz_spin": clock_hz,
                      "configs": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
