// Position-Based Fluids passes over a cell-dense slot table, for Hopper.
//
// Replaces the three TPU kernels of
// positionbaseddynamics_tpu/fluids/cellgrid_pallas.py (assembled by
// pbf_step_pallas, :192):
//   pbf_density_lambda_kernel  <- _density_lambda_kernel (:94, call :238):
//       rho_i = m_i W(0) + sum_j m_j W(x_i - x_j) + sum_b psi_b W(x_i - x_b),
//       lambda_i = -max(rho_i/rho0 - 1, 0) / (sum |grad C|^2 + 1e-6)
//       (PositionBasedFluids.cpp:8-97);
//   pbf_corrections_kernel     <- _corr_kernel (:125, call :249):
//       dx_i = -sum_j (lambda_i + lambda_j) grad C_j - sum_b lambda_i grad C_b
//       (PositionBasedFluids.cpp:100-141);
//   pbf_xsph_kernel            <- _xsph_kernel (:149, call :290):
//       dv_i = sum_j m_j / max(rho_j, 1e-6) W(x_i - x_j) (v_i - v_j) over
//       fluid neighbours, v_i -= nu dv_i.
// The math follows the plain PyTorch versions in
// positionbaseddynamics_tpu_torch/fluids/cellgrid.py term by term.
//
// Layout: position and velocity tables are (3, n_cells, cap) float32
// component planes, masses (n_cells, cap); the boundary tables are
// (3, n_cells, capb) and (n_cells, capb). Packing by rank fills each
// cell's slots from 0, so `count` (fluid) and `bcount` (boundary) give
// the occupied prefix of every cell.
//
// Pair set: frozen per step from the pre-projection table x0, recomputed
// in every pass: fluid pairs need m_i > 0, m_j > 0 and 1e-18 < r0^2 < h^2,
// boundary pairs m_i > 0, psi_b > 0 and r0^2 < h^2 (cellgrid_pallas.py
// _pair_geometry, :66-91). r0^2 is formed with explicitly rounded
// operations in the order dx*dx + dy*dy + dz*dz, so the pair sets equal
// the plain version's exactly; the rest may contract into FMAs.
//
// What bounds it: per candidate pair (an occupied slot of a neighbour
// cell) the pair test costs 10-11 fp32 operations; per pair inside the
// support radius B3 does 44 more, B4 30-31 and B5 31 (the count is
// itemised in chip_smoke.py, which computes each bound from the step's
// own pairs). At the 100k dam a pass sees ~2.4e7 candidates, ~3.9e6 of
// them in range: ~3.5e8-4.3e8 operations, 5-6.5 us at 67 TFLOP/s. The
// bytes the function must move are the occupied slots (9-14 floats each)
// and the occupied active rows, each once: ~6-8 MB, ~2 us at 3.35 TB/s.
// So all three are bound by their operations; the empty slots and
// unoccupied rows that a warp also touches are not work the function
// needs.
//
// Design: the TPU kernels evaluate dense (cap, 27 cap) pair planes per
// cell, ~95% of them dead, and the JAX default adds occupancy classes to
// shrink them. Here one warp takes one active cell and each lane one of
// its slots (lane + 32 r when cap > 32); every lane walks the 27
// neighbour cells in the _OFFS order of cellgrid.py, each only over its
// occupied prefix, so the loop bounds are the real counts, uniform across
// the warp, and the neighbour loads are warp-wide broadcasts. No shared
// memory, no atomics: each thread writes only its own slot. B3 writes its
// lambda and density rows into tables B4 and B5 read; B4 and B5 write to
// tables other than their inputs, since neighbours read the values they
// replace. No --use_fast_math: sqrtf and division stay IEEE-rounded.
#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int N_PARAMS = 8;
constexpr int kWarp = 32;
constexpr int kThreads = 128;    // 4 warps: 4 active cells per block

// Host-side scalars, laid out as the float vector the Python wrapper builds
// (cellgrid_cuda.kernel_params), each rounded from the double the plain
// version rounds.
struct PbfParams {
  float h;          // support radius
  float h2;         // h * h
  float density0;   // rest density
  float k;          // 8 / (pi h^3) = W(0)
  float k2;         // 2 k
  float l;          // 48 / (pi h^3)
  float neg_l;      // -l
  float neg_visc;   // -viscosity
};
static_assert(sizeof(PbfParams) == N_PARAMS * sizeof(float), "param layout");

struct Cells {
  const float* x;        // (3, n_cells, cap) current positions
  const float* x0;       // (3, n_cells, cap) pre-projection positions
  const float* m;        // (n_cells, cap) masses, 0 on empty slots
  const int* count;      // (n_cells,) occupied slot prefix
  const int* active;     // (K,) active cell ids
  const int* nbr;        // (K, 27) neighbour cell ids
  const uint8_t* ok;     // (K, 27) neighbour in domain and cell occupied
  const float* bx;       // (3, n_cells, capb) boundary positions, or null
  const float* bpsi;     // (n_cells, capb) boundary psi, or null
  const int* bcount;     // (n_cells,) boundary slot prefix, or null
  int n_cells, cap, capb, K;
};

__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// sph.w_r: the cubic spline from a distance.
__device__ __forceinline__ float w_r(float rl, const PbfParams& P) {
  const float q = fminf(rl / P.h, 1.0f);
  if (q <= 0.5f) {
    const float q2 = q * q;
    return P.k * (6.0f * (q2 * q) - 6.0f * q2 + 1.0f);
  }
  const float om = 1.0f - q;
  return P.k2 * (om * om * om);
}

// sph.grad_w_coef: s(r) with grad W(rvec) = s(|rvec|) rvec, 0 at the origin.
__device__ __forceinline__ float grad_w_coef(float rl, const PbfParams& P) {
  const float q = fminf(rl / P.h, 1.0f);
  float coefq;
  if (q <= 0.5f) {
    coefq = (P.l * q) * (3.0f * q - 2.0f);
  } else {
    const float om = 1.0f - q;
    coefq = P.neg_l * (om * om);
  }
  const float s = coefq / fmaxf(rl * P.h, 1e-30f);
  return rl > 1.0e-6f ? s : 0.0f;
}

// Calls f(jj, m_j) for every frozen fluid pair of a slot whose
// pre-projection position is xi0 (m_i > 0 is the caller's test): the 27
// neighbour cells of active cell a in order, each over its occupied prefix.
template <class F>
__device__ __forceinline__ void for_fluid_pairs(const Cells& C,
                                                const PbfParams& P, int a,
                                                const float* xi0, F&& f) {
  const int plane = C.n_cells * C.cap;
  for (int o = 0; o < 27; ++o) {
    if (!C.ok[a * 27 + o]) continue;
    const int nc = C.nbr[a * 27 + o];
    const int n = C.count[nc];
    const int base = nc * C.cap;
    for (int j = 0; j < n; ++j) {
      const int jj = base + j;
      const float mj = C.m[jj];
      if (!(mj > 0.0f)) continue;
      const float r2_0 = dist2_rn(__fsub_rn(xi0[0], C.x0[jj]),
                                  __fsub_rn(xi0[1], C.x0[plane + jj]),
                                  __fsub_rn(xi0[2], C.x0[2 * plane + jj]));
      if (!(r2_0 > 1e-18f && r2_0 < P.h2)) continue;
      f(jj, mj);
    }
  }
}

// Calls f(xb, yb, zb, psi_b) for every frozen boundary pair of a slot.
template <class F>
__device__ __forceinline__ void for_boundary_pairs(const Cells& C,
                                                   const PbfParams& P, int a,
                                                   const float* xi0, F&& f) {
  if (C.capb == 0) return;
  const int plane = C.n_cells * C.capb;
  for (int o = 0; o < 27; ++o) {
    if (!C.ok[a * 27 + o]) continue;
    const int nc = C.nbr[a * 27 + o];
    const int n = C.bcount[nc];
    const int base = nc * C.capb;
    for (int b = 0; b < n; ++b) {
      const int bb = base + b;
      const float pb = C.bpsi[bb];
      if (!(pb > 0.0f)) continue;
      const float xb = C.bx[bb], yb = C.bx[plane + bb],
                  zb = C.bx[2 * plane + bb];
      const float r2_0 = dist2_rn(__fsub_rn(xi0[0], xb),
                                  __fsub_rn(xi0[1], yb),
                                  __fsub_rn(xi0[2], zb));
      if (!(r2_0 < P.h2)) continue;
      f(xb, yb, zb, pb);
    }
  }
}

__device__ __forceinline__ int warp_cell(const Cells& C) {
  return (blockIdx.x * kThreads + threadIdx.x) / kWarp;
}

__global__ void __launch_bounds__(kThreads)
    pbf_density_lambda_kernel(Cells C, PbfParams P, float* lam_t,
                              float* dens_t) {
  const int a = warp_cell(C);
  if (a >= C.K) return;
  const int plane = C.n_cells * C.cap;
  const int cell = C.active[a];
  for (int s = threadIdx.x % kWarp; s < C.cap; s += kWarp) {
    const int i = cell * C.cap + s;
    const float mi = C.m[i];
    float dens = mi * P.k, lam = 0.0f;
    if (mi > 0.0f) {
      const float xi[3] = {C.x[i], C.x[plane + i], C.x[2 * plane + i]};
      const float xi0[3] = {C.x0[i], C.x0[plane + i], C.x0[2 * plane + i]};
      float fd = 0.0f, fs2 = 0.0f, fgx = 0.0f, fgy = 0.0f, fgz = 0.0f;
      for_fluid_pairs(C, P, a, xi0, [&](int jj, float mj) {
        const float dx = xi[0] - C.x[jj], dy = xi[1] - C.x[plane + jj],
                    dz = xi[2] - C.x[2 * plane + jj];
        const float r2 = dist2_rn(dx, dy, dz);
        const float rl = sqrtf(r2);
        fd += mj * w_r(rl, P);
        const float gc = -(mj / P.density0) * grad_w_coef(rl, P);
        fs2 += gc * gc * r2;
        fgx += gc * dx;
        fgy += gc * dy;
        fgz += gc * dz;
      });
      float bd = 0.0f, bs2 = 0.0f, bgx = 0.0f, bgy = 0.0f, bgz = 0.0f;
      for_boundary_pairs(C, P, a, xi0,
                         [&](float xb, float yb, float zb, float pb) {
        const float dx = xi[0] - xb, dy = xi[1] - yb, dz = xi[2] - zb;
        const float r2 = dist2_rn(dx, dy, dz);
        const float rl = sqrtf(r2);
        bd += pb * w_r(rl, P);
        const float gc = -(pb / P.density0) * grad_w_coef(rl, P);
        bs2 += gc * gc * r2;
        bgx += gc * dx;
        bgy += gc * dy;
        bgz += gc * dz;
      });
      dens = (dens + fd) + bd;
      const float gx = -fgx - bgx, gy = -fgy - bgy, gz = -fgz - bgz;
      const float s2 = (fs2 + bs2) + ((gx * gx + gy * gy) + gz * gz);
      const float c = fmaxf(dens / P.density0 - 1.0f, 0.0f);
      lam = c > 0.0f ? -c / (s2 + 1.0e-6f) : 0.0f;
    }
    lam_t[i] = lam;
    dens_t[i] = dens;
  }
}

__global__ void __launch_bounds__(kThreads)
    pbf_corrections_kernel(Cells C, PbfParams P, const float* lam_t,
                           float* x_out) {
  const int a = warp_cell(C);
  if (a >= C.K) return;
  const int plane = C.n_cells * C.cap;
  const int cell = C.active[a];
  for (int s = threadIdx.x % kWarp; s < C.cap; s += kWarp) {
    const int i = cell * C.cap + s;
    const float mi = C.m[i];
    float xi[3] = {C.x[i], C.x[plane + i], C.x[2 * plane + i]};
    if (mi > 0.0f) {
      const float xi0[3] = {C.x0[i], C.x0[plane + i], C.x0[2 * plane + i]};
      const float li = lam_t[i];
      float fx = 0.0f, fy = 0.0f, fz = 0.0f;
      for_fluid_pairs(C, P, a, xi0, [&](int jj, float mj) {
        const float dx = xi[0] - C.x[jj], dy = xi[1] - C.x[plane + jj],
                    dz = xi[2] - C.x[2 * plane + jj];
        const float rl = sqrtf(dist2_rn(dx, dy, dz));
        const float gc = -(mj / P.density0) * grad_w_coef(rl, P);
        const float coef = (li + lam_t[jj]) * gc;
        fx += coef * dx;
        fy += coef * dy;
        fz += coef * dz;
      });
      float bx = 0.0f, by = 0.0f, bz = 0.0f;
      for_boundary_pairs(C, P, a, xi0,
                         [&](float xb, float yb, float zb, float pb) {
        const float dx = xi[0] - xb, dy = xi[1] - yb, dz = xi[2] - zb;
        const float rl = sqrtf(dist2_rn(dx, dy, dz));
        const float coef = li * (-(pb / P.density0) * grad_w_coef(rl, P));
        bx += coef * dx;
        by += coef * dy;
        bz += coef * dz;
      });
      xi[0] = xi[0] + (-fx - bx);
      xi[1] = xi[1] + (-fy - by);
      xi[2] = xi[2] + (-fz - bz);
    }
    x_out[i] = xi[0];
    x_out[plane + i] = xi[1];
    x_out[2 * plane + i] = xi[2];
  }
}

__global__ void __launch_bounds__(kThreads)
    pbf_xsph_kernel(Cells C, PbfParams P, const float* vt,
                    const float* dens_t, float* v_out) {
  const int a = warp_cell(C);
  if (a >= C.K) return;
  const int plane = C.n_cells * C.cap;
  const int cell = C.active[a];
  for (int s = threadIdx.x % kWarp; s < C.cap; s += kWarp) {
    const int i = cell * C.cap + s;
    const float mi = C.m[i];
    float vi[3] = {vt[i], vt[plane + i], vt[2 * plane + i]};
    if (mi > 0.0f) {
      const float xi[3] = {C.x[i], C.x[plane + i], C.x[2 * plane + i]};
      const float xi0[3] = {C.x0[i], C.x0[plane + i], C.x0[2 * plane + i]};
      float dvx = 0.0f, dvy = 0.0f, dvz = 0.0f;
      for_fluid_pairs(C, P, a, xi0, [&](int jj, float mj) {
        const float rl = sqrtf(dist2_rn(xi[0] - C.x[jj],
                                        xi[1] - C.x[plane + jj],
                                        xi[2] - C.x[2 * plane + jj]));
        const float coef = (mj / fmaxf(dens_t[jj], 1e-6f)) * w_r(rl, P);
        dvx += coef * (vi[0] - vt[jj]);
        dvy += coef * (vi[1] - vt[plane + jj]);
        dvz += coef * (vi[2] - vt[2 * plane + jj]);
      });
      vi[0] = vi[0] + P.neg_visc * dvx;
      vi[1] = vi[1] + P.neg_visc * dvy;
      vi[2] = vi[2] + P.neg_visc * dvz;
    }
    v_out[i] = vi[0];
    v_out[plane + i] = vi[1];
    v_out[2 * plane + i] = vi[2];
  }
}

bool make_cells(Cells* C, const void* x, const void* x0, const void* m,
                const void* count, const void* active, const void* nbr,
                const void* ok, const void* bx, const void* bpsi,
                const void* bcount, int n_cells, int cap, int capb, int K) {
  if (n_cells < 1 || cap < 1 || capb < 0 || K < 1 || K > n_cells) return false;
  if (3LL * n_cells * cap >= INT_MAX || 3LL * n_cells * capb >= INT_MAX ||
      27LL * K >= INT_MAX)
    return false;
  if (!x || !x0 || !m || !count || !active || !nbr || !ok) return false;
  const bool has_b = capb > 0;
  if ((bx != nullptr) != has_b || (bpsi != nullptr) != has_b ||
      (bcount != nullptr) != has_b)
    return false;
  C->x = (const float*)x;
  C->x0 = (const float*)x0;
  C->m = (const float*)m;
  C->count = (const int*)count;
  C->active = (const int*)active;
  C->nbr = (const int*)nbr;
  C->ok = (const uint8_t*)ok;
  C->bx = (const float*)bx;
  C->bpsi = (const float*)bpsi;
  C->bcount = (const int*)bcount;
  C->n_cells = n_cells;
  C->cap = cap;
  C->capb = capb;
  C->K = K;
  return true;
}

int blocks_for(int K) { return (K * kWarp + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int pbd_pbf_param_count() { return N_PARAMS; }

// B3. Writes lam_t and dens_t, (n_cells, cap), at the slots of the K active
// cells. `params` points to N_PARAMS host floats. Returns a CUDA error code,
// 0 when the launch was queued.
int pbd_pbf_density_lambda(const void* x, const void* x0, const void* m,
                           const void* count, const void* active,
                           const void* nbr, const void* ok, const void* bx,
                           const void* bpsi, const void* bcount, int n_cells,
                           int cap, int capb, int K, void* lam_t,
                           void* dens_t, const void* params, void* stream) {
  Cells C;
  if (!make_cells(&C, x, x0, m, count, active, nbr, ok, bx, bpsi, bcount,
                  n_cells, cap, capb, K) ||
      !lam_t || !dens_t || !params)
    return (int)cudaErrorInvalidValue;
  PbfParams P;
  std::memcpy(&P, params, sizeof(P));
  pbf_density_lambda_kernel<<<blocks_for(K), kThreads, 0,
                              (cudaStream_t)stream>>>(C, P, (float*)lam_t,
                                                      (float*)dens_t);
  return (int)cudaGetLastError();
}

// B4. Reads lambda from lam_t; writes x + dx into x_out, (3, n_cells, cap),
// at the slots of the K active cells. x_out is distinct from x and x0.
int pbd_pbf_corrections(const void* x, const void* x0, const void* m,
                        const void* count, const void* active,
                        const void* nbr, const void* ok, const void* bx,
                        const void* bpsi, const void* bcount, int n_cells,
                        int cap, int capb, int K, const void* lam_t,
                        void* x_out, const void* params, void* stream) {
  Cells C;
  if (!make_cells(&C, x, x0, m, count, active, nbr, ok, bx, bpsi, bcount,
                  n_cells, cap, capb, K) ||
      !lam_t || !x_out || !params || x_out == x || x_out == x0)
    return (int)cudaErrorInvalidValue;
  PbfParams P;
  std::memcpy(&P, params, sizeof(P));
  pbf_corrections_kernel<<<blocks_for(K), kThreads, 0,
                           (cudaStream_t)stream>>>(C, P, (const float*)lam_t,
                                                   (float*)x_out);
  return (int)cudaGetLastError();
}

// B5. Reads velocities from vt and densities from dens_t; writes
// v - nu dv into v_out, (3, n_cells, cap), at the slots of the K active
// cells. v_out is distinct from vt. The boundary arguments are checked
// like the other passes' but not read: XSPH runs over fluid pairs only.
int pbd_pbf_xsph(const void* x, const void* x0, const void* m,
                 const void* count, const void* active, const void* nbr,
                 const void* ok, const void* bx, const void* bpsi,
                 const void* bcount, int n_cells, int cap, int capb, int K,
                 const void* vt, const void* dens_t, void* v_out,
                 const void* params, void* stream) {
  Cells C;
  if (!make_cells(&C, x, x0, m, count, active, nbr, ok, bx, bpsi, bcount,
                  n_cells, cap, capb, K) ||
      !vt || !dens_t || !v_out || !params || v_out == vt)
    return (int)cudaErrorInvalidValue;
  PbfParams P;
  std::memcpy(&P, params, sizeof(P));
  pbf_xsph_kernel<<<blocks_for(K), kThreads, 0, (cudaStream_t)stream>>>(
      C, P, (const float*)vt, (const float*)dens_t, (float*)v_out);
  return (int)cudaGetLastError();
}

const char* pbd_pbf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
