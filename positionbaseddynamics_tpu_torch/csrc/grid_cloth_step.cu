// Fused XPBD cloth substep on a regular H x W triangle grid, for Hopper.
//
// Replaces the TPU kernel `kernel` of
// positionbaseddynamics_tpu/solver/grid_cloth_pallas.py::make_pallas_cloth_step
// (body :240-512, pallas_call :527). One launch runs one substep for every
// rollout of a batch: semi-implicit Euler under gravity (pinned particles,
// w = 0, frozen), then `max_iterations` Jacobi passes of the 3 XPBD distance
// families (h, v, and the parity-chosen diagonal) and of the 3 rank-1
// isometric-bending families, then the first-order velocity update and the
// optional damping. Lambda starts at 0 every substep.
//
// What bounds it: each substep reads 6 state planes and writes 6 per
// rollout, and reads the 3 parameter planes (w, icd, icb) once for all
// rollouts that share them: 48 bytes a particle and rollout, plus 12 a
// particle. The arithmetic is a few hundred fp32 operations a particle. At
// 3.35 TB/s and 67 TFLOP/s the card is memory-bound, and at 102,400
// particles a substep is only ~6 MB, so one rollout is bound by launch
// latency rather than either.
//
// Design: the state lives in component planes (B, 3, H, W). A block owns a
// TX x TY tile and loads it with a halo of R = 3 * max_iterations on both
// axes into shared memory (one projection iteration moves information 1
// cell in the distance pass and 2 in the bending pass). Each pass first
// computes every anchor's correction into shared arrays, then every particle
// gathers its terms at the fixed stencil offsets, in the same order as the
// plain PyTorch version scatters them, so the sum needs no atomics and its
// order is fixed. Lambda per family stays in shared memory across
// iterations. Only the tile interior is written, to output buffers distinct
// from the inputs, because neighbouring blocks read this block's cells as
// their halo. Family masks and the triangulation parity come from global
// indices (row + row_offset), so a row-sharded caller can reuse the kernel.
//
// A tile with its halo holds at most kMaxIters iterations in shared memory
// (188 KB at 4). More iterations run as several launches of one substep:
// each launch after the first starts from the positions and the lambda
// planes (B, 6, H, W) that the launch before it wrote, only the first
// integrates, and only the last updates the velocity. Every launch repeats
// the same operations in the same order, so the split changes no result.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int TX = 32;   // tile width  (one warp along a row)
constexpr int TY = 16;   // tile height
// shared planes: x(3) w icd icb, per-family scratch (3 families x 3
// components, reused by the distance and the bending pass), lambda (6)
constexpr int N_PLANES = 3 + 3 + 9 + 6;
constexpr int N_PARAMS = 40;
constexpr int kMaxIters = 4;   // iterations one launch holds
constexpr int kMaxDevices = 64;

// Host-side scalars, laid out as the float vector the Python wrapper builds
// (grid_cloth_cuda.kernel_params).
struct Params {
  float rest[3];       // distance families h, v, d
  float alpha_d[3];    // XPBD compliance 1/(k h^2), 0 where k = 0
  float s_par[3][4];   // bending S vectors bh, bv, bd where helper(i,j) = 1
  float s_npar[3][4];  // ... where helper(i,j) = 0
  float alpha_b[3];
  float h;             // substep length
  float g[3];          // gravity
  float damp;          // velocity factor 1 - damping
  float use_damp;      // 1 when damping != 0
  float pad_;
};
static_assert(sizeof(Params) == N_PARAMS * sizeof(float), "param layout");

// One term of a bending stencil point: kind 0 always, 1 where the anchor's
// parity helper(i,j) is 1, 2 where it is 0; (di, dj) from the anchor.
struct Term {
  int kind, di, dj;
};
struct Slot {
  int n;
  Term t[2];
};
// Points [a, b, f0, f1] of the families bh, bv, bd, matching the S index
// order of the bending factor (grid_cloth_pallas.py:117-131).
__constant__ Slot kBend[3][4] = {
    {{1, {{0, 0, 0}, {0, 0, 0}}},
     {1, {{0, 0, 1}, {0, 0, 0}}},
     {2, {{1, 1, 1}, {2, 1, 0}}},
     {2, {{1, -1, 1}, {2, -1, 0}}}},
    {{1, {{0, 0, 0}, {0, 0, 0}}},
     {1, {{0, 1, 0}, {0, 0, 0}}},
     {2, {{1, 1, 1}, {2, 0, 1}}},
     {2, {{1, 1, -1}, {2, 0, -1}}}},
    {{2, {{1, 0, 0}, {2, 0, 1}}},
     {2, {{1, 1, 1}, {2, 1, 0}}},
     {2, {{1, 0, 1}, {2, 0, 0}}},
     {2, {{1, 1, 0}, {2, 1, 1}}}},
};

__device__ __forceinline__ bool parity(int gi, int gj) {
  return (gi & 1) == (gj & 1);
}

// Family masks over global anchor indices (grid_cloth_pallas.py:223-238).
__device__ __forceinline__ bool dist_mask(int f, int gi, int gj, int H, int W) {
  if (gj < 0 || gi < 0) return false;
  switch (f) {
    case 0: return gi <= H - 1 && gj <= W - 2;   // h
    case 1: return gi <= H - 2 && gj <= W - 1;   // v
    default: return gi <= H - 2 && gj <= W - 2;  // d
  }
}

__device__ __forceinline__ bool bend_mask(int f, int gi, int gj, int H, int W) {
  if (gj < 0 || gi < 0) return false;
  switch (f) {
    case 0: return gi >= 1 && gi <= H - 2 && gj <= W - 2;   // bh
    case 1: return gi <= H - 2 && gj >= 1 && gj <= W - 2;   // bv
    default: return gi <= H - 2 && gj <= W - 2;             // bd
  }
}

// x_in, v_in: the substep's input state. x_cur, lam_in: the positions and
// lambdas a previous launch of this substep left, or null in the first
// launch (integrate, lambda = 0). v_out null: not the last launch, so write
// the positions to x_out and the lambdas to lam_out; else finish the
// substep into x_out, v_out.
__global__ void __launch_bounds__(TX * TY)
cloth_substep_kernel(const float* __restrict__ x_in,
                     const float* __restrict__ v_in,
                     const float* __restrict__ x_cur,
                     const float* __restrict__ lam_in,
                     float* __restrict__ x_out, float* __restrict__ v_out,
                     float* __restrict__ lam_out,
                     const float* __restrict__ w_g, long long w_bstride,
                     const float* __restrict__ icd_g,
                     const float* __restrict__ icb_g, const Params P, int H,
                     int W, int iters, int row_offset, int H_global) {
  extern __shared__ float smem[];
  const int R = 3 * iters;
  const int SX = TX + 2 * R, SY = TY + 2 * R, S = SX * SY;
  float* sx[3] = {smem, smem + S, smem + 2 * S};
  float* sw = smem + 3 * S;
  float* sicd = smem + 4 * S;
  float* sicb = smem + 5 * S;
  float* scr = smem + 6 * S;       // 9 planes: family f, component c
  float* slam = smem + 15 * S;     // 6 planes: h v d bh bv bd

  const long long plane = (long long)H * W;
  const long long boff = (long long)blockIdx.z * 3 * plane;
  const long long loff = (long long)blockIdx.z * 6 * plane;
  const float* xb = x_in + boff;
  const float* vb = v_in + boff;
  const float* wb = w_g + (long long)blockIdx.z * w_bstride;
  const int gi0 = blockIdx.y * TY - R;   // local grid row of shared row 0
  const int gj0 = blockIdx.x * TX - R;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthr = TX * TY;
  const float h = P.h;

  // ---- load the tile + halo; in the first launch of a substep,
  //      integrate (TimeIntegration.cpp:7-19) ----
  for (int c = tid; c < S; c += nthr) {
    const int ly = c / SX, lx = c - ly * SX;
    const int gi = gi0 + ly, gj = gj0 + lx;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, w = 0.f, cd = 0.f, cb = 0.f;
    float lam[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
      const long long g = (long long)gi * W + gj;
      w = wb[g];
      cd = icd_g[g];
      cb = icb_g[g];
      if (x_cur != nullptr) {
        const float* xc = x_cur + boff;
        x0 = xc[g];
        x1 = xc[plane + g];
        x2 = xc[2 * plane + g];
#pragma unroll
        for (int f = 0; f < 6; ++f) lam[f] = lam_in[loff + f * plane + g];
      } else {
        x0 = xb[g];
        x1 = xb[plane + g];
        x2 = xb[2 * plane + g];
        if (w > 0.f) {
          const float v0 = vb[g] + P.g[0] * h;
          const float v1 = vb[plane + g] + P.g[1] * h;
          const float v2 = vb[2 * plane + g] + P.g[2] * h;
          x0 = x0 + v0 * h;
          x1 = x1 + v1 * h;
          x2 = x2 + v2 * h;
        }
      }
    }
    sx[0][c] = x0;
    sx[1][c] = x1;
    sx[2][c] = x2;
    sw[c] = w;
    sicd[c] = cd;
    sicb[c] = cb;
#pragma unroll
    for (int f = 0; f < 6; ++f) slam[f * S + c] = lam[f];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // ---- distance families, per anchor (XPBD.cpp:14-60) ----
    for (int c = tid; c < S; c += nthr) {
      const int ly = c / SX, lx = c - ly * SX;
      const int gi = gi0 + ly + row_offset, gj = gj0 + lx;
      const bool par = parity(gi, gj);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        // endpoints a, b as shared offsets from the anchor
        int ia = c, ib;
        bool inb;
        if (f == 0) {
          ib = c + 1;
          inb = lx + 1 < SX;
        } else if (f == 1) {
          ib = c + SX;
          inb = ly + 1 < SY;
        } else {
          ia = par ? c : c + 1;
          ib = par ? c + SX + 1 : c + SX;
          inb = lx + 1 < SX && ly + 1 < SY;
        }
        float p0 = 0.f, p1 = 0.f, p2 = 0.f;
        if (inb && dist_mask(f, gi, gj, H_global, W)) {
          const float n0 = sx[0][ia] - sx[0][ib];
          const float n1 = sx[1][ia] - sx[1][ib];
          const float n2 = sx[2][ia] - sx[2][ib];
          const float d = sqrtf(n0 * n0 + n1 * n1 + n2 * n2);
          const float cc = d - P.rest[f];
          const float dm = fmaxf(d, 1e-6f);
          const float alpha = P.alpha_d[f];
          const float k = sw[ia] + sw[ib] + alpha;
          const bool valid = (d > 1e-6f) && (fabsf(k) > 1e-6f);
          float* lam = slam + f * S + c;
          const float dl = valid ? -(cc + alpha * *lam) / k : 0.f;
          *lam = *lam + dl;
          p0 = (n0 / dm) * dl;
          p1 = (n1 / dm) * dl;
          p2 = (n2 / dm) * dl;
        }
        scr[(3 * f + 0) * S + c] = p0;
        scr[(3 * f + 1) * S + c] = p1;
        scr[(3 * f + 2) * S + c] = p2;
      }
    }
    __syncthreads();
    // ---- distance gather: a += w*pt, b -= w*pt, in scatter order ----
    for (int c = tid; c < S; c += nthr) {
      const int ly = c / SX, lx = c - ly * SX;
      const int gi = gi0 + ly + row_offset, gj = gj0 + lx;
      const float wP = sw[c], nwP = -wP;
      float acc[3] = {0.f, 0.f, 0.f};
      // h: a at (0,0), b at (0,1)
      for (int k = 0; k < 3; ++k) acc[k] = acc[k] + wP * scr[k * S + c];
      if (lx >= 1)
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + nwP * scr[k * S + c - 1];
      // v: a at (0,0), b at (1,0)
      for (int k = 0; k < 3; ++k) acc[k] = acc[k] + wP * scr[(3 + k) * S + c];
      if (ly >= 1)
        for (int k = 0; k < 3; ++k)
          acc[k] = acc[k] + nwP * scr[(3 + k) * S + c - SX];
      // d: a = p(0,0) q(0,1); b = p(1,1) q(1,0)
      const float* sd = scr + 6 * S;
      if (parity(gi, gj))
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + wP * sd[k * S + c];
      if (lx >= 1 && !parity(gi, gj - 1))
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + wP * sd[k * S + c - 1];
      if (lx >= 1 && ly >= 1 && parity(gi - 1, gj - 1))
        for (int k = 0; k < 3; ++k)
          acc[k] = acc[k] + nwP * sd[k * S + c - SX - 1];
      if (ly >= 1 && !parity(gi - 1, gj))
        for (int k = 0; k < 3; ++k)
          acc[k] = acc[k] + nwP * sd[k * S + c - SX];
      const float icd = sicd[c];
      for (int k = 0; k < 3; ++k) sx[k][c] = sx[k][c] + icd * acc[k];
    }
    __syncthreads();

    // ---- isometric bending, rank-1 (XPBD.cpp:153-213):
    //      t = sum_j S_j x_j, C = -|t|^2/2, grad_j C = -S_j t ----
    for (int c = tid; c < S; c += nthr) {
      const int ly = c / SX, lx = c - ly * SX;
      const int gi = gi0 + ly + row_offset, gj = gj0 + lx;
      const bool par = parity(gi, gj);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        float o0 = 0.f, o1 = 0.f, o2 = 0.f;
        int idx[4];
        bool inb = bend_mask(f, gi, gj, H_global, W);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Slot& sl = kBend[f][j];
          const Term& t = (sl.n == 1 || par) ? sl.t[0] : sl.t[1];
          const int py = ly + t.di, px = lx + t.dj;
          inb = inb && py >= 0 && py < SY && px >= 0 && px < SX;
          idx[j] = py * SX + px;
        }
        if (inb) {
          const float* s = par ? P.s_par[f] : P.s_npar[f];
          float t0 = s[0] * sx[0][idx[0]];
          float t1 = s[0] * sx[1][idx[0]];
          float t2 = s[0] * sx[2][idx[0]];
          float ws2 = (sw[idx[0]] * s[0]) * s[0];
#pragma unroll
          for (int j = 1; j < 4; ++j) {
            t0 = t0 + s[j] * sx[0][idx[j]];
            t1 = t1 + s[j] * sx[1][idx[j]];
            t2 = t2 + s[j] * sx[2][idx[j]];
            ws2 = ws2 + (sw[idx[j]] * s[j]) * s[j];
          }
          const float tt = t0 * t0 + t1 * t1 + t2 * t2;
          const float energy = -0.5f * tt;
          const float alpha = P.alpha_b[f];
          const float kk = ws2 * tt + alpha;
          const bool valid = fabsf(kk) > 1e-9f;
          float* lam = slam + (3 + f) * S + c;
          const float dl = valid ? -(energy + alpha * *lam) / kk : 0.f;
          *lam = *lam + dl;
          o0 = dl * t0;
          o1 = dl * t1;
          o2 = dl * t2;
        }
        scr[(3 * f + 0) * S + c] = o0;
        scr[(3 * f + 1) * S + c] = o1;
        scr[(3 * f + 2) * S + c] = o2;
      }
    }
    __syncthreads();
    // ---- bending gather: point j of anchor A takes -w S_j(A) (dl t)(A) ----
    for (int c = tid; c < S; c += nthr) {
      const int ly = c / SX, lx = c - ly * SX;
      const int gi = gi0 + ly + row_offset, gj = gj0 + lx;
      const float nwP = -sw[c];
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int f = 0; f < 3; ++f) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Slot& sl = kBend[f][j];
          for (int q = 0; q < sl.n; ++q) {
            const Term& t = sl.t[q];
            const int ay = ly - t.di, ax = lx - t.dj;
            if (ay < 0 || ay >= SY || ax < 0 || ax >= SX) continue;
            const bool apar = parity(gi - t.di, gj - t.dj);
            if (t.kind == 1 && !apar) continue;
            if (t.kind == 2 && apar) continue;
            const float sj = apar ? P.s_par[f][j] : P.s_npar[f][j];
            const float cw = nwP * sj;
            const int a = ay * SX + ax;
            for (int k = 0; k < 3; ++k)
              acc[k] = acc[k] + cw * scr[(3 * f + k) * S + a];
          }
        }
      }
      const float icb = sicb[c];
      for (int k = 0; k < 3; ++k) sx[k][c] = sx[k][c] + icb * acc[k];
    }
    __syncthreads();
  }

  // ---- tile interior: in the last launch of a substep, the first-order
  //      velocity update (TimeIntegration.cpp:42-51) and damping; the
  //      write-back ----
  const int gi = blockIdx.y * TY + threadIdx.y;
  const int gj = blockIdx.x * TX + threadIdx.x;
  if (gi < H && gj < W) {
    const int c = (threadIdx.y + R) * SX + threadIdx.x + R;
    const long long g = (long long)gi * W + gj;
    const float w = sw[c];
    float* xo = x_out + boff;
#pragma unroll
    for (int k = 0; k < 3; ++k) xo[k * plane + g] = sx[k][c];
    if (v_out != nullptr) {
      float* vo = v_out + boff;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float x = sx[k][c];
        float v = w > 0.f ? (x - xb[k * plane + g]) / h : vb[k * plane + g];
        if (P.use_damp != 0.f) v = v * P.damp;
        vo[k * plane + g] = v;
      }
    } else {
#pragma unroll
      for (int f = 0; f < 6; ++f)
        lam_out[loff + f * plane + g] = slam[f * S + c];
    }
  }
}

// Dynamic shared memory one block needs for `iters` projection iterations.
long long smem_bytes(int iters) {
  const long long r = 3LL * iters;
  return (TX + 2 * r) * (TY + 2 * r) * N_PLANES * (long long)sizeof(float);
}

// Opt in to the largest tile's dynamic shared memory once per device: the
// attribute holds for every later launch there.
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(cloth_substep_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes(kMaxIters));
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

}  // namespace

extern "C" {

int pbd_cloth_param_count() { return N_PARAMS; }

int pbd_cloth_max_iterations() { return kMaxIters; }

// One launch of a substep for `n_batch` rollouts, running `iters` (1 to
// kMaxIters) iterations. State planes are (B, 3, H, W) float32 and lambda
// planes (B, 6, H, W), every output distinct from every input. x_cur and
// lam_in are null in a substep's first launch; v_out is null and lam_out
// set in every launch but its last. w is (H, W) with batch stride
// `w_bstride` elements (0 when the rollouts share it); icd, icb are (H, W).
// `params` points to N_PARAMS host floats. Returns a CUDA error code, 0
// when the launch was queued.
int pbd_cloth_substep(const void* x_in, const void* v_in, const void* x_cur,
                      const void* lam_in, void* x_out, void* v_out,
                      void* lam_out, const void* w, long long w_bstride,
                      const void* icd, const void* icb, const void* params,
                      int n_batch, int height, int width, int iters,
                      int row_offset, int global_height, void* stream) {
  const bool first = x_cur == nullptr, last = v_out != nullptr;
  if (iters < 1 || iters > kMaxIters || first != (lam_in == nullptr) ||
      last != (lam_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Params P;
  std::memcpy(&P, params, sizeof(P));
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const dim3 block(TX, TY, 1);
  const dim3 grid((width + TX - 1) / TX, (height + TY - 1) / TY, n_batch);
  cloth_substep_kernel<<<grid, block, (size_t)smem_bytes(iters),
                         (cudaStream_t)stream>>>(
      (const float*)x_in, (const float*)v_in, (const float*)x_cur,
      (const float*)lam_in, (float*)x_out, (float*)v_out, (float*)lam_out,
      (const float*)w, w_bstride, (const float*)icd, (const float*)icb, P,
      height, width, iters, row_offset, global_height);
  return (int)cudaGetLastError();
}

const char* pbd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
