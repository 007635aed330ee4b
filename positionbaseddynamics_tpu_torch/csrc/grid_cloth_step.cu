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
// TX x TY tile and loads it with a halo of R = 3 * ITERS on both axes into
// shared memory (one projection iteration moves information 1 cell in the
// distance pass and 2 in the bending pass). ITERS, the iterations a launch
// runs (1 to kMaxIters), is a template parameter, so the window, its size
// and every cell's coordinates are compile-time arithmetic. Each thread
// owns a fixed set of the window's cells for the whole launch (cells
// t + k * threads, k < Window::NC): it loads them, solves the constraints
// anchored there, gathers their corrections and writes them back, so each
// anchor's 6 lambdas and the cell's Jacobi weights icd, icb live in its
// registers. Shared memory holds only what neighbours read: the positions,
// the inverse masses and 3 correction planes per family. Each pass first
// computes every anchor's correction into that scratch, then every
// particle gathers its terms at the fixed stencil offsets, in the same
// order as the plain PyTorch version scatters them, so the sum needs no
// atomics and its order is fixed. The bending stencils are literal offsets
// for each anchor parity (bend_point; no table), selected per lane, and
// the S vectors are read at compile-time offsets of the launch parameters.
// Only the tile interior is written, to output buffers distinct from the
// inputs, because neighbouring blocks read this block's cells as their
// halo. Family masks and the triangulation parity come from global indices
// (row + row_offset), so a row-sharded caller can reuse the kernel.
//
// A launch holds at most kMaxIters iterations. More iterations run as
// several launches of one substep: each launch after the first starts from
// the positions and the lambda planes (B, 6, H, W) that the launch before
// it wrote, only the first integrates, and only the last updates the
// velocity. Every launch repeats the same operations in the same order, so
// the split changes no result.
//
// Fused mode (FUSED = 1, the counterpart of the TPU kernel's
// fuse_substeps, grid_cloth_pallas.py:440): one launch runs `subs` whole
// substeps of `iters` iterations, iters * subs <= ITERS <= kMaxPasses, so
// the state crosses device memory once a step instead of once a substep.
// The window's halo grows to R = 3 * ITERS, the influence radius of that
// many passes, and every substep after the first integrates from the
// registers: each owned cell keeps its velocity and its substep's start
// position there beside its lambdas and Jacobi weights, and shared memory
// holds the same 13 planes. At 5 passes a 32x16 tile's window is 62x46
// cells (148 KB of shared memory, 5.6x the tile's cells solved a pass,
// against 1.6x at one iteration a launch). A step of more passes than a
// launch holds takes launches of fewer substeps each; every substep does
// the same operations in the same order, so the split changes no result.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int TX = 32;   // tile width
constexpr int TY = 16;   // tile height
// shared planes: x(3) w, per-family scratch (3 families x 3 components,
// reused by the distance and the bending pass)
constexpr int N_PLANES = 3 + 1 + 9;
constexpr int N_PARAMS = 40;
constexpr int kMaxIters = 4;     // iterations one launch holds
constexpr int kMaxPasses = 5;    // iterations x substeps one fused launch holds
constexpr int kMaxDevices = 64;
// cells a thread owns beyond ITERS. At one iteration one cell a thread
// (864 threads a 32x16 tile) took 14.1 us a launch at 320x320 against
// 15.2 us for two (448 threads) at one rollout, and 44.0-47.7 against
// 43.5 us at four (scripts/cloth_tile_sweep.py, an H100 SXM at 700 W)
constexpr int kExtraCells = 0;

// The window of a launch that runs ITERS passes (iterations, times
// substeps in the fused mode): the tile with a halo of R on every side, S
// cells, NC of them owned by each of its `threads`.
template <int ITERS>
struct Window {
  static constexpr int R = 3 * ITERS;
  static constexpr int SX = TX + 2 * R, SY = TY + 2 * R, S = SX * SY;
  static constexpr int NC = ITERS + kExtraCells;
  static constexpr int threads = ((S + NC - 1) / NC + 31) / 32 * 32;
  // blocks an SM the registers are held to allow: 3 at one iteration,
  // fewer where the threads do not fit 3 times
  static constexpr int min_blocks =
      ITERS > 1 ? 1 : (2048 / threads < 3 ? 2048 / threads : 3);
  static constexpr size_t smem = (size_t)S * N_PLANES * sizeof(float);
};

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

// Offset (di, dj) from its anchor of point j (a, b, f0, f1: the S index
// order of the bending factor, grid_cloth_pallas.py:117-131) of bending
// family f (bh, bv, bd), at an anchor whose parity helper(i,j) is `par`.
struct Off {
  int di, dj;
};

__host__ __device__ constexpr Off bend_point(int f, int j, bool par) {
  return f == 0   ? (j == 0   ? Off{0, 0}
                     : j == 1 ? Off{0, 1}
                              : Off{j == 2 ? 1 : -1, par ? 1 : 0})
         : f == 1 ? (j == 0   ? Off{0, 0}
                     : j == 1 ? Off{1, 0}
                              : Off{par ? 1 : 0, j == 2 ? 1 : -1})
         : j == 0 ? (par ? Off{0, 0} : Off{0, 1})
         : j == 1 ? (par ? Off{1, 1} : Off{1, 0})
         : j == 2 ? (par ? Off{0, 1} : Off{0, 0})
                  : (par ? Off{1, 0} : Off{1, 1});
}

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
// substep into x_out, v_out. FUSED = 1: `subs` substeps of `iters`
// iterations (iters * subs <= ITERS) from x_in, v_in into x_out, v_out;
// x_cur, lam_in and lam_out are null. H rows of the grid are in the planes;
// row r of them is row r + row_offset of a grid of H_global rows.
template <int ITERS, int FUSED>
__global__ void __launch_bounds__(Window<ITERS>::threads,
                                  Window<ITERS>::min_blocks)
cloth_substep_kernel(const float* __restrict__ x_in,
                     const float* __restrict__ v_in,
                     const float* __restrict__ x_cur,
                     const float* __restrict__ lam_in,
                     float* __restrict__ x_out, float* __restrict__ v_out,
                     float* __restrict__ lam_out,
                     const float* __restrict__ w_g, long long w_bstride,
                     const float* __restrict__ icd_g,
                     const float* __restrict__ icb_g, const Params P, int H,
                     int W, int row_offset, int H_global, int iters,
                     int subs) {
  using Wd = Window<ITERS>;
  constexpr int R = Wd::R, SX = Wd::SX, SY = Wd::SY, S = Wd::S, NC = Wd::NC;
  constexpr int NT = Wd::threads;
  constexpr int NF = FUSED ? NC : 1;
  const int n_iters = FUSED ? iters : ITERS;
  const int n_subs = FUSED ? subs : 1;
  extern __shared__ float smem[];
  float* sx[3] = {smem, smem + S, smem + 2 * S};
  float* sw = smem + 3 * S;
  float* scr = smem + 4 * S;       // 9 planes: family f, component q

  const long long plane = (long long)H * W;
  const long long boff = (long long)blockIdx.z * 3 * plane;
  const long long loff = (long long)blockIdx.z * 6 * plane;
  const float* xb = x_in + boff;
  const float* vb = v_in + boff;
  const float* wb = w_g + (long long)blockIdx.z * w_bstride;
  const int gi0 = blockIdx.y * TY - R;   // local grid row of shared row 0
  const int gj0 = blockIdx.x * TX - R;
  const int t = threadIdx.x;
  const float h = P.h;
  // the owned cells' lambdas (h v d bh bv bd) and Jacobi weights; fused:
  // their velocities and the substep's start positions
  float lam[NC][6], icd[NC], icb[NC], vr[NF][3], xs[NF][3];

  // ---- load the tile + halo; in the first launch of a substep,
  //      integrate (TimeIntegration.cpp:7-19) ----
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = t + k * NT;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, w = 0.f, cd = 0.f, cb = 0.f;
#pragma unroll
    for (int f = 0; f < 6; ++f) lam[k][f] = 0.f;
    if constexpr (FUSED) {
#pragma unroll
      for (int q = 0; q < 3; ++q) vr[k][q] = xs[k][q] = 0.f;
    }
    if (c < S) {
      const int ly = c / SX, lx = c - ly * SX;
      const int gi = gi0 + ly, gj = gj0 + lx;
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
          for (int f = 0; f < 6; ++f)
            lam[k][f] = lam_in[loff + f * plane + g];
        } else {
          x0 = xb[g];
          x1 = xb[plane + g];
          x2 = xb[2 * plane + g];
          if constexpr (FUSED) {
            xs[k][0] = x0;
            xs[k][1] = x1;
            xs[k][2] = x2;
            vr[k][0] = vb[g];
            vr[k][1] = vb[plane + g];
            vr[k][2] = vb[2 * plane + g];
          }
          if (w > 0.f) {
            const float v0 = vb[g] + P.g[0] * h;
            const float v1 = vb[plane + g] + P.g[1] * h;
            const float v2 = vb[2 * plane + g] + P.g[2] * h;
            if constexpr (FUSED) {
              vr[k][0] = v0;
              vr[k][1] = v1;
              vr[k][2] = v2;
            }
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
    }
    icd[k] = cd;
    icb[k] = cb;
  }
  __syncthreads();

#pragma unroll 1
  for (int sub = 0; sub < n_subs; ++sub) {
    if constexpr (FUSED) {
      if (sub > 0) {
        // next substep: lambda = 0, integrate from the registers
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int c = t + k * NT;
          if (c >= S) continue;
          const bool dyn = sw[c] > 0.f;
#pragma unroll
          for (int f = 0; f < 6; ++f) lam[k][f] = 0.f;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            xs[k][q] = sx[q][c];
            if (dyn) {
              vr[k][q] = vr[k][q] + P.g[q] * h;
              sx[q][c] = sx[q][c] + vr[k][q] * h;
            }
          }
        }
        __syncthreads();
      }
    }
#pragma unroll 1
    for (int it = 0; it < n_iters; ++it) {
      // ---- distance families, per anchor (XPBD.cpp:14-60) ----
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = t + k * NT;
        if (c >= S) continue;
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
            const float kk = sw[ia] + sw[ib] + alpha;
            const bool valid = (d > 1e-6f) && (fabsf(kk) > 1e-6f);
            const float dl = valid ? -(cc + alpha * lam[k][f]) / kk : 0.f;
            lam[k][f] = lam[k][f] + dl;
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
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = t + k * NT;
        if (c >= S) continue;
        const int ly = c / SX, lx = c - ly * SX;
        const bool par = parity(gi0 + ly + row_offset, gj0 + lx);
        const float wP = sw[c], nwP = -wP;
        float acc[3] = {0.f, 0.f, 0.f};
        // h: a at (0,0), b at (0,1)
        for (int q = 0; q < 3; ++q) acc[q] = acc[q] + wP * scr[q * S + c];
        if (lx >= 1)
          for (int q = 0; q < 3; ++q)
            acc[q] = acc[q] + nwP * scr[q * S + c - 1];
        // v: a at (0,0), b at (1,0)
        for (int q = 0; q < 3; ++q)
          acc[q] = acc[q] + wP * scr[(3 + q) * S + c];
        if (ly >= 1)
          for (int q = 0; q < 3; ++q)
            acc[q] = acc[q] + nwP * scr[(3 + q) * S + c - SX];
        // d: a = p(0,0) q(0,1); b = p(1,1) q(1,0). The anchors at (0,-1)
        // and (-1,0) have the other parity than this cell, (-1,-1) the same.
        const float* sd = scr + 6 * S;
        if (par)
          for (int q = 0; q < 3; ++q) acc[q] = acc[q] + wP * sd[q * S + c];
        if (lx >= 1 && par)
          for (int q = 0; q < 3; ++q)
            acc[q] = acc[q] + wP * sd[q * S + c - 1];
        if (lx >= 1 && ly >= 1 && par)
          for (int q = 0; q < 3; ++q)
            acc[q] = acc[q] + nwP * sd[q * S + c - SX - 1];
        if (ly >= 1 && par)
          for (int q = 0; q < 3; ++q)
            acc[q] = acc[q] + nwP * sd[q * S + c - SX];
        for (int q = 0; q < 3; ++q) sx[q][c] = sx[q][c] + icd[k] * acc[q];
      }
      __syncthreads();

      // ---- isometric bending, rank-1 (XPBD.cpp:153-213):
      //      t = sum_j S_j x_j, C = -|t|^2/2, grad_j C = -S_j t ----
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = t + k * NT;
        if (c >= S) continue;
        const int ly = c / SX, lx = c - ly * SX;
        const int gi = gi0 + ly + row_offset, gj = gj0 + lx;
        const bool par = parity(gi, gj);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          float o0 = 0.f, o1 = 0.f, o2 = 0.f;
          int idx[4];
          float s[4];
          bool inb = bend_mask(f, gi, gj, H_global, W);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Off a = bend_point(f, j, true), b = bend_point(f, j, false);
            const int py = ly + (par ? a.di : b.di);
            const int px = lx + (par ? a.dj : b.dj);
            inb = inb && py >= 0 && py < SY && px >= 0 && px < SX;
            idx[j] = py * SX + px;
            s[j] = par ? P.s_par[f][j] : P.s_npar[f][j];
          }
          if (inb) {
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
            const float dl =
                valid ? -(energy + alpha * lam[k][3 + f]) / kk : 0.f;
            lam[k][3 + f] = lam[k][3 + f] + dl;
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
      // ---- bending gather: point j of anchor A takes -w S_j(A) (dl t)(A).
      //      Per point, in the plain version's order: where its offset does
      //      not depend on the anchor's parity, the one term; else the term
      //      of an anchor of parity 1, then of one of parity 0 ----
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = t + k * NT;
        if (c >= S) continue;
        const int ly = c / SX, lx = c - ly * SX;
        const bool ppar = parity(gi0 + ly + row_offset, gj0 + lx);
        const float nwP = -sw[c];
        float acc[3] = {0.f, 0.f, 0.f};
        // the term of point j of family f at offset o from its anchor, an
        // anchor of parity `want` unless `any`
        auto term = [&](int f, int j, Off o, bool any, bool want) {
          const int ay = ly - o.di, ax = lx - o.dj;
          if (ay < 0 || ay >= SY || ax < 0 || ax >= SX) return;
          const bool apar = ((o.di + o.dj) & 1) ? !ppar : ppar;
          if (!any && apar != want) return;
          const float sj = apar ? P.s_par[f][j] : P.s_npar[f][j];
          const float cw = nwP * sj;
          const int a = ay * SX + ax;
          for (int q = 0; q < 3; ++q)
            acc[q] = acc[q] + cw * scr[(3 * f + q) * S + a];
        };
#pragma unroll
        for (int f = 0; f < 3; ++f) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const Off a = bend_point(f, j, true), b = bend_point(f, j, false);
            if (a.di == b.di && a.dj == b.dj) {
              term(f, j, a, true, true);
            } else {
              term(f, j, a, false, true);
              term(f, j, b, false, false);
            }
          }
        }
        for (int q = 0; q < 3; ++q) sx[q][c] = sx[q][c] + icb[k] * acc[q];
      }
      __syncthreads();
    }
    if constexpr (FUSED) {
      // the substep's first-order velocity update and damping, owned cells
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = t + k * NT;
        if (c >= S) continue;
        const float w = sw[c];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float v = w > 0.f ? (sx[q][c] - xs[k][q]) / h : vr[k][q];
          if (P.use_damp != 0.f) v = v * P.damp;
          vr[k][q] = v;
        }
      }
    }
  }  // substeps

  // ---- tile interior: in the last launch of a substep, the first-order
  //      velocity update (TimeIntegration.cpp:42-51) and damping; the
  //      write-back, each owned cell by its thread ----
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = t + k * NT;
    if (c >= S) continue;
    const int ly = c / SX, lx = c - ly * SX;
    const int gi = gi0 + ly, gj = gj0 + lx;
    if (ly < R || ly >= R + TY || lx < R || lx >= R + TX || gi >= H ||
        gj >= W)
      continue;
    const long long g = (long long)gi * W + gj;
    const float w = sw[c];
    float* xo = x_out + boff;
#pragma unroll
    for (int q = 0; q < 3; ++q) xo[q * plane + g] = sx[q][c];
    if constexpr (FUSED) {
      float* vo = v_out + boff;
#pragma unroll
      for (int q = 0; q < 3; ++q) vo[q * plane + g] = vr[k][q];
    } else if (v_out != nullptr) {
      float* vo = v_out + boff;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float x = sx[q][c];
        float v = w > 0.f ? (x - xb[q * plane + g]) / h : vb[q * plane + g];
        if (P.use_damp != 0.f) v = v * P.damp;
        vo[q * plane + g] = v;
      }
    } else {
#pragma unroll
      for (int f = 0; f < 6; ++f) lam_out[loff + f * plane + g] = lam[k][f];
    }
  }
}  // cloth_substep_kernel

// Opt in to the window's dynamic shared memory once per device: the
// attribute holds for every later launch there.
template <int ITERS, int FUSED>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(cloth_substep_kernel<ITERS, FUSED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Window<ITERS>::smem);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

// The arguments of one launch.
struct Launch {
  const float *x_in, *v_in, *x_cur, *lam_in;
  float *x_out, *v_out, *lam_out;
  const float* w;
  long long w_bstride;
  const float *icd, *icb;
  Params P;
  int n_batch, H, W, row_offset, H_global, iters, subs;
  cudaStream_t stream;
};

template <int ITERS, int FUSED>
cudaError_t launch(const Launch& L) {
  const cudaError_t e = allow_smem<ITERS, FUSED>();
  if (e != cudaSuccess) return e;
  const dim3 grid((L.W + TX - 1) / TX, (L.H + TY - 1) / TY, L.n_batch);
  cloth_substep_kernel<ITERS, FUSED>
      <<<grid, Window<ITERS>::threads, Window<ITERS>::smem, L.stream>>>(
          L.x_in, L.v_in, L.x_cur, L.lam_in, L.x_out, L.v_out, L.lam_out,
          L.w, L.w_bstride, L.icd, L.icb, L.P, L.H, L.W, L.row_offset,
          L.H_global, L.iters, L.subs);
  return cudaGetLastError();
}

template <int ITERS, int FUSED>
cudaError_t resources(int* out) {
  cudaError_t err = allow_smem<ITERS, FUSED>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, cloth_substep_kernel<ITERS, FUSED>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, cloth_substep_kernel<ITERS, FUSED>, Window<ITERS>::threads,
      Window<ITERS>::smem);
  if (err != cudaSuccess) return err;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)Window<ITERS>::smem;
  out[3] = (int)at.localSizeBytes;
  out[4] = blocks;
  out[5] = Window<ITERS>::threads;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int pbd_cloth_param_count() { return N_PARAMS; }

int pbd_cloth_max_iterations() { return kMaxIters; }

int pbd_cloth_max_passes() { return kMaxPasses; }

// Resources of the kernel that runs `iters` iterations (1 to kMaxIters),
// as the runtime sees them: out[0] registers a thread, out[1] static
// shared bytes a block, out[2] dynamic shared bytes a block, out[3] local
// (spill) bytes a thread, out[4] resident blocks an SM, out[5] threads a
// block. Returns a CUDA error code.
int pbd_cloth_kernel_resources(int iters, int* out) {
  if (!out) return (int)cudaErrorInvalidValue;
  switch (iters) {
    case 1: return (int)resources<1, 0>(out);
    case 2: return (int)resources<2, 0>(out);
    case 3: return (int)resources<3, 0>(out);
    case 4: return (int)resources<4, 0>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same for the fused kernel whose window holds `passes` (1 to
// kMaxPasses) iterations times substeps.
int pbd_cloth_fused_resources(int passes, int* out) {
  if (!out) return (int)cudaErrorInvalidValue;
  switch (passes) {
    case 1: return (int)resources<1, 1>(out);
    case 2: return (int)resources<2, 1>(out);
    case 3: return (int)resources<3, 1>(out);
    case 4: return (int)resources<4, 1>(out);
    case 5: return (int)resources<5, 1>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of a substep for `n_batch` rollouts, running `iters` (1 to
// kMaxIters) iterations. State planes are (B, 3, H, W) float32 and lambda
// planes (B, 6, H, W), every output distinct from every input. x_cur and
// lam_in are null in a substep's first launch; v_out is null and lam_out
// set in every launch but its last. w is (H, W) with batch stride
// `w_bstride` elements (0 when the rollouts share it); icd, icb are (H, W).
// The H rows are rows row_offset.. of a grid of global_height rows (0 and H
// for a whole grid). `params` points to N_PARAMS host floats. Returns a
// CUDA error code, 0 when the launch was queued.
int pbd_cloth_substep(const void* x_in, const void* v_in, const void* x_cur,
                      const void* lam_in, void* x_out, void* v_out,
                      void* lam_out, const void* w, long long w_bstride,
                      const void* icd, const void* icb, const void* params,
                      int n_batch, int height, int width, int iters,
                      int row_offset, int global_height, void* stream) {
  const bool first = x_cur == nullptr, last = v_out != nullptr;
  if (first != (lam_in == nullptr) || last != (lam_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Launch L{(const float*)x_in, (const float*)v_in, (const float*)x_cur,
           (const float*)lam_in, (float*)x_out, (float*)v_out,
           (float*)lam_out, (const float*)w, w_bstride, (const float*)icd,
           (const float*)icb, Params{}, n_batch, height, width, row_offset,
           global_height, iters, 1, (cudaStream_t)stream};
  std::memcpy(&L.P, params, sizeof(L.P));
  switch (iters) {
    case 1: return (int)launch<1, 0>(L);
    case 2: return (int)launch<2, 0>(L);
    case 3: return (int)launch<3, 0>(L);
    case 4: return (int)launch<4, 0>(L);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One fused launch: `substeps` whole substeps of `iters` iterations each
// (iters * substeps <= kMaxPasses) for `n_batch` rollouts, from x_in, v_in
// into x_out, v_out; the planes and the row window as for
// pbd_cloth_substep.
int pbd_cloth_fused(const void* x_in, const void* v_in, void* x_out,
                    void* v_out, const void* w, long long w_bstride,
                    const void* icd, const void* icb, const void* params,
                    int n_batch, int height, int width, int iters,
                    int substeps, int row_offset, int global_height,
                    void* stream) {
  if (iters < 1 || substeps < 1) return (int)cudaErrorInvalidValue;
  Launch L{(const float*)x_in, (const float*)v_in, nullptr, nullptr,
           (float*)x_out, (float*)v_out, nullptr, (const float*)w,
           w_bstride, (const float*)icd, (const float*)icb, Params{},
           n_batch, height, width, row_offset, global_height, iters,
           substeps, (cudaStream_t)stream};
  std::memcpy(&L.P, params, sizeof(L.P));
  switch (iters * substeps) {
    case 1: return (int)launch<1, 1>(L);
    case 2: return (int)launch<2, 1>(L);
    case 3: return (int)launch<3, 1>(L);
    case 4: return (int)launch<4, 1>(L);
    case 5: return (int)launch<5, 1>(L);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pbd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
