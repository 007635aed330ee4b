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
// Fused mode (cloth_fused_kernel, the counterpart of the TPU kernel's
// fuse_substeps, grid_cloth_pallas.py:440; also the row-window mode's
// kernel): one cooperative, persistent launch runs `subs` whole substeps of
// `iters` iterations, iters * subs <= kMaxPasses passes. The TPU kernel
// widens each row block's halo by 3 rows a pass; here that window would
// solve 5.6 times its tile a pass at 5 passes (62 x 46 cells for a 32 x 16
// tile, one 576-thread block an SM), so the launch keeps the halo of one
// pass (the window of ITERS = 1: 38 x 22 cells, 864 threads, two blocks an
// SM) and puts a grid-wide barrier between the passes instead. Its grid is
// as many blocks as the card holds at once (at most one a (tile, rollout)
// item); each pass a block takes the items in grid stride and runs on each
// what a launch of one iteration runs (cloth_tile<1>), then the grid
// synchronises. The state of substep boundary s lives in the input (s = 0),
// in x_out/v_out where subs - s is even, else in a scratch state, so that
// the last substep writes the output; past one iteration the positions and
// lambdas between a substep's passes ping-pong between two scratch plane
// sets (lambda's with a row above and one below the planes' rows, whose
// anchors reach into a row window's first and last rows), and the last pass
// updates the velocity from the substep's start state, which no pass of the
// substep writes. No pass writes a buffer that another block reads in the
// same pass, and what one pass writes is read only after the barrier; the
// pass's buffers sit in a __shared__ table, read where each phase uses them,
// so that they hold no register through the solve and are read with plain
// loads (never the read-only path, which the barrier does not order). Every
// pass computes what a launch of the per-substep kernel computes, by the
// same code, so the two modes agree bit for bit. Rows outside [0, H) load as
// zeros of zero inverse mass on every pass, as in the row window's plain
// version.
#include <cuda_runtime.h>

#include <climits>
#include <cooperative_groups.h>
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
constexpr int kMaxPasses = 5;    // iterations x substeps one fused launch runs
constexpr int kMaxDevices = 64;
// cells a thread owns beyond ITERS. At one iteration one cell a thread
// (864 threads a 32x16 tile) took 14.1 us a launch at 320x320 against
// 15.2 us for two (448 threads) at one rollout, and 44.0-47.7 against
// 43.5 us at four (scripts/cloth_tile_sweep.py, an H100 SXM at 700 W)
constexpr int kExtraCells = 0;

// The window of a launch that runs ITERS iterations: the tile with a halo
// of R on every side, S cells, NC of them owned by each of its `threads`.
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

// The fused launch's window: one pass.
using FusedWindow = Window<1>;

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

// The fused launch's step: its input and output state, its scratch (planes
// like the state's; lambda as (B, 6, H + 2, W)) and its counts.
struct FusedPlan {
  const float* x_in;
  const float* v_in;
  float* x_out;
  float* v_out;
  float* xs;     // the state planes x_out alternates with (substeps > 1)
  float* vs;     // ... and v_out
  float* xp0;    // positions between a substep's passes (iterations > 1)
  float* xp1;    // (iterations > 2)
  float* lam0;   // lambda, likewise, (B, 6, H + 2, W): rows -1 .. H
  float* lam1;
  int n_batch;
  int substeps;
  int iterations;
};

// One pass's buffers in the fused mode, as a per-substep launch of one
// iteration takes them (cloth_tile), the base of rollout 0.
struct PassBuffers {
  const float* x_in;
  const float* v_in;
  const float* x_cur;
  const float* lam_in;
  float* x_out;
  float* v_out;
  float* lam_out;
};

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

// ITERS iterations of one substep on tile (bx, by) of rollout bz, by the
// whole block. x_in, v_in: the substep's input state. x_cur, lam_in: the
// positions and lambdas a previous launch of this substep left, or null in
// the first launch (integrate, lambda = 0). v_out null: not the last
// launch, so write the positions to x_out and the lambdas to lam_out; else
// finish the substep into x_out, v_out. In the fused mode (COOP) the
// buffers come from the pass table pb instead, read where each phase uses
// them. H rows of the grid are in the planes; row r of them is row
// r + row_offset of a grid of H_global rows.
template <int ITERS, int COOP>
__device__ __forceinline__ void cloth_tile(
    const float* x_in, const float* v_in, const float* x_cur,
    const float* lam_in, float* x_out, float* v_out, float* lam_out,
    const volatile PassBuffers* pb, const float* __restrict__ w_g,
    long long w_bstride, const float* __restrict__ icd_g,
    const float* __restrict__ icb_g, const Params& P, int H, int W,
    int row_offset, int H_global, int bx, int by, int bz) {
  using Wd = Window<ITERS>;
  constexpr int R = Wd::R, SX = Wd::SX, SY = Wd::SY, S = Wd::S, NC = Wd::NC;
  constexpr int NT = Wd::threads;
  extern __shared__ float smem[];
  float* sx[3] = {smem, smem + S, smem + 2 * S};
  float* sw = smem + 3 * S;
  float* scr = smem + 4 * S;       // 9 planes: family f, component q

  const long long plane = (long long)H * W;
  const long long boff = (long long)bz * 3 * plane;
  // lambda of the anchor at (gi, gj): lam_*[lbase + f * lplane + gi W + gj];
  // the fused mode's planes hold rows -1 .. H
  const long long lplane = COOP ? (long long)(H + 2) * W : plane;
  const long long lbase = (long long)bz * 6 * lplane + (COOP ? W : 0);
  if constexpr (COOP) {
    x_in = pb->x_in;
    v_in = pb->v_in;
    x_cur = pb->x_cur;
    lam_in = pb->lam_in;
  }
  const float* xb = x_in + boff;
  const float* vb = v_in + boff;
  const float* wb = w_g + (long long)bz * w_bstride;
  const int gi0 = by * TY - R;   // local grid row of shared row 0
  const int gj0 = bx * TX - R;
  const int t = threadIdx.x;
  const float h = P.h;
  // the owned cells' lambdas (h v d bh bv bd) and Jacobi weights
  float lam[NC][6], icd[NC], icb[NC];

  // ---- load the tile + halo; in the first launch of a substep,
  //      integrate (TimeIntegration.cpp:7-19) ----
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = t + k * NT;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, w = 0.f, cd = 0.f, cb = 0.f;
#pragma unroll
    for (int f = 0; f < 6; ++f) lam[k][f] = 0.f;
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
            lam[k][f] = lam_in[lbase + f * lplane + g];
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
      } else if (COOP && x_cur != nullptr && (gi == -1 || gi == H) &&
                 gj >= 0 && gj < W) {
        // a row window's anchors just beyond its rows reach into them
#pragma unroll
        for (int f = 0; f < 6; ++f)
          lam[k][f] = lam_in[lbase + f * lplane + (long long)gi * W + gj];
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
  for (int it = 0; it < ITERS; ++it) {
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

  // ---- tile interior: in the last launch of a substep, the first-order
  //      velocity update (TimeIntegration.cpp:42-51) and damping; the
  //      write-back, each owned cell by its thread ----
  if constexpr (COOP) {
    x_out = pb->x_out;
    v_out = pb->v_out;
    lam_out = pb->lam_out;
    xb = pb->x_in + boff;
    vb = pb->v_in + boff;
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = t + k * NT;
    if (c >= S) continue;
    const int ly = c / SX, lx = c - ly * SX;
    const int gi = gi0 + ly, gj = gj0 + lx;
    if constexpr (COOP) {
      // the lambdas of the row above the planes (by the first row of
      // tiles) and of the row below them (by the last), between passes
      if (lam_out != nullptr && lx >= R && lx < R + TX && gj < W &&
          (gi == -1 || (gi == H && ly <= R + TY))) {
#pragma unroll
        for (int f = 0; f < 6; ++f)
          lam_out[lbase + f * lplane + (long long)gi * W + gj] = lam[k][f];
        continue;
      }
    }
    if (ly < R || ly >= R + TY || lx < R || lx >= R + TX || gi >= H ||
        gj >= W)
      continue;
    const long long g = (long long)gi * W + gj;
    const float w = sw[c];
    float* xo = x_out + boff;
#pragma unroll
    for (int q = 0; q < 3; ++q) xo[q * plane + g] = sx[q][c];
    if (v_out != nullptr) {
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
      for (int f = 0; f < 6; ++f) lam_out[lbase + f * lplane + g] = lam[k][f];
    }
  }
}  // cloth_tile

// One launch of ITERS iterations of a substep: block (x, y, z) runs tile
// (x, y) of rollout z (cloth_tile).
template <int ITERS>
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
                     int W, int row_offset, int H_global) {
  cloth_tile<ITERS, 0>(x_in, v_in, x_cur, lam_in, x_out, v_out, lam_out,
                       nullptr, w_g, w_bstride, icd_g, icb_g, P, H, W,
                       row_offset, H_global, blockIdx.x, blockIdx.y,
                       blockIdx.z);
}

// The fused mode: F.substeps x F.iterations passes of F.n_batch rollouts in
// one cooperative launch (see the top of the file).
__global__ void __launch_bounds__(FusedWindow::threads,
                                  FusedWindow::min_blocks)
cloth_fused_kernel(const float* __restrict__ w_g, long long w_bstride,
                   const float* __restrict__ icd_g,
                   const float* __restrict__ icb_g, const Params P,
                   const FusedPlan F, int H, int W, int row_offset,
                   int H_global) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ PassBuffers pass;
  const int nbx = (W + TX - 1) / TX;
  const int tiles = nbx * ((H + TY - 1) / TY);
  const int items = tiles * F.n_batch;
  const int passes = F.substeps * F.iterations;
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    if (threadIdx.x == 0) {
      const int s = p / F.iterations, it = p - s * F.iterations;
      const bool first = it == 0, last = it == F.iterations - 1;
      // substep s reads the state of boundary s and its last pass writes
      // that of s + 1: the input at s = 0, x_out/v_out where subs - s is
      // even, else the scratch state
      const bool at_out = ((F.substeps - s) & 1) == 0;
      pass.x_in = s == 0 ? F.x_in : at_out ? F.x_out : F.xs;
      pass.v_in = s == 0 ? F.v_in : at_out ? F.v_out : F.vs;
      // between a substep's passes: read what the pass before wrote, write
      // the other set
      pass.x_cur = first ? nullptr : ((it - 1) & 1) ? F.xp1 : F.xp0;
      pass.lam_in = first ? nullptr : ((it - 1) & 1) ? F.lam1 : F.lam0;
      pass.x_out = !last ? ((it & 1) ? F.xp1 : F.xp0)
                         : at_out ? F.xs : F.x_out;
      pass.v_out = !last ? nullptr : at_out ? F.vs : F.v_out;
      pass.lam_out = last ? nullptr : (it & 1) ? F.lam1 : F.lam0;
    }
    __syncthreads();
#pragma unroll 1
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      // the item before may still read the block's shared memory
      if (item != (int)blockIdx.x) __syncthreads();
      const int r = item % tiles;
      cloth_tile<1, 1>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, &pass, w_g, w_bstride, icd_g, icb_g, P, H, W,
                       row_offset, H_global, r % nbx, r / nbx, item / tiles);
    }
    if (p + 1 < passes) grid.sync();
  }
}  // cloth_fused_kernel

// Opt in to a kernel's dynamic shared memory once per device (`done`, one
// flag a device for that kernel): the attribute holds for every later
// launch there.
cudaError_t allow_smem(const void* kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

template <int ITERS>
cudaError_t allow_substep_smem() {
  static bool done[kMaxDevices] = {};
  return allow_smem((const void*)cloth_substep_kernel<ITERS>,
                    Window<ITERS>::smem, done);
}

cudaError_t allow_fused_smem() {
  static bool done[kMaxDevices] = {};
  return allow_smem((const void*)cloth_fused_kernel, FusedWindow::smem, done);
}

// The arguments of one per-substep launch.
struct Launch {
  const float *x_in, *v_in, *x_cur, *lam_in;
  float *x_out, *v_out, *lam_out;
  const float* w;
  long long w_bstride;
  const float *icd, *icb;
  Params P;
  int n_batch, H, W, row_offset, H_global;
  cudaStream_t stream;
};

template <int ITERS>
cudaError_t launch(const Launch& L) {
  const cudaError_t e = allow_substep_smem<ITERS>();
  if (e != cudaSuccess) return e;
  const dim3 grid((L.W + TX - 1) / TX, (L.H + TY - 1) / TY, L.n_batch);
  cloth_substep_kernel<ITERS>
      <<<grid, Window<ITERS>::threads, Window<ITERS>::smem, L.stream>>>(
          L.x_in, L.v_in, L.x_cur, L.lam_in, L.x_out, L.v_out, L.lam_out,
          L.w, L.w_bstride, L.icd, L.icb, L.P, L.H, L.W, L.row_offset,
          L.H_global);
  return cudaGetLastError();
}

// The resources of `kernel` launched with `threads` a block and `smem`
// dynamic shared bytes, as pbd_cloth_kernel_resources reports them.
cudaError_t resources(const void* kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = (int)at.localSizeBytes;
  out[4] = blocks;
  out[5] = threads;
  return cudaSuccess;
}

template <int ITERS>
cudaError_t substep_resources(int* out) {
  const cudaError_t err = allow_substep_smem<ITERS>();
  if (err != cudaSuccess) return err;
  return resources((const void*)cloth_substep_kernel<ITERS>,
                   Window<ITERS>::threads, Window<ITERS>::smem, out);
}

// Blocks of the fused kernel resident on the current card at once (its
// grid's largest size): out = blocks an SM x SMs. Returns
// cudaErrorNotSupported on a card without cooperative launch.
cudaError_t fused_capacity(int* out) {
  static int cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = allow_fused_smem();
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cloth_fused_kernel, FusedWindow::threads, FusedWindow::smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap[dev] = per_sm * sms;
  }
  *out = cap[dev];
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
    case 1: return (int)substep_resources<1>(out);
    case 2: return (int)substep_resources<2>(out);
    case 3: return (int)substep_resources<3>(out);
    case 4: return (int)substep_resources<4>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same for the fused kernel.
int pbd_cloth_fused_resources(int* out) {
  if (!out) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_fused_smem();
  if (err != cudaSuccess) return (int)err;
  return (int)resources((const void*)cloth_fused_kernel,
                        FusedWindow::threads, FusedWindow::smem, out);
}

// The fused launch's largest grid on the current card (blocks an SM x
// SMs). Returns a CUDA error code, cudaErrorNotSupported on a card without
// cooperative launch.
int pbd_cloth_fused_capacity(int* out) {
  if (!out) return (int)cudaErrorInvalidValue;
  return (int)fused_capacity(out);
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
           global_height, (cudaStream_t)stream};
  std::memcpy(&L.P, params, sizeof(L.P));
  switch (iters) {
    case 1: return (int)launch<1>(L);
    case 2: return (int)launch<2>(L);
    case 3: return (int)launch<3>(L);
    case 4: return (int)launch<4>(L);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One fused launch: `substeps` whole substeps of `iters` iterations each
// (iters * substeps <= kMaxPasses) for `n_batch` rollouts, from x_in, v_in
// into x_out, v_out, in one cooperative launch; the planes and the row
// window as for pbd_cloth_substep. Scratch of the caller, left undefined:
// xs and vs (planes like x_in) unless substeps is 1, xp0 (likewise) and
// lam0 ((n_batch, 6, H + 2, W)) unless iters is 1, xp1 and lam1 past two
// iterations; every buffer distinct from every other. Writes the launch's
// grid size to *grid_size when it is not null. Returns a CUDA error code,
// 0 when the launch was queued; cudaErrorNotSupported on a card without
// cooperative launch.
int pbd_cloth_fused(const void* x_in, const void* v_in, void* x_out,
                    void* v_out, void* xs, void* vs, void* xp0, void* xp1,
                    void* lam0, void* lam1, const void* w,
                    long long w_bstride, const void* icd, const void* icb,
                    const void* params, int n_batch, int height, int width,
                    int iters, int substeps, int row_offset,
                    int global_height, int* grid_size, void* stream) {
  if (iters < 1 || substeps < 1 || iters * substeps > kMaxPasses ||
      n_batch < 1 || height < 1 || width < 1 || x_in == nullptr ||
      v_in == nullptr || x_out == nullptr || v_out == nullptr ||
      (substeps > 1 && (xs == nullptr || vs == nullptr)) ||
      (iters > 1 && (xp0 == nullptr || lam0 == nullptr)) ||
      (iters > 2 && (xp1 == nullptr || lam1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((width + TX - 1) / TX) * ((height + TY - 1) / TY);
  if (tiles * n_batch > INT_MAX) return (int)cudaErrorInvalidValue;
  const void* bufs[] = {x_in, v_in, x_out, v_out, xs, vs, xp0, xp1, lam0,
                        lam1};
  for (int i = 0; i < 10; ++i)
    for (int j = i + 1; j < 10; ++j)
      if (bufs[i] != nullptr && bufs[i] == bufs[j])
        return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t e = fused_capacity(&cap);
  if (e != cudaSuccess) return (int)e;
  const int items = (int)(tiles * n_batch);
  const int blocks = items < cap ? items : cap;
  if (grid_size != nullptr) *grid_size = blocks;
  Params P;
  std::memcpy(&P, params, sizeof(P));
  FusedPlan F{(const float*)x_in, (const float*)v_in, (float*)x_out,
              (float*)v_out,      (float*)xs,         (float*)vs,
              (float*)xp0,        (float*)xp1,        (float*)lam0,
              (float*)lam1,       n_batch,            substeps,
              iters};
  const float* a_w = (const float*)w;
  const float* a_icd = (const float*)icd;
  const float* a_icb = (const float*)icb;
  void* args[] = {&a_w,    &w_bstride, &a_icd,       &a_icb,
                  &P,      &F,         &height,      &width,
                  &row_offset, &global_height};
  e = cudaLaunchCooperativeKernel((const void*)cloth_fused_kernel,
                                  dim3(blocks), dim3(FusedWindow::threads),
                                  args, FusedWindow::smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* pbd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
