// Fused XPBD FEM-tet substep on a regular W x H x D tet grid, for Hopper.
//
// Replaces the TPU kernel `kernel` of
// positionbaseddynamics_tpu/solver/grid_tet_pallas.py::make_pallas_tet_step
// (body :99-302, pallas_call :309). One substep: semi-implicit Euler under
// gravity (pinned vertices, w = 0, frozen), then `max_iterations` Jacobi
// passes over the 5 tet families of every hex cell (F = Ds Dm^-1, Green
// strain, St. Venant-Kirchhoff stress and energy, C = sqrt(2 V0 psi), the
// XPBD delta-lambda; XPBD.cpp:217-294), each vertex averaging its
// corrections by its tet count, then the first-order velocity update and
// the optional damping. Lambda starts at 0 every substep and is carried
// across the iterations of one substep. The arithmetic follows the plain
// PyTorch version, GridTetBatch.project (grid_tet.py), term by term.
//
// What bounds it: per substep the function reads 6 state planes, w and
// inv_cnt, and writes 6 state planes (14 x 4 B a vertex: 5.8 MB at
// 80 x 36 x 36), and does ~300 fp32 operations per tet and iteration
// (1.5e8 at 483,875 tets). At 3.35 TB/s and 67 TFLOP/s the arithmetic is
// the larger of the two, ~2.3 us a substep.
//
// Design: one launch per Jacobi iteration, in which a block owns a box of
// TI x TJ x TK vertices and fuses the cell solve with the vertex update:
//  1. it stages the positions, inverse masses and Jacobi weights of the box
//     and of a one-vertex halo on every side in shared memory; in a
//     substep's first iteration it integrates each staged vertex once,
//     x + h (v + h g), with explicitly rounded operations, so that every
//     block that stages a vertex gets the same bits;
//  2. it solves every cell of the grid with a corner in the box, at most
//     (TI+1)(TJ+1)(TK+1) cells, one a thread (the halo cells are solved
//     again by each block that needs them, not exchanged). The 5 families
//     run in order t = 0..4; each tet reads its 4 corners from shared
//     memory and adds its corrections into the cell's 8 x 3 sums, which
//     live in the cell's slots of a shared scratch (no other thread touches
//     them), so that no sum holds a register through the solve;
//  3. after one barrier each box vertex adds the sums of the up to 8 cells
//     it is a corner of, in corner order 0..7 (corner q of the cell at
//     vertex - corner q's offset): the plain version's summation order (per
//     corner the families ascending, then the corners 0..7), so the kernel
//     is deterministic and differs from the plain version only where the
//     compiler contracts the solve's products into FMAs. It then writes
//     x + inv_cnt dx and, in a substep's last iteration, its velocity, to
//     buffers distinct from the inputs, since neighbouring blocks read this
//     block's vertices as their halo.
// A block takes only the cells that lie in the grid (a box at the grid's
// edge has fewer), and numbers those of each parity class on their own
// (class_cell); the first warps take the even cells and the others the odd
// ones, so every warp holds cells of one parity and runs one of the two
// 5-tet paths, and no lane waits on a cell outside the grid. At more than
// one iteration lambda lives in (5, cells) global planes: a launch reads
// the plane that the launch before it wrote and writes the other one, for
// the cells its box owns only, because a halo cell that one block reads
// another block also solves.
//
// What the measurements say (an H100 SXM at 700 W, scripts/tet_tile_sweep.py
// and scripts/tet_phase_probe.py): the solve sets the pace, not the memory
// traffic, and the work to solve grows with the halo cells (1.41 times the
// grid's cells at the bar for a 12 x 6 x 6 box). The box is chosen so that
// all of the bar's blocks are resident at once (252 blocks at 2 an SM):
// a box whose blocks need a second round on the SMs loses more than a
// smaller halo wins.
//
// The multi-substep mode (tet_substep_kernel<1>, the counterpart of the TPU
// kernel's one pass a step, grid_tet_pallas.py:12-15): one cooperative,
// persistent launch runs a whole step, substeps x max_iterations passes.
// The TPU kernel widens each row block's halo by a row a pass; here a box
// would have to widen its halo in all three directions (22 x 16 x 16
// staged vertices for 432 owned at 5 passes), so the launch keeps the
// one-vertex halo and puts a grid-wide barrier between the passes instead.
// Its grid is as many blocks as the card holds at once (at most one a
// (box, rollout) item); each pass a block takes the items in grid stride
// and runs the three phases above on each, then the grid synchronises.
// The positions ping-pong between x_out and a scratch plane set, chosen so
// that the last pass writes x_out; the velocities likewise between v_out
// and a scratch, one swap a substep; at more than one iteration the first
// pass of a substep keeps the box's start positions in a third plane set
// for the last pass's velocity update, and lambda ping-pongs as above. No
// pass writes a buffer that another block reads in the same pass, and what
// one pass writes is read only after the barrier; buffers that the launch
// writes are read with plain loads (never the read-only path), which the
// barrier orders. Every pass computes what a launch of the per-iteration
// mode computes, by the same code, so the two modes agree bit for bit.
#include <climits>
#include <cstring>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int N_PARAMS = 112;
// The box of vertices a block owns, along i, j and k (the sweep's choice at
// the bar; any grid takes any box).
constexpr int TI = 12;
constexpr int TJ = 6;
constexpr int TK = 6;
// cells a thread solves
constexpr int kCellsPerThread = 1;
// resident blocks an SM the registers are held to allow
constexpr int kMinBlocks = 2;
constexpr int kMaxDevices = 64;

struct Tile {
  // staged vertices: the box with a one-vertex halo
  static constexpr int SI = TI + 2, SJ = TJ + 2, SK = TK + 2;
  static constexpr int S = SI * SJ * SK;
  // cells with a corner in the box, numbered (a CJ + b) CK + c
  static constexpr int CI = TI + 1, CJ = TJ + 1, CK = TK + 1;
  static constexpr int C = CI * CJ * CK;
  static constexpr int O = TI * TJ * TK;  // box vertices
  static constexpr int NC = kCellsPerThread;
  // warps for the even and the odd cells of a box inside the grid
  static constexpr int W_EVEN = ((C + 1) / 2 + 32 * NC - 1) / (32 * NC);
  static constexpr int W_ODD = (C / 2 + 32 * NC - 1) / (32 * NC);
  static constexpr int threads = 32 * (W_EVEN + W_ODD);
  static constexpr int NS = (S + threads - 1) / threads;  // staged a thread
  // shared floats: staged x (3 S), w (S) and inv_cnt (S); the input
  // positions of the box (3 O); the cells' corner sums (24 C)
  static constexpr size_t smem = sizeof(float) * (5 * S + 3 * O + 24 * C);
};
static_assert(Tile::threads <= 1024, "too many threads for one block");

// Host-side scalars, laid out as the float vector the Python wrapper builds
// (grid_tet_cuda.kernel_params), each computed in float32 in the order the
// plain version computes it.
struct TetParams {
  float irm[2][5][9];  // inverse rest matrices [0 even, 1 odd][family][3x3]
  float vol[2][5];     // rest volumes
  float mu;            // Lame parameters per unit Young's modulus
  float lame;
  float two_mu;        // 2 mu
  float half_lame;     // lame / 2
  float alpha;         // XPBD compliance 1/(E h^2), 0 where E h^2 = 0
  float active;        // 1 where E > 0; E = 0 disables the solve
  float h;             // substep length
  float g[3];          // gravity
  float damp;          // velocity factor 1 - damping
  float use_damp;      // 1 when damping != 0
};
static_assert(sizeof(TetParams) == N_PARAMS * sizeof(float), "param layout");

// The multi-substep mode's step: its scratch planes (same layout as the
// state planes; lambda as (n_batch, 5, cells)) and its counts. Unused by the
// per-iteration mode.
struct FusedPlan {
  float* xs;      // positions, the planes x_out alternates with
  float* vs;      // velocities, the planes v_out alternates with
  float* x0;      // a substep's start positions (more than one iteration)
  float* lam0;    // lambda ping-pong
  float* lam1;    // (more than two iterations)
  int n_batch;
  int substeps;
  int iterations;
};

// One pass's buffers in the multi-substep mode, the base of rollout 0,
// kept in shared memory for the pass and read at each phase where they are
// used, so that they hold no register through the solve.
struct PassBuffers {
  const float* x_in;
  const float* v_in;
  const float* x_cur;
  const float* lam_in;
  float* lam_out;
  float* x_out;
  float* v_out;
  float* x0_out;
};

// Corner c of a cell sits at (i + a, j + b, k + c) (grid_tet._CORNERS).
__host__ __device__ constexpr int corner_a(int c) {
  return (c == 2 || c == 3 || c == 6 || c == 7) ? 1 : 0;
}
__host__ __device__ constexpr int corner_b(int c) { return c >= 4 ? 1 : 0; }
__host__ __device__ constexpr int corner_c(int c) {
  return (c == 1 || c == 2 || c == 5 || c == 6) ? 1 : 0;
}
// Offset of corner c from corner 0 in the staged vertices, and of the cell
// whose corner c a vertex is from the cell whose corner 0 it is.
__host__ __device__ constexpr int stage_off(int c) {
  return (corner_a(c) * Tile::SJ + corner_b(c)) * Tile::SK + corner_c(c);
}
__host__ __device__ constexpr int cell_off(int c) {
  return (corner_a(c) * Tile::CJ + corner_b(c)) * Tile::CK + corner_c(c);
}

// Cell m of parity class p (a + b + c = p mod 2) of a box of ni x nj x nk
// cells: the cells of a class have one m each, 0 <= m < (ni nj nk + 1 - p) / 2.
__device__ __forceinline__ void class_cell(int m, int p, int nj, int nk,
                                           int& a, int& b, int& c) {
  if ((nk & 1) == 0) {
    // each row holds nk / 2 cells of a class
    const int half = nk >> 1;
    const int r = m / half;
    a = r / nj;
    b = r - a * nj;
    c = 2 * (m - r * half) + ((p + a + b) & 1);
  } else if ((nj & 1) == 0) {
    // each pair of rows holds nk cells of a class, the first row those
    // whose c has the parity of p + a
    const int plane = (nj * nk) >> 1;
    a = m / plane;
    const int r = m - a * plane;
    const int pair = r / nk, u = r - pair * nk;
    const int s = (p + a) & 1;
    const int first = (nk + 1 - s) >> 1;
    if (u < first) {
      b = 2 * pair;
      c = 2 * u + s;
    } else {
      b = 2 * pair + 1;
      c = 2 * (u - first) + 1 - s;
    }
  } else {
    // nj, nk odd: (a nj + b) nk + c has the parity of a + b + c
    const int q = 2 * m + p;
    const int plane = nj * nk;
    a = q / plane;
    const int r = q - a * plane;
    b = r / nk;
    c = r - b * nk;
  }
}

// A staged vertex's position in a substep's first iteration: the input
// integrated (TimeIntegration.cpp:7-19: v += g h; x += v h where w > 0),
// rounded operation by operation.
__device__ __forceinline__ float integrate(float x, float v, float w,
                                           float g, float h) {
  return w > 0.f ? __fadd_rn(x, __fmul_rn(__fadd_rn(v, __fmul_rn(g, h)), h))
                 : x;
}

// A cell's 8 x 3 correction sums, in its slots of the shared scratch C
// floats apart: corner q component e at (3 q + e) C. No other thread
// touches them before the barrier that ends the solve.
struct Sums {
  float* p;
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < 24; ++k) p[k * Tile::C] = 0.f;
  }
  __device__ __forceinline__ void add(int q, int e, float x) {
    p[(3 * q + e) * Tile::C] = p[(3 * q + e) * Tile::C] + x;
  }
};

// A cell's slot in the scratch planes: the cells (a CJ + b) CK + c of even
// number first, then the odd ones, so that the cells of one parity class,
// which a warp holds, lie next to each other where CJ and CK are odd.
__host__ __device__ constexpr int scratch_slot(int cell) {
  return (cell >> 1) + (cell & 1) * ((Tile::C + 1) / 2);
}

// One tet of family T in a cell of parity ODD, corners C0..C3
// (grid_tet._TETS_ODD / _TETS_EVEN), whose corner 0 is staged vertex s; adds
// its corrections into the cell's sums. The corners are read from shared
// memory through volatile pointers, so that each tet loads its own 4 and no
// copy of the cell's 8 stays live in registers.
template <int ODD, int T, int C0, int C1, int C2, int C3>
__device__ __forceinline__ void solve_tet(const volatile float* sx,
                                          const volatile float* sw, int s,
                                          Sums& acc,
                                          const TetParams& P,
                                          const float* __restrict__ lam_in,
                                          float* __restrict__ lam_out,
                                          int cell, int n_cells) {
  const float* irm = P.irm[ODD][T];
  const float vol = P.vol[ODD][T];
  constexpr int o0 = stage_off(C0), o1 = stage_off(C1), o2 = stage_off(C2),
                o3 = stage_off(C3);
  // edge vectors d_i = p_i - p_3: ds[a][i]
  float ds[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const volatile float* xa = sx + a * Tile::S + s;
    const float p3 = xa[o3];
    ds[a][0] = xa[o0] - p3;
    ds[a][1] = xa[o1] - p3;
    ds[a][2] = xa[o2] - p3;
  }
  // F = Ds Dm^-1
  float f[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      f[a][b] = ds[a][0] * irm[b] + ds[a][1] * irm[3 + b] +
                ds[a][2] * irm[6 + b];
  // Green strain e = (F^T F - I) / 2, symmetric
  float e[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      const float ftf = f[0][a] * f[0][b] + f[1][a] * f[1][b] +
                        f[2][a] * f[2][b];
      e[a][b] = a == b ? 0.5f * (ftf - 1.f) : 0.5f * ftf;
      e[b][a] = e[a][b];
    }
  const float tr = e[0][0] + e[1][1] + e[2][2];
  const float ltr = P.lame * tr;
  float sm[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      sm[a][b] = a == b ? P.two_mu * e[a][b] + ltr : P.two_mu * e[a][b];
  // first Piola stress sigma = F (2 mu e + lame tr(e) I)
  float sig[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      sig[a][b] = f[a][0] * sm[0][b] + f[a][1] * sm[1][b] + f[a][2] * sm[2][b];
  float ee = e[0][0] * e[0][0];
#pragma unroll
  for (int q = 1; q < 9; ++q) ee = ee + e[q / 3][q % 3] * e[q / 3][q % 3];
  const float psi = P.mu * ee + P.half_lame * tr * tr;
  const float u = vol * psi;
  // grad_j = V0 (sigma Dm^-T) column j, grad_3 = -(grad_0 + grad_1 + grad_2)
  float g[4][3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      g[j][a] = vol * (sig[a][0] * irm[3 * j] + sig[a][1] * irm[3 * j + 1] +
                       sig[a][2] * irm[3 * j + 2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) g[3][a] = -(g[0][a] + g[1][a] + g[2][a]);

  const float w0 = sw[s + o0], w1 = sw[s + o1], w2 = sw[s + o2],
              w3 = sw[s + o3];
  const float c = sqrtf(fmaxf(2.f * u, 0.f));
  float sn = w0 * (g[0][0] * g[0][0] + g[0][1] * g[0][1] + g[0][2] * g[0][2]);
  sn = sn + w1 * (g[1][0] * g[1][0] + g[1][1] * g[1][1] + g[1][2] * g[1][2]);
  sn = sn + w2 * (g[2][0] * g[2][0] + g[2][1] * g[2][1] + g[2][2] * g[2][2]);
  sn = sn + w3 * (g[3][0] * g[3][0] + g[3][1] * g[3][1] + g[3][2] * g[3][2]);
  sn = sn + c * c * P.alpha;
  const float l = lam_in == nullptr ? 0.f : lam_in[T * n_cells + cell];
  const bool valid = sn >= 1e-6f && P.active != 0.f;
  const float inv_sn = fabsf(sn) > 1e-30f ? __frcp_rn(sn) : 0.f;
  const float dl = valid ? (-c * (c + P.alpha * l)) * inv_sn : 0.f;
  if (lam_out != nullptr) lam_out[T * n_cells + cell] = l + dl;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    acc.add(C0, a, (dl * w0) * g[0][a]);
    acc.add(C1, a, (dl * w1) * g[1][a]);
    acc.add(C2, a, (dl * w2) * g[2][a]);
    acc.add(C3, a, (dl * w3) * g[3][a]);
  }
}

// The 5 families of one cell of parity ODD, in order t = 0..4.
template <int ODD>
__device__ __forceinline__ void solve_cell(const volatile float* sx,
                                           const volatile float* sw, int s,
                                           Sums& acc,
                                           const TetParams& P,
                                           const float* __restrict__ lam_in,
                                           float* __restrict__ lam_out,
                                           int cell, int n_cells) {
  if (ODD) {
    solve_tet<1, 0, 2, 1, 6, 3>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<1, 1, 6, 3, 4, 7>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<1, 2, 4, 1, 6, 5>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<1, 3, 3, 1, 4, 0>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<1, 4, 6, 1, 4, 3>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
  } else {
    solve_tet<0, 0, 0, 2, 5, 1>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<0, 1, 7, 2, 0, 3>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<0, 2, 5, 2, 7, 6>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<0, 3, 7, 0, 5, 4>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
    solve_tet<0, 4, 0, 2, 7, 5>(sx, sw, s, acc, P, lam_in, lam_out, cell, n_cells);
  }
}

// One Jacobi iteration of a substep for box `box` (boxes numbered with k
// fastest) of rollout `rollout`, by the whole block. x_cur is null in a
// substep's first iteration (integrate); lam_in is null in the first
// iteration (lambda 0) and lam_out in the last; v_out is set in the last
// iteration only. In the multi-substep mode (FUSED) the buffers come from
// pb instead, x0_out among them: set in the first iteration of a substep
// of more than one, the box's start positions go there, for x_in of the
// substep's last iteration.
template <int FUSED>
__device__ __forceinline__ void tet_box(const float* __restrict__ x_in,
                                        const float* __restrict__ v_in,
                                        const float* __restrict__ x_cur,
                                        const float* __restrict__ w_g,
                                        const float* __restrict__ ic_g,
                                        const float* __restrict__ lam_in,
                                        float* __restrict__ lam_out,
                                        float* __restrict__ x_out,
                                        float* __restrict__ v_out,
                                        float* __restrict__ x0_out,
                                        const volatile PassBuffers* pb,
                                        const TetParams& P, int W, int H,
                                        int D, int w_bstride, unsigned box,
                                        unsigned rollout) {
  extern __shared__ float smem[];
  float* sx = smem;                       // [3][S]
  float* sw = sx + 3 * Tile::S;           // [S]
  float* sic = sw + Tile::S;              // [S]
  float* sx0 = sic + Tile::S;             // [3][O], the last iteration only
  float* sc = sx0 + 3 * Tile::O;          // [24][C], the cells' sums
  const int t = threadIdx.x;
  const int nbk = (D + TK - 1) / TK, nbj = (H + TJ - 1) / TJ;
  const int bk = box % nbk;
  const int br = box / nbk;
  const int i0 = br / nbj * TI, j0 = br % nbj * TJ, k0 = bk * TK;
  const int n = W * H * D;
  // the rollout's own state and lambda planes; w is shared when w_bstride
  // is 0
  {
    const long long b = rollout;
    const long long xo = b * 3 * n;
    const long long lo = b * 5 * (long long)(W - 1) * (H - 1) * (D - 1);
    if constexpr (FUSED) {
      x_in = pb->x_in;
      v_in = pb->v_in;
      x_cur = pb->x_cur;
      v_out = pb->v_out;          // whether this is a last iteration
      x0_out = pb->x0_out;
      if (x0_out != nullptr) x0_out += xo;
    }
    x_in += xo;
    v_in += xo;
    if (x_cur != nullptr) x_cur += xo;
    if constexpr (!FUSED) {
      x_out += xo;
      if (v_out != nullptr) v_out += xo;
      if (lam_in != nullptr) lam_in += lo;
      if (lam_out != nullptr) lam_out += lo;
    }
    w_g += b * w_bstride;
  }

  // ---- 1. stage the box and its halo, integrating in the first iteration;
  //      a thread issues every load of its staged vertices before it uses
  //      any, so that their latencies overlap
  float rx[Tile::NS][3], rv[Tile::NS][3], r0[Tile::NS][3], rw[Tile::NS],
      ric[Tile::NS];
  int ro[Tile::NS];   // box index of a staged box vertex, else -1
#pragma unroll
  for (int u = 0; u < Tile::NS; ++u) {
    const int s = t + u * Tile::threads;
    const int si = s / (Tile::SJ * Tile::SK);
    const int sr = s - si * (Tile::SJ * Tile::SK);
    const int sj = sr / Tile::SK, sk = sr - sj * Tile::SK;
    const int gi = i0 - 1 + si, gj = j0 - 1 + sj, gk = k0 - 1 + sk;
    rw[u] = ric[u] = 0.f;
    ro[u] = -1;
#pragma unroll
    for (int a = 0; a < 3; ++a) rx[u][a] = rv[u][a] = r0[u][a] = 0.f;
    if (s < Tile::S && gi >= 0 && gi < W && gj >= 0 && gj < H && gk >= 0 &&
        gk < D) {
      const int vi = (gi * H + gj) * D + gk;
      rw[u] = w_g[vi];
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
      if (v_out != nullptr && si >= 1 && si <= TI && sj >= 1 && sj <= TJ &&
          sk >= 1 && sk <= TK) {
        ro[u] = ((si - 1) * TJ + (sj - 1)) * TK + (sk - 1);
#pragma unroll
        for (int a = 0; a < 3; ++a) r0[u][a] = x_in[a * n + vi];
      }
      if constexpr (FUSED) {
        if (x0_out != nullptr && si >= 1 && si <= TI && sj >= 1 &&
            sj <= TJ && sk >= 1 && sk <= TK) {
#pragma unroll
          for (int a = 0; a < 3; ++a) x0_out[a * n + vi] = rx[u][a];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < Tile::NS; ++u) {
    const int s = t + u * Tile::threads;
    if (s >= Tile::S) continue;
    sw[s] = rw[u];
    sic[s] = ric[u];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sx[a * Tile::S + s] = x_cur != nullptr
                                ? rx[u][a]
                                : integrate(rx[u][a], rv[u][a], rw[u],
                                            P.g[a], P.h);
      if (ro[u] >= 0) sx0[a * Tile::O + ro[u]] = r0[u][a];
    }
  }
  __syncthreads();

  // ---- 2. solve the box's cells inside the grid, (a, b, c) from
  //      (a_lo, b_lo, c_lo), ni x nj x nk of them; a warp's cells are of
  //      one parity class p
  const int a_lo = i0 == 0 ? 1 : 0, b_lo = j0 == 0 ? 1 : 0,
            c_lo = k0 == 0 ? 1 : 0;
  const int ni = min(Tile::CI, W - i0) - a_lo;
  const int nj = min(Tile::CJ, H - j0) - b_lo;
  const int nk = min(Tile::CK, D - k0) - c_lo;
  const int n_even = (ni * nj * nk + 1) / 2, n_odd = (ni * nj * nk) / 2;
  const int w_even = (n_even + 32 * Tile::NC - 1) / (32 * Tile::NC);
  const int p = t >= 32 * w_even ? 1 : 0;
  const int m0 = p ? t - 32 * w_even : t;
  const int stride =
      p ? 32 * ((n_odd + 32 * Tile::NC - 1) / (32 * Tile::NC)) : 32 * w_even;
  // the threads past the class's warps take no cell
  const int n_class = m0 >= stride ? 0 : p ? n_odd : n_even;
  // a cell's parity is (i0 - 1 + a) + (j0 - 1 + b) + (k0 - 1 + c)
  const bool odd = ((i0 + j0 + k0 + 1 + a_lo + b_lo + c_lo + p) & 1) != 0;
  const int wc = W - 1, hc = H - 1, dc = D - 1;
  const int n_cells = wc * hc * dc;
  const volatile float* vx = sx;
  const volatile float* vw = sw;
  if constexpr (FUSED) {
    const long long lo = (long long)rollout * 5 * n_cells;
    lam_in = pb->lam_in;
    lam_out = pb->lam_out;
    if (lam_in != nullptr) lam_in += lo;
    if (lam_out != nullptr) lam_out += lo;
  }
#pragma unroll
  for (int k = 0; k < Tile::NC; ++k) {
    const int m = m0 + k * stride;
    if (m >= n_class) continue;
    int a, b, c;
    class_cell(m, p, nj, nk, a, b, c);
    a += a_lo;
    b += b_lo;
    c += c_lo;
    const int cell = ((i0 - 1 + a) * hc + (j0 - 1 + b)) * dc + (k0 - 1 + c);
    const int s = (a * Tile::SJ + b) * Tile::SK + c;
    // the box owns the cells whose corner 0 is a box vertex
    float* lo = (a > 0 && b > 0 && c > 0) ? lam_out : nullptr;
    Sums acc{sc + scratch_slot((a * Tile::CJ + b) * Tile::CK + c)};
    acc.zero();
    if (odd)
      solve_cell<1>(vx, vw, s, acc, P, lam_in, lo, cell, n_cells);
    else
      solve_cell<0>(vx, vw, s, acc, P, lam_in, lo, cell, n_cells);
  }
  __syncthreads();

  // ---- 3. the box's vertices: gather corner by corner, apply inv_cnt; in
  //      the last iteration the first-order velocity update
  //      (TimeIntegration.cpp:42-51) and damping
  if constexpr (FUSED) {
    const long long xo = (long long)rollout * 3 * n;
    x_out = pb->x_out + xo;
    v_out = pb->v_out;
    if (v_out != nullptr) v_out += xo;
    v_in = pb->v_in + xo;
  }
  for (int o = t; o < Tile::O; o += Tile::threads) {
    const int oi = o / (TJ * TK);
    const int orr = o - oi * (TJ * TK);
    const int oj = orr / TK, ok = orr - oj * TK;
    const int gi = i0 + oi, gj = j0 + oj, gk = k0 + ok;
    if (gi >= W || gj >= H || gk >= D) continue;
    const int vi = (gi * H + gj) * D + gk;
    const int s = ((oi + 1) * Tile::SJ + (oj + 1)) * Tile::SK + (ok + 1);
    // the cell whose corner 0 this vertex is
    const int cell0 = ((oi + 1) * Tile::CJ + (oj + 1)) * Tile::CK + (ok + 1);
    float dx[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool in_grid = (corner_a(q) ? gi >= 1 : gi < wc) &&
                           (corner_b(q) ? gj >= 1 : gj < hc) &&
                           (corner_c(q) ? gk >= 1 : gk < dc);
      if (in_grid) {
#pragma unroll
        for (int e = 0; e < 3; ++e)
          dx[e] = dx[e] +
                  sc[(3 * q + e) * Tile::C + scratch_slot(cell0 - cell_off(q))];
      }
    }
    const float ic = sic[s];
    const float w = sw[s];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float xe = __fadd_rn(sx[e * Tile::S + s], __fmul_rn(ic, dx[e]));
      x_out[e * n + vi] = xe;
      if (v_out != nullptr) {
        float v = w > 0.f
                      ? __fdiv_rn(__fsub_rn(xe, sx0[e * Tile::O + o]), P.h)
                      : v_in[e * n + vi];
        if (P.use_damp != 0.f) v = __fmul_rn(v, P.damp);
        v_out[e * n + vi] = v;
      }
    }
  }
}  // tet_box

__host__ __device__ inline int n_blocks(int W, int H, int D) {
  return ((W + TI - 1) / TI) * ((H + TJ - 1) / TJ) * ((D + TK - 1) / TK);
}

// FUSED 0: one Jacobi iteration of a substep, the box of block blockIdx.x
// of rollout blockIdx.y (tet_box; F unused). FUSED 1: a whole step of
// F.n_batch rollouts, F.substeps x F.iterations passes, in one cooperative
// launch (see the top of the file): x_in and v_in are the step's input,
// x_out and v_out its output, x_cur, lam_in and lam_out unused.
template <int FUSED>
__global__ void __launch_bounds__(Tile::threads, kMinBlocks)
tet_substep_kernel(const float* __restrict__ x_in,
                   const float* __restrict__ v_in,
                   const float* __restrict__ x_cur,
                   const float* __restrict__ w_g,
                   const float* __restrict__ ic_g,
                   const float* __restrict__ lam_in,
                   float* __restrict__ lam_out, float* __restrict__ x_out,
                   float* __restrict__ v_out, const TetParams P, int W, int H,
                   int D, int w_bstride, const FusedPlan F) {
  if constexpr (FUSED == 0) {
    tet_box<0>(x_in, v_in, x_cur, w_g, ic_g, lam_in, lam_out, x_out, v_out,
               nullptr, nullptr, P, W, H, D, w_bstride, blockIdx.x,
               blockIdx.y);
  } else {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    __shared__ PassBuffers pass;
    const int nbox = n_blocks(W, H, D);
    const int items = nbox * F.n_batch;
    const int passes = F.substeps * F.iterations;
    for (int p = 0; p < passes; ++p) {
      if (threadIdx.x == 0) {
        const int s = p / F.iterations, it = p - s * F.iterations;
        const bool first = it == 0, last = it == F.iterations - 1;
        // pass p reads the positions pass p - 1 wrote (the input at p = 0)
        // and writes the other plane set, the last pass x_out; a substep
        // reads the velocities the substep before it wrote and writes the
        // other set, the last substep v_out
        const float* xr = p == 0 ? x_in : ((passes - p) & 1) ? F.xs : x_out;
        const float* vr =
            s == 0 ? v_in : ((F.substeps - s) & 1) ? F.vs : v_out;
        pass.x_in = first ? xr : F.x0;
        pass.v_in = vr;
        pass.x_cur = first ? nullptr : xr;
        // lambda as grid_tet_cuda.lambda_plan: read the plane the
        // iteration before wrote, write the other
        pass.lam_in = first ? nullptr : ((it - 1) & 1) ? F.lam1 : F.lam0;
        pass.lam_out = last ? nullptr : (it & 1) ? F.lam1 : F.lam0;
        pass.x_out = ((passes - 1 - p) & 1) ? F.xs : x_out;
        pass.v_out =
            last ? ((F.substeps - 1 - s) & 1) ? F.vs : v_out : nullptr;
        pass.x0_out = first && !last ? F.x0 : nullptr;
      }
      __syncthreads();
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        // the item before may still read the block's shared memory
        if (item != (int)blockIdx.x) __syncthreads();
        tet_box<1>(nullptr, nullptr, nullptr, w_g, ic_g, nullptr, nullptr,
                   nullptr, nullptr, nullptr, &pass, P, W, H, D, w_bstride,
                   (unsigned)(item % nbox), (unsigned)(item / nbox));
      }
      grid.sync();
    }
  }
}  // tet_substep_kernel

// Opt in to the blocks' dynamic shared memory once per device: the
// attribute holds for every later launch there.
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(tet_substep_kernel<0>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Tile::smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tet_substep_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile::smem);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

bool dims_ok(int W, int H, int D) {
  if (W < 2 || H < 2 || D < 2) return false;
  const long long n = (long long)W * H * D;
  const long long cells = (long long)(W - 1) * (H - 1) * (D - 1);
  return 3 * n < INT_MAX && 5 * cells < INT_MAX;
}

// Blocks of the multi-substep mode resident on the current card at once
// (its grid's largest size): out = blocks an SM x SMs. Returns
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
    e = allow_smem();
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tet_substep_kernel<1>, Tile::threads, Tile::smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap[dev] = per_sm * sms;
  }
  *out = cap[dev];
  return cudaSuccess;
}

// The resources of tet_substep_kernel<FUSED>, laid out as
// pbd_tet_kernel_resources reports them.
template <int FUSED>
int resources_of(int* out) {
  if (!out) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, tet_substep_kernel<FUSED>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, tet_substep_kernel<FUSED>, Tile::threads, Tile::smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)Tile::smem;
  out[3] = (int)at.localSizeBytes;
  out[4] = blocks;
  out[5] = Tile::threads;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

int pbd_tet_param_count() { return N_PARAMS; }

// The per-iteration kernel's resources as the runtime sees them: out[0]
// registers a thread, out[1] static shared bytes a block, out[2] dynamic
// shared bytes a block, out[3] local (spill) bytes a thread, out[4] resident
// blocks an SM, out[5] threads a block. Returns a CUDA error code.
int pbd_tet_kernel_resources(int* out) { return resources_of<0>(out); }

// The same for the multi-substep kernel.
int pbd_tet_fused_resources(int* out) { return resources_of<1>(out); }

// One Jacobi iteration of a substep of n_batch rollouts, one launch. State
// planes are (n_batch, 3, W*H*D) float32; w is (W*H*D,) shared by the
// rollouts (w_bstride 0) or (n_batch, W*H*D) (w_bstride W*H*D); inv_cnt is
// (W*H*D,); lambda planes are (n_batch, 5, cells). x_cur is null exactly in
// a substep's first iteration, lam_in null in the first iteration and set
// in every later one of a substep with more than one; lam_out is set in
// every iteration but the last of such a substep; v_out is set in the last
// iteration only. Every output is distinct from every input. `params`
// points to N_PARAMS host floats. Returns a CUDA error code, 0 when the
// launch was queued.
int pbd_tet_substep_batched(const void* x_in, const void* v_in,
                            const void* x_cur, const void* w,
                            const void* inv_cnt, const void* lam_in,
                            void* lam_out, void* x_out, void* v_out,
                            const void* params, int n_batch, int w_bstride,
                            int W, int H, int D, void* stream) {
  if (!dims_ok(W, H, D) || x_out == nullptr || n_batch < 1 ||
      n_batch > 65535 || (w_bstride != 0 && w_bstride != W * H * D) ||
      (x_cur == nullptr && lam_in != nullptr) || x_out == x_in ||
      x_out == x_cur || (lam_out != nullptr && lam_out == lam_in))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  TetParams P;
  std::memcpy(&P, params, sizeof(P));
  const dim3 grid(n_blocks(W, H, D), n_batch);
  tet_substep_kernel<0><<<grid, Tile::threads, Tile::smem,
                          (cudaStream_t)stream>>>(
      (const float*)x_in, (const float*)v_in, (const float*)x_cur,
      (const float*)w, (const float*)inv_cnt, (const float*)lam_in,
      (float*)lam_out, (float*)x_out, (float*)v_out, P, W, H, D, w_bstride,
      FusedPlan{});
  return (int)cudaGetLastError();
}

// The same for one rollout: planes (3, W*H*D), lambda planes (5, cells).
int pbd_tet_substep(const void* x_in, const void* v_in, const void* x_cur,
                    const void* w, const void* inv_cnt, const void* lam_in,
                    void* lam_out, void* x_out, void* v_out,
                    const void* params, int W, int H, int D, void* stream) {
  return pbd_tet_substep_batched(x_in, v_in, x_cur, w, inv_cnt, lam_in,
                                 lam_out, x_out, v_out, params, 1, 0, W, H,
                                 D, stream);
}

// One solver step of n_batch rollouts, substeps x iterations passes, in
// one cooperative launch of the multi-substep kernel. x_in, v_in (the
// step's input) and x_out, v_out (its output) are (n_batch, 3, W*H*D)
// planes; w and inv_cnt as above. Scratch of the caller, left undefined:
// xs (planes like x_in) unless substeps x iterations is 1, vs (likewise)
// unless substeps is 1, x0 (likewise) and lam0 ((n_batch, 5, cells))
// unless iterations is 1, lam1 (likewise) past two iterations; every
// buffer distinct from every other. Writes the launch's grid size to
// *grid_size when it is not null. Returns a CUDA error code, 0 when the
// launch was queued; cudaErrorNotSupported on a card without cooperative
// launch.
int pbd_tet_step_fused(const void* x_in, const void* v_in, const void* w,
                       const void* inv_cnt, void* x_out, void* v_out,
                       void* xs, void* vs, void* x0, void* lam0, void* lam1,
                       const void* params, int n_batch, int w_bstride,
                       int substeps, int iterations, int W, int H, int D,
                       int* grid_size, void* stream) {
  if (!dims_ok(W, H, D) || x_in == nullptr || v_in == nullptr ||
      x_out == nullptr || v_out == nullptr || n_batch < 1 || substeps < 1 ||
      iterations < 1 || (w_bstride != 0 && w_bstride != W * H * D) ||
      (long long)n_blocks(W, H, D) * n_batch > INT_MAX ||
      (long long)substeps * iterations > INT_MAX ||
      (substeps * iterations > 1 && xs == nullptr) ||
      (substeps > 1 && vs == nullptr) ||
      (iterations > 1 && (x0 == nullptr || lam0 == nullptr)) ||
      (iterations > 2 && lam1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* bufs[] = {x_in, v_in, x_out, v_out, xs, vs, x0, lam0, lam1};
  for (int i = 0; i < 9; ++i)
    for (int j = i + 1; j < 9; ++j)
      if (bufs[i] != nullptr && bufs[i] == bufs[j])
        return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t e = fused_capacity(&cap);
  if (e != cudaSuccess) return (int)e;
  const int items = n_blocks(W, H, D) * n_batch;
  const int blocks = items < cap ? items : cap;
  if (grid_size != nullptr) *grid_size = blocks;
  TetParams P;
  std::memcpy(&P, params, sizeof(P));
  FusedPlan F{(float*)xs,   (float*)vs, (float*)x0, (float*)lam0,
              (float*)lam1, n_batch,    substeps,   iterations};
  const float* a_x = (const float*)x_in;
  const float* a_v = (const float*)v_in;
  const float* a_w = (const float*)w;
  const float* a_ic = (const float*)inv_cnt;
  const float* a_none = nullptr;
  float* a_none_w = nullptr;
  float* a_xo = (float*)x_out;
  float* a_vo = (float*)v_out;
  void* args[] = {&a_x, &a_v, &a_none, &a_w, &a_ic, &a_none, &a_none_w,
                  &a_xo, &a_vo, &P, &W, &H, &D, &w_bstride, &F};
  e = cudaLaunchCooperativeKernel((const void*)tet_substep_kernel<1>,
                                  dim3(blocks), dim3(Tile::threads), args,
                                  Tile::smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* pbd_tet_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
