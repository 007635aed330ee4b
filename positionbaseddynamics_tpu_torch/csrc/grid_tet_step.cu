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
// the larger of the two, ~2.2 us a substep.
//
// Design: the TPU kernel keeps whole (j, k) planes in lanes and tiles only
// along W with a halo of substeps * iterations + 1 rows; one row of the
// bar's 8 planes is 41 KB, so no W-slab with its halo fits 227 KB of
// shared memory. This kernel instead runs two passes per iteration, with
// no shared memory and no atomics:
//  (a) cell pass, one thread per cell: read the 8 corners, solve the 5
//      families in order t = 0..4, keep the 8 per-corner correction sums
//      in registers (families added in ascending t), write them to a
//      (24, cells) scratch buffer; lambda lives in a (5, cells) buffer
//      only when max_iterations > 1;
//  (b) vertex pass, one thread per vertex: gather the up to 8 cells that
//      own it in corner order 0..7 (corner (a, b, c) of cell
//      (i - a, j - b, k - c)), apply inv_cnt.
// That is exactly the plain version's summation order (per corner the
// families ascending, then the corners 0..7), so the kernel is
// deterministic and differs from the plain version only where the
// compiler contracts the solve's products into FMAs. The first cell and
// vertex pass of a substep integrate the positions they read (each
// recomputes x + h (v + h g) with explicitly rounded operations, so all
// agree bit for bit); the last vertex pass writes the velocity. Outputs
// go to fresh buffers: neighbouring cells read a vertex that another
// thread updates.
#include <climits>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int N_PARAMS = 112;
constexpr int kCellThreads = 128;
constexpr int kVertexThreads = 256;

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

// Corner c of a cell sits at (i + a, j + b, k + c) (grid_tet._CORNERS).
__host__ __device__ constexpr int corner_a(int c) {
  return (c == 2 || c == 3 || c == 6 || c == 7) ? 1 : 0;
}
__host__ __device__ constexpr int corner_b(int c) { return c >= 4 ? 1 : 0; }
__host__ __device__ constexpr int corner_c(int c) {
  return (c == 1 || c == 2 || c == 5 || c == 6) ? 1 : 0;
}

// Vertex vi's position as the substep sees it: x_cur where a previous
// iteration left one, else the integrated input (TimeIntegration.cpp:7-19:
// v += g h; x += v h where w > 0), rounded operation by operation.
__device__ __forceinline__ void load_x(const float* __restrict__ x_in,
                                       const float* __restrict__ v_in,
                                       const float* __restrict__ x_cur,
                                       int vi, int n, float w,
                                       const TetParams& P, float (&x)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (x_cur != nullptr) {
      x[a] = x_cur[a * n + vi];
    } else {
      float xa = x_in[a * n + vi];
      if (w > 0.f) {
        const float va = __fadd_rn(v_in[a * n + vi], __fmul_rn(P.g[a], P.h));
        xa = __fadd_rn(xa, __fmul_rn(va, P.h));
      }
      x[a] = xa;
    }
  }
}

// One tet of family T in a cell of parity ODD, corners C0..C3
// (grid_tet._TETS_ODD / _TETS_EVEN); adds its corrections into acc.
template <int ODD, int T, int C0, int C1, int C2, int C3>
__device__ __forceinline__ void solve_tet(const float (&x)[8][3],
                                          const float (&w)[8],
                                          float (&acc)[8][3],
                                          const TetParams& P,
                                          float* __restrict__ lam, int cell,
                                          int n_cells, bool first) {
  const float* irm = P.irm[ODD][T];
  const float vol = P.vol[ODD][T];
  // edge vectors d_i = p_i - p_3: ds[a][i]
  float ds[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ds[a][0] = x[C0][a] - x[C3][a];
    ds[a][1] = x[C1][a] - x[C3][a];
    ds[a][2] = x[C2][a] - x[C3][a];
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
  float s[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      s[a][b] = a == b ? P.two_mu * e[a][b] + ltr : P.two_mu * e[a][b];
  // first Piola stress sigma = F (2 mu e + lame tr(e) I)
  float sig[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      sig[a][b] = f[a][0] * s[0][b] + f[a][1] * s[1][b] + f[a][2] * s[2][b];
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

  const float c = sqrtf(fmaxf(2.f * u, 0.f));
  float sn = w[C0] * (g[0][0] * g[0][0] + g[0][1] * g[0][1] + g[0][2] * g[0][2]);
  sn = sn + w[C1] * (g[1][0] * g[1][0] + g[1][1] * g[1][1] + g[1][2] * g[1][2]);
  sn = sn + w[C2] * (g[2][0] * g[2][0] + g[2][1] * g[2][1] + g[2][2] * g[2][2]);
  sn = sn + w[C3] * (g[3][0] * g[3][0] + g[3][1] * g[3][1] + g[3][2] * g[3][2]);
  sn = sn + c * c * P.alpha;
  float* lp = lam == nullptr ? nullptr : lam + T * n_cells + cell;
  const float l = (lp == nullptr || first) ? 0.f : *lp;
  const bool valid = sn >= 1e-6f && P.active != 0.f;
  const float inv_sn = fabsf(sn) > 1e-30f ? 1.f / sn : 0.f;
  const float dl = valid ? (-c * (c + P.alpha * l)) * inv_sn : 0.f;
  if (lp != nullptr) *lp = l + dl;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    acc[C0][a] = acc[C0][a] + (dl * w[C0]) * g[0][a];
    acc[C1][a] = acc[C1][a] + (dl * w[C1]) * g[1][a];
    acc[C2][a] = acc[C2][a] + (dl * w[C2]) * g[2][a];
    acc[C3][a] = acc[C3][a] + (dl * w[C3]) * g[3][a];
  }
}

// Cell pass: x_cur null in a substep's first iteration (integrate). lam
// null when the substep has one iteration; else lambda is zero in the first
// iteration and read back in the later ones.
__global__ void __launch_bounds__(kCellThreads)
tet_cell_kernel(const float* __restrict__ x_in,
                const float* __restrict__ v_in,
                const float* __restrict__ x_cur,
                const float* __restrict__ w_g, float* __restrict__ lam,
                float* __restrict__ scratch, const TetParams P, int W, int H,
                int D) {
  const int wc = W - 1, hc = H - 1, dc = D - 1;
  const int n_cells = wc * hc * dc;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const int k = cell % dc;
  const int r = cell / dc;
  const int j = r % hc;
  const int i = r / hc;
  const int n = W * H * D;
  const int base = (i * H + j) * D + k;

  float x[8][3], w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int vi = base + (corner_a(q) * H + corner_b(q)) * D + corner_c(q);
    w[q] = w_g[vi];
    load_x(x_in, v_in, x_cur, vi, n, w[q], P, x[q]);
  }
  float acc[8][3];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.f;
  const bool first = x_cur == nullptr;
  if ((i + j + k) & 1) {
    solve_tet<1, 0, 2, 1, 6, 3>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<1, 1, 6, 3, 4, 7>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<1, 2, 4, 1, 6, 5>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<1, 3, 3, 1, 4, 0>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<1, 4, 6, 1, 4, 3>(x, w, acc, P, lam, cell, n_cells, first);
  } else {
    solve_tet<0, 0, 0, 2, 5, 1>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<0, 1, 7, 2, 0, 3>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<0, 2, 5, 2, 7, 6>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<0, 3, 7, 0, 5, 4>(x, w, acc, P, lam, cell, n_cells, first);
    solve_tet<0, 4, 0, 2, 7, 5>(x, w, acc, P, lam, cell, n_cells, first);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int a = 0; a < 3; ++a) scratch[(3 * q + a) * n_cells + cell] = acc[q][a];
}

// Vertex pass: gather the corrections of the cells that own the vertex,
// in corner order, and apply inv_cnt; v_out non-null in a substep's last
// iteration (first-order velocity update, TimeIntegration.cpp:42-51, and
// damping).
__global__ void __launch_bounds__(kVertexThreads)
tet_vertex_kernel(const float* __restrict__ x_in,
                  const float* __restrict__ v_in,
                  const float* __restrict__ x_cur,
                  const float* __restrict__ w_g,
                  const float* __restrict__ ic_g,
                  const float* __restrict__ scratch,
                  float* __restrict__ x_out, float* __restrict__ v_out,
                  const TetParams P, int W, int H, int D) {
  const int n = W * H * D;
  const int vi = blockIdx.x * blockDim.x + threadIdx.x;
  if (vi >= n) return;
  const int k = vi % D;
  const int r = vi / D;
  const int j = r % H;
  const int i = r / H;
  const int wc = W - 1, hc = H - 1, dc = D - 1;
  const int n_cells = wc * hc * dc;
  const float w = w_g[vi];
  float x[3];
  load_x(x_in, v_in, x_cur, vi, n, w, P, x);

  float dx[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int ci = i - corner_a(q), cj = j - corner_b(q), ck = k - corner_c(q);
    if (ci >= 0 && ci < wc && cj >= 0 && cj < hc && ck >= 0 && ck < dc) {
      const int cell = (ci * hc + cj) * dc + ck;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        dx[a] = dx[a] + scratch[(3 * q + a) * n_cells + cell];
    }
  }
  const float ic = ic_g[vi];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xa = __fadd_rn(x[a], __fmul_rn(ic, dx[a]));
    x_out[a * n + vi] = xa;
    if (v_out != nullptr) {
      float v = w > 0.f ? __fdiv_rn(__fsub_rn(xa, x_in[a * n + vi]), P.h)
                        : v_in[a * n + vi];
      if (P.use_damp != 0.f) v = __fmul_rn(v, P.damp);
      v_out[a * n + vi] = v;
    }
  }
}

bool dims_ok(int W, int H, int D) {
  if (W < 2 || H < 2 || D < 2) return false;
  const long long n = (long long)W * H * D;
  const long long cells = (long long)(W - 1) * (H - 1) * (D - 1);
  return 3 * n < INT_MAX && 24 * cells < INT_MAX;
}

}  // namespace

extern "C" {

int pbd_tet_param_count() { return N_PARAMS; }

// The cell pass of iteration `iteration` of a substep. State planes are
// (3, W*H*D) float32; w is (W*H*D,); lam is (5, cells) or null when the
// substep has a single iteration (use_lam 0); scratch is (24, cells).
// x_cur is null exactly in iteration 0. `params` points to N_PARAMS host
// floats. Returns a CUDA error code, 0 when the launch was queued.
int pbd_tet_cells(const void* x_in, const void* v_in, const void* x_cur,
                  const void* w, void* lam, void* scratch, const void* params,
                  int W, int H, int D, int iteration, int use_lam,
                  void* stream) {
  if (!dims_ok(W, H, D) || iteration < 0 ||
      (x_cur == nullptr) != (iteration == 0) ||
      (use_lam != 0) != (lam != nullptr))
    return (int)cudaErrorInvalidValue;
  TetParams P;
  std::memcpy(&P, params, sizeof(P));
  const int n_cells = (W - 1) * (H - 1) * (D - 1);
  const int blocks = (n_cells + kCellThreads - 1) / kCellThreads;
  tet_cell_kernel<<<blocks, kCellThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x_in, (const float*)v_in, (const float*)x_cur,
      (const float*)w, (float*)lam, (float*)scratch, P, W, H, D);
  return (int)cudaGetLastError();
}

// The vertex pass of an iteration: reads the scratch the cell pass wrote,
// writes the positions to x_out and, in the substep's last iteration
// (v_out non-null), the velocities. Outputs are distinct from every input.
int pbd_tet_vertices(const void* x_in, const void* v_in, const void* x_cur,
                     const void* w, const void* inv_cnt, const void* scratch,
                     void* x_out, void* v_out, const void* params, int W,
                     int H, int D, void* stream) {
  if (!dims_ok(W, H, D) || x_out == nullptr) return (int)cudaErrorInvalidValue;
  TetParams P;
  std::memcpy(&P, params, sizeof(P));
  const int n = W * H * D;
  const int blocks = (n + kVertexThreads - 1) / kVertexThreads;
  tet_vertex_kernel<<<blocks, kVertexThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x_in, (const float*)v_in, (const float*)x_cur,
      (const float*)w, (const float*)inv_cnt, (const float*)scratch,
      (float*)x_out, (float*)v_out, P, W, H, D);
  return (int)cudaGetLastError();
}

const char* pbd_tet_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
