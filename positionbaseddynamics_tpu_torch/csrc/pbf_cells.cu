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
// Design of all three, against what held the first design (one lane per
// slot, ~1/4 of the lanes busy, each waiting on a chain of dependent
// global loads per candidate) back: one warp per active cell and per
// block, so a cell's warp leaves the SM when it is done. Lanes 0-26 read
// the 27 neighbours' flags and ids together with the cell's id, then all
// the counts at once; a warp scan (__shfl_up_sync) lays the neighbours'
// occupied prefixes end to end as one candidate list, which all 32 lanes
// copy with cp.async, every copy in flight together and no register held,
// into the warp's shared memory as float4 records: {x0, y0, z0, m} and
// {x, y, z, lambda} per fluid candidate (lambda in B4 only, rho in B5),
// and a third record: {x, y, z, psi} per boundary candidate in B3 and B4,
// {vx, vy, vz, -} per fluid candidate in B5, which walks fluid pairs only
// and opens no boundary list. A list longer than the buffer
// (kStageFluid, kStageBoundary) is staged and walked in chunks. The
// cell's n particles then share the 32 lanes: a group of G lanes per
// particle, G the largest power of two with G n <= 32 (past 32 particles
// G = 1 and the groups take 32 particles at a time). A group's lanes
// stride over the staged candidates; each lane tests up to 64 of its
// candidates without branches into a bit mask, then walks the pairs that
// passed, so the warp does the in-range arithmetic only as often as the
// lane with the most pairs needs it. Each lane keeps partial sums in
// registers and a __shfl_xor_sync tree adds them in a fixed order (no
// atomics: the result is the same from run to run). The group's first
// lane finishes lambda, x + dx or v - nu dv and writes its slot. B3
// writes its lambda and density rows into tables B4 and B5 read; B4 and
// B5 write to tables other than their inputs, since neighbours read the
// values they replace. 10.3 KB (B3, B4) and 12.3 KB (B5) of static shared
// memory and <= 64 registers a block (one warp) let 17-20 blocks share an
// SM; pbd_pbf_kernel_resources reports both.
//
// B5 cannot join the last B4's walk: it reads every neighbour's velocity
// (x_new - x_old) / h, which exists only once the last B4 has written all
// cells, a dependency across the whole grid between two launches.
// No --use_fast_math: sqrtf and division stay IEEE-rounded.
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int N_PARAMS = 8;
constexpr int kWarp = 32;
// one warp (one active cell) a block, so that a cell's warp leaves the SM
// as soon as it is done; 20 blocks of B3 or B4 an SM fit the shared
// memory, and registers are held to what 20 allow
constexpr int kMinBlocks = 20;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kStageFluid = 256;     // fluid candidates a warp stages
constexpr int kStageBoundary = 128;  // boundary candidates a warp stages

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

// ---------------------------------------------------------------------------
// The staged neighbourhood
// ---------------------------------------------------------------------------

// One warp's copy of (a chunk of) its cell's candidate list, in B3 and B4.
struct Stage {
  float4 f0[kStageFluid];      // x0, y0, z0, m of a fluid candidate
  float4 f1[kStageFluid];      // x, y, z of the same slot; lambda (B4)
  float4 b[kStageBoundary];    // x, y, z, psi of a boundary candidate
  int foff[27];                // fluid candidates before neighbour o
  int boff[27];                // boundary candidates before neighbour o
  int nc[27];                  // neighbour o's cell id
};

// B5's: fluid candidates only, each with its velocity.
struct VelStage {
  float4 f0[kStageFluid];      // x0, y0, z0, m of a fluid candidate
  float4 f1[kStageFluid];      // x, y, z, rho of the same slot
  float4 v[kStageFluid];       // vx, vy, vz of the same slot
  int foff[27];
  int boff[27];                // all 0: no boundary list
  int nc[27];
};

template <class St>
constexpr bool kHasBoundary = std::is_same<St, Stage>::value;

struct Hood {
  int row, n;     // the cell's first slot and occupied prefix
  int nf, nb;     // fluid and boundary candidates of the 27 neighbours
  int chunks;     // staging rounds they take
};

// Opens active cell a with two rounds of loads: its id and lane o < 27's
// neighbour flag and id, then the cell's count and neighbour o's counts
// (fluid, and boundary where the stage holds a boundary list). A warp
// scan turns the counts into each neighbour's offset in the candidate
// lists.
template <class St>
__device__ Hood open_hood(const Cells& C, int a, St& S, int lane) {
  const int cell = __ldg(C.active + a);
  bool ok = false;
  int nc = 0, cf = 0, cb = 0;
  if (lane < 27) {
    ok = __ldg(C.ok + a * 27 + lane);
    nc = __ldg(C.nbr + a * 27 + lane);
  }
  Hood h;
  h.row = cell * C.cap;
  h.n = __ldg(C.count + cell);
  if (ok) {
    cf = __ldg(C.count + nc);
    if (kHasBoundary<St> && C.capb > 0) cb = __ldg(C.bcount + nc);
  }
  int sf = cf, sb = cb;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int tf = __shfl_up_sync(kAll, sf, d);
    const int tb = __shfl_up_sync(kAll, sb, d);
    if (lane >= d) {
      sf += tf;
      sb += tb;
    }
  }
  if (lane < 27) {
    S.foff[lane] = sf - cf;
    S.boff[lane] = sb - cb;
    S.nc[lane] = nc;
  }
  h.nf = __shfl_sync(kAll, sf, kWarp - 1);
  h.nb = __shfl_sync(kAll, sb, kWarp - 1);
  h.chunks = max((h.nf + kStageFluid - 1) / kStageFluid,
                 (h.nb + kStageBoundary - 1) / kStageBoundary);
  __syncwarp();
  return h;
}

// The neighbour whose stretch of a candidate list holds candidate g: the
// last o with off[o] <= g (a neighbour with no candidates has the same
// offset as the next one, so it is never the last).
__device__ __forceinline__ int hood_of(const int* off, int g) {
  int o = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (o + step < 27 && off[o + step] <= g) o += step;
  return o;
}

__device__ __forceinline__ int chunk_len(int total, int chunk, int size) {
  return min(size, max(total - chunk * size, 0));
}

// One 4-byte asynchronous copy from global into shared memory (cp.async):
// it holds no register while in flight.
__device__ __forceinline__ void copy_async(float* dst_shared,
                                           const float* src) {
  __pipeline_memcpy_async(dst_shared, src, sizeof(float));
}

// Copies of fluid candidate e's third record, the velocity in B5.
__device__ __forceinline__ void stage_velocity(Stage&, int, const float*,
                                               int, int) {}

__device__ __forceinline__ void stage_velocity(VelStage& S, int e,
                                               const float* vel, int jj,
                                               int plane) {
  copy_async(&S.v[e].x, vel + jj);
  copy_async(&S.v[e].y, vel + plane + jj);
  copy_async(&S.v[e].z, vel + 2 * plane + jj);
}

// Copies of chunk `ch` of the boundary candidate list (B3, B4).
__device__ __forceinline__ void stage_boundary(const Cells& C, Stage& S,
                                               const Hood& h, int ch,
                                               int lane) {
  const int bplane = C.n_cells * C.capb;
  const int nb = chunk_len(h.nb, ch, kStageBoundary);
  for (int e = lane; e < nb; e += kWarp) {
    const int g = ch * kStageBoundary + e;
    const int o = hood_of(S.boff, g);
    const int bb = S.nc[o] * C.capb + (g - S.boff[o]);
    float4& pb = S.b[e];
    copy_async(&pb.x, C.bx + bb);
    copy_async(&pb.y, C.bx + bplane + bb);
    copy_async(&pb.z, C.bx + 2 * bplane + bb);
    copy_async(&pb.w, C.bpsi + bb);
  }
}

__device__ __forceinline__ void stage_boundary(const Cells&, VelStage&,
                                               const Hood&, int, int) {}

// Starts the copies of chunk `ch` of the fluid and boundary candidate
// lists into S, all lanes at once and every copy in flight together, as
// two groups: the fluid candidates (the fourth float of f1 from w1 where
// it is given: lambda in B4, rho in B5; the velocity from vel in B5), then
// the boundary candidates. staged_fluid() and staged_all() wait for them.
template <class St>
__device__ void stage_chunk(const Cells& C, const float* w1,
                            const float* vel, St& S, const Hood& h, int ch,
                            int lane) {
  __syncwarp();                  // every lane is done with the last chunk
  const int plane = C.n_cells * C.cap;
  const int nf = chunk_len(h.nf, ch, kStageFluid);
  for (int e = lane; e < nf; e += kWarp) {
    const int g = ch * kStageFluid + e;
    const int o = hood_of(S.foff, g);
    const int jj = S.nc[o] * C.cap + (g - S.foff[o]);
    float4& p0 = S.f0[e];
    float4& p1 = S.f1[e];
    copy_async(&p0.x, C.x0 + jj);
    copy_async(&p0.y, C.x0 + plane + jj);
    copy_async(&p0.z, C.x0 + 2 * plane + jj);
    copy_async(&p0.w, C.m + jj);
    copy_async(&p1.x, C.x + jj);
    copy_async(&p1.y, C.x + plane + jj);
    copy_async(&p1.z, C.x + 2 * plane + jj);
    if (w1) copy_async(&p1.w, w1 + jj);
    stage_velocity(S, e, vel, jj, plane);
  }
  __pipeline_commit();
  stage_boundary(C, S, h, ch, lane);
  __pipeline_commit();
}

__device__ __forceinline__ void staged_fluid() {
  __pipeline_wait_prior(1);
  __syncwarp();
}

__device__ __forceinline__ void staged_all() {
  __pipeline_wait_prior(0);
  __syncwarp();
}

// How a cell's n >= 1 particles share the warp: `g` lanes each (a power
// of two), `per_round` particles at a time; this lane serves particle
// round * per_round + grp and walks candidates sub, sub + g, ...
struct Lanes {
  int g, per_round, grp, sub;
};

__device__ __forceinline__ Lanes lanes_for(int n, int lane) {
  Lanes L;
  L.g = n >= kWarp ? 1 : kWarp >> (32 - __clz(n - 1));
  L.per_round = kWarp / L.g;
  L.grp = lane / L.g;
  L.sub = lane % L.g;
  return L;
}

// Sum over a group of g lanes (g a power of two, the same in the warp), in
// a fixed order; every lane of the group gets the sum.
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// The frozen tests, without branches (one 16-byte shared load each, so
// the unrolled tests of for_passing overlap).
__device__ __forceinline__ bool fluid_pair(const float4 c, const float* xi0,
                                           const PbfParams& P) {
  const float r2_0 = dist2_rn(__fsub_rn(xi0[0], c.x), __fsub_rn(xi0[1], c.y),
                              __fsub_rn(xi0[2], c.z));
  return (c.w > 0.0f) & (r2_0 > 1e-18f) & (r2_0 < P.h2);
}

__device__ __forceinline__ bool boundary_pair(const float4 c,
                                              const float* xi0,
                                              const PbfParams& P) {
  const float r2_0 = dist2_rn(__fsub_rn(xi0[0], c.x), __fsub_rn(xi0[1], c.y),
                              __fsub_rn(xi0[2], c.z));
  return (c.w > 0.0f) & (r2_0 < P.h2);
}

constexpr int kTests = 64;       // candidates a lane tests before walking
constexpr int kTestGroup = 8;    // tests unrolled together

// Calls f(c) for every staged candidate c = L.sub, L.sub + L.g, ... below
// n that passes test(c), in that order. The tests of up to kTests of them
// come first, kTestGroup at a time without branches, into a bit mask;
// then the arithmetic of those that passed. So a lane's in-range branch
// does not hold the warp on every candidate that some other lane takes:
// the walk takes as many steps as the most pairs a lane found.
template <class Test, class F>
__device__ __forceinline__ void for_passing(int n, const Lanes& L,
                                            Test&& test, F&& f) {
  for (int base = L.sub; base < n; base += kTests * L.g) {
    unsigned long long mask = 0;
    for (int t0 = 0; t0 < kTests && base + t0 * L.g < n; t0 += kTestGroup) {
#pragma unroll
      for (int u = 0; u < kTestGroup; ++u) {
        const int t = t0 + u, c = base + t * L.g;
        // past the chunk's end, test its last candidate and drop the bit
        const bool pass = test(min(c, n - 1));
        mask |= (unsigned long long)((c < n) & pass) << t;
      }
    }
    while (mask) {
      const int t = __ffsll(mask) - 1;
      mask &= mask - 1;
      f(base + t * L.g);
    }
  }
}

// Walks this lane's share of its particle's staged neighbourhood (xi0 its
// pre-projection position; nothing when `live` is false), chunk by chunk:
// calls fluid(c) for every staged fluid candidate c that is a frozen pair
// and, in B3 and B4, boundary(S.b[c]) for every frozen boundary pair. A
// chunk is staged in the first particle round, and again in later rounds
// only when the neighbourhood takes more than one chunk.
template <class St, class Fluid, class Boundary>
__device__ __forceinline__ void walk_hood(const Cells& C, const PbfParams& P,
                                          const float* w1, const float* vel,
                                          St& S, const Hood& h,
                                          const Lanes& L, int s0, bool live,
                                          const float* xi0, int lane,
                                          Fluid&& fluid,
                                          Boundary&& boundary) {
  for (int ch = 0; ch < h.chunks; ++ch) {
    const bool restage = h.chunks > 1 || s0 == 0;
    if (restage) {
      stage_chunk(C, w1, vel, S, h, ch, lane);
      staged_fluid();
    }
    const int nf = live ? chunk_len(h.nf, ch, kStageFluid) : 0;
    for_passing(
        nf, L, [&](int c) { return fluid_pair(S.f0[c], xi0, P); }, fluid);
    if (restage) staged_all();
    if constexpr (kHasBoundary<St>) {
      const int nb = live ? chunk_len(h.nb, ch, kStageBoundary) : 0;
      for_passing(
          nb, L, [&](int c) { return boundary_pair(S.b[c], xi0, P); },
          [&](int c) { boundary(S.b[c]); });
    }
  }
}

__global__ void __launch_bounds__(kWarp, kMinBlocks)
    pbf_density_lambda_kernel(Cells C, PbfParams P, float* lam_t,
                              float* dens_t) {
  __shared__ Stage S;
  const int a = blockIdx.x;
  if (a >= C.K) return;
  const int lane = threadIdx.x;
  const int plane = C.n_cells * C.cap;
  const Hood h = open_hood(C, a, S, lane);
  const int row = h.row, n = h.n;
  for (int s = n + lane; s < C.cap; s += kWarp) {      // empty slots
    lam_t[row + s] = 0.0f;
    dens_t[row + s] = __ldg(C.m + row + s) * P.k;
  }
  if (n == 0) return;
  const Lanes L = lanes_for(n, lane);
  for (int s0 = 0; s0 < n; s0 += L.per_round) {
    const int s = s0 + L.grp, i = row + s;
    const float mi = s < n ? __ldg(C.m + i) : 0.0f;
    const bool live = mi > 0.0f;
    float xi[3] = {0.0f, 0.0f, 0.0f}, xi0[3] = {0.0f, 0.0f, 0.0f};
    if (s < n) {
      for (int c = 0; c < 3; ++c) {
        xi[c] = __ldg(C.x + c * plane + i);
        xi0[c] = __ldg(C.x0 + c * plane + i);
      }
    }
    // density, sum |grad C_j|^2 and grad C_i's sum over this lane's pairs
    float rho = 0.0f, s2 = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
    // a pair with weight w (m_j or psi_b) at position pj
    auto add = [&](float w, const float4& pj) {
      const float dx = xi[0] - pj.x, dy = xi[1] - pj.y, dz = xi[2] - pj.z;
      const float r2 = dist2_rn(dx, dy, dz);
      const float rl = sqrtf(r2);
      rho += w * w_r(rl, P);
      const float gc = -(w / P.density0) * grad_w_coef(rl, P);
      s2 += gc * gc * r2;
      gx += gc * dx;
      gy += gc * dy;
      gz += gc * dz;
    };
    walk_hood(
        C, P, nullptr, nullptr, S, h, L, s0, live, xi0, lane,
        [&](int c) { add(S.f0[c].w, S.f1[c]); },
        [&](const float4& pb) { add(pb.w, pb); });
    rho = group_sum(rho, L.g);
    s2 = group_sum(s2, L.g);
    gx = group_sum(gx, L.g);
    gy = group_sum(gy, L.g);
    gz = group_sum(gz, L.g);
    if (L.sub == 0 && s < n) {
      const float dens = mi * P.k + rho;
      float lam = 0.0f;
      if (live) {
        const float sum2 = s2 + ((gx * gx + gy * gy) + gz * gz);
        const float c = fmaxf(dens / P.density0 - 1.0f, 0.0f);
        lam = c > 0.0f ? -c / (sum2 + 1.0e-6f) : 0.0f;
      }
      lam_t[i] = lam;
      dens_t[i] = dens;
    }
  }
}

__global__ void __launch_bounds__(kWarp, kMinBlocks)
    pbf_corrections_kernel(Cells C, PbfParams P, const float* lam_t,
                           float* x_out) {
  __shared__ Stage S;
  const int a = blockIdx.x;
  if (a >= C.K) return;
  const int lane = threadIdx.x;
  const int plane = C.n_cells * C.cap;
  const Hood h = open_hood(C, a, S, lane);
  const int row = h.row, n = h.n;
  for (int s = n + lane; s < C.cap; s += kWarp)        // empty slots
    for (int c = 0; c < 3; ++c)
      x_out[c * plane + row + s] = __ldg(C.x + c * plane + row + s);
  if (n == 0) return;
  const Lanes L = lanes_for(n, lane);
  for (int s0 = 0; s0 < n; s0 += L.per_round) {
    const int s = s0 + L.grp, i = row + s;
    const float mi = s < n ? __ldg(C.m + i) : 0.0f;
    const bool live = mi > 0.0f;
    float xi[3] = {0.0f, 0.0f, 0.0f}, xi0[3] = {0.0f, 0.0f, 0.0f};
    float li = 0.0f;
    if (s < n) {
      for (int c = 0; c < 3; ++c) {
        xi[c] = __ldg(C.x + c * plane + i);
        xi0[c] = __ldg(C.x0 + c * plane + i);
      }
      li = __ldg(lam_t + i);
    }
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;   // this lane's share of -dx
    // a pair with weight w (m_j or psi_b) at position pj, whose gradient
    // term is scaled by lsum (lambda_i + lambda_j, or lambda_i)
    auto add = [&](float w, float lsum, const float4& pj) {
      const float dx = xi[0] - pj.x, dy = xi[1] - pj.y, dz = xi[2] - pj.z;
      const float rl = sqrtf(dist2_rn(dx, dy, dz));
      const float coef = lsum * (-(w / P.density0) * grad_w_coef(rl, P));
      fx += coef * dx;
      fy += coef * dy;
      fz += coef * dz;
    };
    walk_hood(
        C, P, lam_t, nullptr, S, h, L, s0, live, xi0, lane,
        [&](int c) { add(S.f0[c].w, li + S.f1[c].w, S.f1[c]); },
        [&](const float4& pb) { add(pb.w, li, pb); });
    fx = group_sum(fx, L.g);
    fy = group_sum(fy, L.g);
    fz = group_sum(fz, L.g);
    if (L.sub == 0 && s < n) {
      if (live) {
        xi[0] = xi[0] + -fx;
        xi[1] = xi[1] + -fy;
        xi[2] = xi[2] + -fz;
      }
      x_out[i] = xi[0];
      x_out[plane + i] = xi[1];
      x_out[2 * plane + i] = xi[2];
    }
  }
}

// ---------------------------------------------------------------------------
// B5
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWarp, kMinBlocks)
    pbf_xsph_kernel(Cells C, PbfParams P, const float* vt,
                    const float* dens_t, float* v_out) {
  __shared__ VelStage S;
  const int a = blockIdx.x;
  if (a >= C.K) return;
  const int lane = threadIdx.x;
  const int plane = C.n_cells * C.cap;
  const Hood h = open_hood(C, a, S, lane);
  const int row = h.row, n = h.n;
  for (int s = n + lane; s < C.cap; s += kWarp)        // empty slots
    for (int c = 0; c < 3; ++c)
      v_out[c * plane + row + s] = __ldg(vt + c * plane + row + s);
  if (n == 0) return;
  const Lanes L = lanes_for(n, lane);
  for (int s0 = 0; s0 < n; s0 += L.per_round) {
    const int s = s0 + L.grp, i = row + s;
    const float mi = s < n ? __ldg(C.m + i) : 0.0f;
    const bool live = mi > 0.0f;
    float xi[3] = {0.0f, 0.0f, 0.0f}, xi0[3] = {0.0f, 0.0f, 0.0f};
    float vi[3] = {0.0f, 0.0f, 0.0f};
    if (s < n) {
      for (int c = 0; c < 3; ++c) {
        xi[c] = __ldg(C.x + c * plane + i);
        xi0[c] = __ldg(C.x0 + c * plane + i);
        vi[c] = __ldg(vt + c * plane + i);
      }
    }
    float dvx = 0.0f, dvy = 0.0f, dvz = 0.0f;   // this lane's share of dv
    walk_hood(
        C, P, dens_t, vt, S, h, L, s0, live, xi0, lane,
        [&](int c) {
          const float4 pj = S.f1[c];
          const float4 vj = S.v[c];
          const float rl = sqrtf(dist2_rn(xi[0] - pj.x, xi[1] - pj.y,
                                          xi[2] - pj.z));
          const float coef = (S.f0[c].w / fmaxf(pj.w, 1e-6f)) * w_r(rl, P);
          dvx += coef * (vi[0] - vj.x);
          dvy += coef * (vi[1] - vj.y);
          dvz += coef * (vi[2] - vj.z);
        },
        [](const float4&) {});
    dvx = group_sum(dvx, L.g);
    dvy = group_sum(dvy, L.g);
    dvz = group_sum(dvz, L.g);
    if (L.sub == 0 && s < n) {
      if (live) {
        vi[0] = vi[0] + P.neg_visc * dvx;
        vi[1] = vi[1] + P.neg_visc * dvy;
        vi[2] = vi[2] + P.neg_visc * dvz;
      }
      v_out[i] = vi[0];
      v_out[plane + i] = vi[1];
      v_out[2 * plane + i] = vi[2];
    }
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

}  // namespace

extern "C" {

int pbd_pbf_param_count() { return N_PARAMS; }

// The candidates one warp stages at a time: out[0] fluid (B3, B4, B5),
// out[1] boundary (B3, B4).
void pbd_pbf_stage_capacity(int* out) {
  out[0] = kStageFluid;
  out[1] = kStageBoundary;
}

// Resources of kernel `which` (0 B3, 1 B4, 2 B5) as the runtime sees them:
// out[0] registers a thread, out[1] static shared bytes a block, out[2]
// local (spill) bytes a thread, out[3] resident blocks an SM at the
// launch's block size (one warp). Returns a CUDA error code.
int pbd_pbf_kernel_resources(int which, int* out) {
  const void* fn = which == 0   ? (const void*)pbf_density_lambda_kernel
                   : which == 1 ? (const void*)pbf_corrections_kernel
                   : which == 2 ? (const void*)pbf_xsph_kernel
                                : nullptr;
  if (!fn || !out) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, kWarp, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = (int)at.localSizeBytes;
  out[3] = blocks;
  return 0;
}

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
  pbf_density_lambda_kernel<<<K, kWarp, 0,
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
  pbf_corrections_kernel<<<K, kWarp, 0,
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
  pbf_xsph_kernel<<<K, kWarp, 0, (cudaStream_t)stream>>>(
      C, P, (const float*)vt, (const float*)dens_t, (float*)v_out);
  return (int)cudaGetLastError();
}

const char* pbd_pbf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
