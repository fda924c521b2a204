// Structured-ADMM iteration loop for small shapes known only at run time,
// for Hopper (sm_90a): one lane a block, [A_s; A_d] in registers. The kernel
// of every shape without an instantiation in structured_admm_tiled.cu or
// structured_admm_folded.cu whose lane fits the registers of one block (n <=
// 64, m <= 512): the connectivity teams of apps/sweep.py ((35 + R, 125 + R,
// 2R - 2) on 15 R lanes, R = 2..10), run_sim's 3-robot connectivity team
// ((38, 128, 4) on 3 lanes) and the small teams of benchmarks/swarm.py (fov
// teams to 29 agents, such as the 24-agent (59, 143, 276)). Every larger lane
// goes to structured_admm_cluster.cu; structured_admm_variant() decides.
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170); what
// one iteration computes is written out in structured_admm.cu.
//
// The numbers that decide the design. At the sweep's largest team (45, 135,
// 18) an iteration is 2 x 153 x 45 = 13 770 float32 multiply-adds and 2 025
// in float64 (C RHS) for a lane; the launches get 30 to 150 lanes, fewer
// than the card's 132 SMs hold twice over, and run_sim gives 3. What bounds
// such a launch is not the card's arithmetic but the chain of dependent
// stages an iteration makes, each behind a block-wide barrier: the first
// version ran eight, each a serial dot product of 35-45 shared-memory loads
// in one thread. The 24-agent fov shape (m = 419) is the other end: 49 442
// float32 and 3 481 float64 multiply-adds an iteration on 768 lanes.
//
// What this design does about it:
// 1. The kernel takes the lane's float64 C = (M_s + A_d' R A_d)^-1 [n, n],
//    which the caller factors on the device (ops/qp/structured.py::
//    folded_c), and reads it once a launch into shared memory. An iteration
//    is three stages with three block-wide barriers: [A_s; A_d]'r (the warps'
//    column sums met in shared memory: barrier 1, RHS: barrier 2), xt = C RHS
//    (barrier 3), [A_s; A_d] xt with the row updates. C RHS accumulates in
//    float64 (the Woodbury cancellation, structured_admm.cu).
// 2. A warp owns up to 32 whole rows of [A_s; A_d] in registers; lane l holds
//    columns l, l + 32 of them (32 x 2 values a thread) and the z, y, bounds
//    and rho of the row it owns. [A_s; A_d]'r: each lane sums its columns
//    over the warp's rows, r read as broadcast float4 loads. C RHS: P = 4
//    threads a row of C, met by two shuffles; C's row stride keeps a
//    half-warp's loads on 32 banks. [A_s; A_d] xt: the lane's 32 partial row
//    sums meet across the warp through a tile of shared memory (a row of the
//    tile a lane, read back by columns); lane l then updates row l at once,
//    so the row update needs no barrier of its own, and the r it writes is
//    read by its own warp only (__syncwarp).
// 3. Two layouts: RegN64 (m <= 256, at most 8 warps, two blocks an SM: the
//    sweep, run_sim) and RegN64Tall (m <= 512, 16 warps: the 24-agent team).
// One lane a block: a NaN lane cannot reach another lane.
// What the card measured, and the layouts tried (16 rows a warp, a
// transposing butterfly of shuffles in place of the tile, threads a row of
// C, each warp forming its own RHS in place of barrier 2), is in PERF.md;
// scripts/admm_kernel_sweep.py --generic times other GenericShape lines.
// Lanes past the registers go to the cluster kernel even where one block's
// shared memory would hold C and the row state: it ran the fov teams of 40
// and 64 agents 2.4-2.5 times faster than a layout here that read the rows
// from device memory twice an iteration (PERF.md).
//
// Built without --use_fast_math: inactive dynamic rows carry rho = 1e-12
// and the loop divides by rho, so division must be IEEE and denormals kept.

#include "structured_admm.cuh"

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int kRW = 32;                        // rows of [A_s; A_d] a warp holds, at most
constexpr size_t kMaxSharedBytes = 232448;     // 227 KB: what one block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;

// TC column slots a lane (n <= 32 TC); at most MAXW warps a block (m <= kRW
// MAXW); P threads a row of C in xt = C RHS; MINB blocks an SM for
// __launch_bounds__ (what caps the registers a thread).
template <int TC_, int MAXW_, int P_ = 4, int MINB_ = 1>
struct GenericShape {
  static constexpr int TC = TC_, MAXW = MAXW_, P = P_, MINB = MINB_;
  static_assert(32 % P == 0 && TC >= 1 && MAXW >= 1 && MAXW <= 32, "layout");
};

// Smallest row stride >= x (doubles) that is P mod 2P: the P threads of a
// row and the 16 / P rows of a half-warp then load from 32 distinct banks.
__host__ __device__ inline int pad_c(int x, int P) { return round_up(x + P, 2 * P) - P; }

// Warps a block: enough for the rows (kRW a warp) and for P threads on each
// row of C, at most MAXW.
__host__ __device__ inline int generic_warps(int n, int m, int P, int maxw) {
  return imin(maxw, imax(cdiv(m, kRW), cdiv(P * n, 32)));
}

// Shared memory of one block, byte offsets: C, then the loop's vectors.
struct GenericLayout {
  int n, m_s, m_d, m, nw, rw, ldc, nv;
  size_t c, rhs, x, q, xt, rv, pcol, tile, bytes;
  __host__ __device__ GenericLayout(int n_, int m_s_, int m_d_, int P, int maxw)
      : n(n_), m_s(m_s_), m_d(m_d_), m(m_s_ + m_d_) {
    nw = generic_warps(n, m, P, maxw);
    rw = cdiv(m, nw);                      // rows a warp (at most kRW where the layout holds m)
    ldc = pad_c(n, P);
    nv = round_up(n, 4);
    c = 0;                                                          // C [n, ldc] f64
    rhs = align16(c + size_t(8) * n * ldc);                         // [nv] f64
    x = align16(rhs + size_t(8) * nv);                              // x, q, xt [nv] f32
    q = x + 4 * size_t(nv);
    xt = q + 4 * size_t(nv);
    rv = xt + 4 * size_t(nv);                                       // r, kRW slots a warp
    pcol = rv + 4 * size_t(nw) * kRW;                               // [nw, nv] column partials
    tile = pcol + 4 * size_t(nw) * nv;                              // [nw, 32, kRW + 4] row partials
    bytes = align16(tile + 4 * size_t(nw) * 32 * (kRW + 4));
  }
};

template <class S>
__host__ __device__ GenericLayout layout_of(int n, int m_s, int m_d) {
  return GenericLayout(n, m_s, m_d, S::P, S::MAXW);
}

template <class S>
bool fits(int n, int m_s, int m_d) {
  if (n > 32 * S::TC || cdiv(m_s + m_d, kRW) > S::MAXW) return false;
  return layout_of<S>(n, m_s, m_d).bytes <= kMaxSharedBytes;
}

template <int TC>
__device__ __forceinline__ float dot_tc(const float (&a)[TC], const float (&v)[TC]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < TC; ++c) s = fmaf(a[c], v[c], s);
  return s;
}

template <class S>
__global__ void __launch_bounds__(32 * S::MAXW, S::MINB) generic_kernel(const AdmmArgs a) {
  constexpr int TC = S::TC, RW = kRW, P = S::P;
  const int lane = blockIdx.x;
  if (lane >= a.B) return;
  const int n = a.n, m_s = a.m_s;
  const GenericLayout L = layout_of<S>(n, m_s, a.m_d);
  const int m = L.m, nw = L.nw, rw = L.rw, ldc = L.ldc, nv = L.nv;
  const int T = 32 * nw, tid = threadIdx.x, w = tid / 32, l = tid % 32;

  extern __shared__ double smem[];
  char* base = reinterpret_cast<char*>(smem);
  double* Cm = reinterpret_cast<double*>(base + L.c);
  double* rhs = reinterpret_cast<double*>(base + L.rhs);
  float* x = reinterpret_cast<float*>(base + L.x);
  float* q = reinterpret_cast<float*>(base + L.q);
  float* xt = reinterpret_cast<float*>(base + L.xt);
  float* rv = reinterpret_cast<float*>(base + L.rv) + w * RW;                  // the warp's r
  float* pcol = reinterpret_cast<float*>(base + L.pcol);
  float* tile = reinterpret_cast<float*>(base + L.tile) + w * 32 * (RW + 4);   // the warp's own

  const size_t ln = size_t(lane) * n, ls = size_t(lane) * m_s, ld = size_t(lane) * a.m_d;
  const float* Ad = a.Ad + ld * n;                 // [m_d, n]
  const int row0 = w * rw;                         // the warp's first row
  const int cnt = imax(0, imin(rw, m - row0));     // its rows

  // ---- the lane's C ------------------------------------------------------------
  const double* C = a.C + size_t(lane) * n * n;
  for (int i = tid; i < n * n; i += T) Cm[(i / n) * ldc + i % n] = C[i];

  // ---- the lane's vectors, the row lane l owns (row0 + l) and its state ----------
  for (int j = tid; j < n; j += T) {
    x[j] = a.x0[ln + j];
    q[j] = a.q[ln + j];
  }
  float zr = 0.f, yr = 0.f, lor = 0.f, hir = 0.f, rhor = 1.f, rr = 0.f;
  const int row = row0 + l;
  const bool own = l < cnt, shared_row = row < m_s;
  const size_t k = shared_row ? ls + row : ld + (row - m_s);
  if (own) {
    rhor = shared_row ? a.rho_s[row] : a.rho_d[k];
    zr = (shared_row ? a.zs0 : a.zd0)[k];
    yr = (shared_row ? a.ys0 : a.yd0)[k];
    lor = (shared_row ? a.lbs : a.lbd)[k];
    hir = (shared_row ? a.ubs : a.ubd)[k];
    rr = rhor * zr - yr;
  }
  rv[l] = rr;

  // ---- [A_s; A_d]: the warp's rows, lane l's columns l + 32 c -------------------
  float A[RW][TC];
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int r = row0 + j, col = l + 32 * c;
      float v = 0.f;
      if (j < cnt && col < n) v = r < m_s ? a.A_s[r * n + col] : Ad[size_t(r - m_s) * n + col];
      A[j][c] = v;
    }
  __syncthreads();                                 // C, x, q and r are in place

  const float alpha = a.alpha, beta = 1.0f - a.alpha, sigma = a.sigma;
  for (int it = 0; it < a.iters; ++it) {
    // 1. column partial sums of [A_s; A_d]' r over the warp's rows
    {
      float acc[TC][4];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
      const float4* r4 = reinterpret_cast<const float4*>(rv);
#pragma unroll
      for (int j4 = 0; j4 < RW / 4; ++j4) {
        const float4 r = r4[j4];
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          acc[c][0] = fmaf(A[4 * j4][c], r.x, acc[c][0]);
          acc[c][1] = fmaf(A[4 * j4 + 1][c], r.y, acc[c][1]);
          acc[c][2] = fmaf(A[4 * j4 + 2][c], r.z, acc[c][2]);
          acc[c][3] = fmaf(A[4 * j4 + 3][c], r.w, acc[c][3]);
        }
      }
#pragma unroll
      for (int c = 0; c < TC; ++c)
        if (l + 32 * c < n)
          pcol[w * nv + l + 32 * c] = (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
    }
    __syncthreads();
    // 2. RHS = sigma x - q + [A_s; A_d]' r: the warps' partial sums met
    for (int j = tid; j < n; j += T) {
      float s = 0.f;
      for (int v = 0; v < nw; ++v) s += pcol[v * nv + j];
      rhs[j] = static_cast<double>(sigma * x[j] - q[j] + s);
    }
    __syncthreads();
    // 3. xt = C RHS in float64, P threads a row; x = alpha xt + (1 - alpha) x
    for (int r0 = 0; r0 < n; r0 += T / P) {
      const int r = r0 + tid / P, p = tid % P;
      const double* crow = Cm + imin(r, n - 1) * ldc;
      double s0 = 0.0, s1 = 0.0;
      int j = p;
      for (; j + P < n; j += 2 * P) {
        s0 = fma(crow[j], rhs[j], s0);
        s1 = fma(crow[j + P], rhs[j + P], s1);
      }
      if (j < n) s0 = fma(crow[j], rhs[j], s0);
      double sum = s0 + s1;
#pragma unroll
      for (int o = 1; o < P; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      if (p == 0 && r < n) {
        const float v = static_cast<float>(sum);
        xt[r] = v;
        x[r] = alpha * v + beta * x[r];
      }
    }
    __syncthreads();
    // 4. [A_s; A_d] xt: the lane's RW partial row sums as a row of the warp's tile,
    // read back by columns: lane l sums row l and updates it
    {
      float xc[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) xc[c] = l + 32 * c < n ? xt[l + 32 * c] : 0.f;
      float v[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) v[j] = dot_tc<TC>(A[j], xc);
      float4* t4 = reinterpret_cast<float4*>(tile + l * (RW + 4));
#pragma unroll
      for (int j4 = 0; j4 < RW / 4; ++j4)
        t4[j4] = make_float4(v[4 * j4], v[4 * j4 + 1], v[4 * j4 + 2], v[4 * j4 + 3]);
    }
    __syncwarp();
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) t[i & 3] += tile[i * (RW + 4) + l];
    const float v0 = (t[0] + t[1]) + (t[2] + t[3]);
    if (own) rv[l] = row_update(v0, rhor, lor, hir, alpha, beta, zr, yr);
    __syncwarp();                                  // the tile and r are read by the warp next
  }

  for (int j = tid; j < n; j += T) a.x_out[ln + j] = x[j];
  if (own) {
    (shared_row ? a.zs_out : a.zd_out)[k] = zr;
    (shared_row ? a.ys_out : a.yd_out)[k] = yr;
  }
}

template <class S>
int launch(const AdmmArgs& a, cudaStream_t stream) {
  const GenericLayout L = layout_of<S>(a.n, a.m_s, a.m_d);
  cudaError_t err = cudaFuncSetAttribute(generic_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  generic_kernel<S><<<a.B, 32 * L.nw, L.bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instances, tried in this order: the first that holds a shape runs it.
//                          TC  MAXW  P  MINB
using RegN64 = GenericShape<2, 8, 4, 2>;       // n <= 64, m <= 256: the sweep, run_sim
using RegN64Tall = GenericShape<2, 16>;        // n <= 64, m <= 512: 24 agents

}  // namespace

bool structured_admm_generic_has(int n, int m_s, int m_d) {
  return fits<RegN64>(n, m_s, m_d) || fits<RegN64Tall>(n, m_s, m_d);
}

int structured_admm_generic_launch(const AdmmArgs& a, cudaStream_t stream) {
  if (a.C == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (fits<RegN64>(a.n, a.m_s, a.m_d)) return launch<RegN64>(a, stream);
  if (fits<RegN64Tall>(a.n, a.m_s, a.m_d)) return launch<RegN64Tall>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
