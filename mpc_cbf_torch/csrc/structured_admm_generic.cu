// Structured-ADMM iteration loop for shapes known only at run time, for
// Hopper (sm_90a): the kernel of every shape without an instantiation in
// structured_admm_tiled.cu or structured_admm_folded.cu. The connectivity
// teams of apps/sweep.py ((35 + R, 125 + R, 2R - 2) on 15 R lanes, R = 2..10),
// run_sim's 3-robot connectivity team ((38, 128, 4) on 3 lanes) and the odd
// team sizes of benchmarks/swarm.py (a 24-agent fov team: (59, 143, 276)) run
// it.
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170); what
// one iteration computes is written out in structured_admm.cu.
//
// The numbers that decide the design. At the sweep's largest team (45, 135,
// 18) an iteration is 2 x 153 x 45 = 13 770 float32 multiply-adds and 2 025
// in float64 (the folded form below) for a lane; the launches get 30 to 150
// lanes, fewer than the card's 132 SMs hold twice over, and run_sim gives 3.
// What bounds such a launch is not the card's arithmetic but the chain of
// dependent stages an iteration makes, each behind a block-wide barrier: the
// first version ran eight, each a serial dot product of 35-45 shared-memory
// loads in one thread. The 24-agent fov shape (m = 419) is the other end:
// 49 442 float32 and 3 481 float64 multiply-adds an iteration on 768 lanes.
//
// What this design does about it:
// 1. WK is folded away, as in structured_admm_folded.cu: the prologue builds
//    the lane's C = Ms_inv - WK (A_d Ms_inv) in float64 once a launch on the
//    float64 tensor cores (mma.sync m8n8k4, operands zero-padded to 8 x 8
//    tiles), 32 rows of A_d at a time: G = A_d[k0 ..] Ms_inv, then
//    C -= WK[:, k0 ..] G, with Ms_inv read from device memory (every lane
//    reads the same one: L2). Only C and three small staging tiles are live,
//    and they share the memory that the loop's vectors take after it (2 m_d
//    n^2 multiply-adds a lane: 72 900 at the sweep's largest team, 1.92 M at
//    the 24-agent shape). An iteration is three stages with three block-wide
//    barriers: [A_s; A_d]'r (the warps' column sums met in shared memory:
//    barrier 1, RHS: barrier 2), xt = C RHS (barrier 3), [A_s; A_d] xt with
//    the row updates. C RHS accumulates in float64 (the Woodbury
//    cancellation, structured_admm.cu).
// 2. A warp owns 32 whole rows of [A_s; A_d]; lane l holds columns l, l + 32,
//    ... of them. [A_s; A_d]'r: each lane sums its columns over the warp's
//    rows, r read as broadcast float4 loads. C RHS: P = 4 threads a row of C,
//    met by two shuffles; C's row stride keeps a half-warp's loads on 32
//    banks. [A_s; A_d] xt: the lane's 32 partial row sums meet across the
//    warp through a tile of shared memory (a row of the tile a lane, read
//    back by columns); lane l then updates row l at once, so the row update
//    needs no barrier of its own, and the r it writes is read by its own warp
//    only (__syncwarp).
// 3. [A_s; A_d] in registers where it fits (RegN64: n <= 64, m <= 256, 32 x 2
//    values a thread, two blocks an SM; RegN64Tall up to m = 512), with the
//    row's z, y, bounds and rho in the registers of the lane that owns it.
//    The sweep, run_sim and the 24-agent team take them.
// 4. Larger shapes (FromMemory: n <= 160): C, the vectors and the row state
//    stay in shared memory, and the rows of [A_s; A_d] are read from device
//    memory twice an iteration (A_s is the same for every lane: L2), where
//    the streamed kernel read A_d three times and WK once. It holds every fov
//    and connectivity team that the streamed kernel held and more (fov teams
//    to 84 agents where streamed held 76, connectivity teams to 89 robots
//    where it held 84). A shape no layout here holds (n above 160, or C and
//    the row state of thousands of rows past a block's 227 KB) goes to
//    structured_admm_cluster.cu, one lane on several SMs;
//    structured_admm_variant() decides.
// One lane a block: a NaN lane cannot reach another lane.
// What the card measured, and the layouts tried (16 rows a warp, a
// transposing butterfly of shuffles in place of the tile, threads a row of
// C, each warp forming its own RHS in place of barrier 2), is in PERF.md;
// scripts/admm_kernel_sweep.py --generic times other GenericShape lines.
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
// smallest row stride >= x (doubles) that is 4 mod 8: the 4 x 4 doubles a
// half-warp loads for an mma fragment then fall on 32 distinct banks
__host__ __device__ constexpr int pad_ld(int x) { return round_up(x + 4, 8) - 4; }

constexpr int kKC = 32;                        // rows of A_d the prologue stages at a time
constexpr int kRW = 32;                        // rows of [A_s; A_d] a warp holds (a chunk of them)
constexpr size_t kMaxSharedBytes = 232448;     // 227 KB: what one block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;

// TC column slots a lane (n <= 32 TC); at most MAXW warps a block; REG: the
// lane's [A_s; A_d] in registers (a warp at most kRW rows), else read from
// device memory each iteration; P threads a row
// of C in xt = C RHS; MINB blocks an SM for __launch_bounds__ (what caps the
// registers a thread).
template <int TC_, int MAXW_, bool REG_, int P_ = 4, int MINB_ = 1>
struct GenericShape {
  static constexpr int TC = TC_, MAXW = MAXW_, P = P_, MINB = MINB_;
  static constexpr bool REG = REG_;
  static_assert(32 % P == 0 && TC >= 1 && MAXW >= 1 && MAXW <= 32, "layout");
};

// Smallest row stride >= x (doubles) that is P mod 2P: the P threads of a
// row and the 16 / P rows of a half-warp then load from 32 distinct banks.
__host__ __device__ inline int pad_c(int x, int P) { return round_up(x + P, 2 * P) - P; }

// Warps a block: enough for the rows (kRW a warp with the matrix in
// registers) and for P threads on each row of C, at most MAXW.
__host__ __device__ inline int generic_warps(int n, int m, int P, int maxw) {
  return imin(maxw, imax(cdiv(m, kRW), cdiv(P * n, 32)));
}

// Shared memory of one block, byte offsets: C, then the prologue's staging
// (A_d rows and G [kKC, ldp], WK columns [np, ldk], float64), which the
// loop's vectors and row state (REG false) take over once C is built.
struct GenericLayout {
  int n, m_s, m_d, m, nw, rw, nch, ldc, nv, np, ldp, ldk;
  size_t c, u, rhs, x, q, xt, rv, pcol, tile, state, bytes;
  __host__ __device__ GenericLayout(int n_, int m_s_, int m_d_, int P, int maxw, bool reg)
      : n(n_), m_s(m_s_), m_d(m_d_), m(m_s_ + m_d_) {
    nw = generic_warps(n, m, P, maxw);
    rw = cdiv(m, nw);                      // rows a warp
    nch = cdiv(rw, kRW);                   // chunks of kRW rows a warp (1 with REG)
    ldc = pad_c(n, P);
    nv = round_up(n, 4);
    np = round_up(n, 8);                   // the prologue's matrices, in 8 x 8 tiles
    ldp = pad_ld(np);
    ldk = pad_ld(kKC);
    c = 0;                                                          // C [n, ldc] f64
    u = align16(c + size_t(8) * n * ldc);
    rhs = u;                                                        // [nv] f64
    x = align16(rhs + size_t(8) * nv);                              // x, q, xt [nv] f32
    q = x + 4 * size_t(nv);
    xt = q + 4 * size_t(nv);
    rv = xt + 4 * size_t(nv);                                       // r, kRW slots a warp chunk
    pcol = rv + 4 * size_t(nw) * nch * kRW;                         // [nw, nv] column partials
    tile = pcol + 4 * size_t(nw) * nv;                              // [nw, 32, kRW + 4] row partials
    state = tile + 4 * size_t(nw) * 32 * (kRW + 4);                 // z, y, lo, hi, rho [mv]
    const size_t loop = state + (reg ? 0 : 4 * size_t(5) * round_up(m, 4));
    const size_t pro = u + size_t(8) * (2 * kKC * ldp + size_t(np) * ldk);
    bytes = align16(loop > pro ? loop : pro);
  }
};

template <class S>
__host__ __device__ GenericLayout layout_of(int n, int m_s, int m_d) {
  return GenericLayout(n, m_s, m_d, S::P, S::MAXW, S::REG);
}

template <class S>
bool fits(int n, int m_s, int m_d) {
  const int m = m_s + m_d;
  if (n > 32 * S::TC || (S::REG && cdiv(m, kRW) > S::MAXW)) return false;
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
  constexpr bool REG = S::REG;
  const int lane = blockIdx.x;
  if (lane >= a.B) return;
  const int n = a.n, m_s = a.m_s, m_d = a.m_d;
  const GenericLayout L = layout_of<S>(n, m_s, m_d);
  const int m = L.m, nw = L.nw, rw = L.rw, nch = L.nch, ldc = L.ldc, nv = L.nv;
  const int np = L.np, ldp = L.ldp, ldk = L.ldk;
  const int T = 32 * nw, tid = threadIdx.x, w = tid / 32, l = tid % 32;

  extern __shared__ double smem[];
  char* base = reinterpret_cast<char*>(smem);
  double* Cm = reinterpret_cast<double*>(base + L.c);
  double* rhs = reinterpret_cast<double*>(base + L.rhs);
  float* x = reinterpret_cast<float*>(base + L.x);
  float* q = reinterpret_cast<float*>(base + L.q);
  float* xt = reinterpret_cast<float*>(base + L.xt);
  float* rv = reinterpret_cast<float*>(base + L.rv);
  float* pcol = reinterpret_cast<float*>(base + L.pcol);
  float* tile = reinterpret_cast<float*>(base + L.tile) + w * 32 * (RW + 4);   // the warp's own
  float* st = reinterpret_cast<float*>(base + L.state);   // REG false: z, y, lo, hi, rho
  const int mv = round_up(m, 4);
  float *zs = st, *ys = st + mv, *los = st + 2 * mv, *his = st + 3 * mv, *rhos = st + 4 * mv;

  const size_t ln = size_t(lane) * n, ls = size_t(lane) * m_s, ld = size_t(lane) * m_d;
  const float* Ad = a.Ad + ld * n;                 // [m_d, n]
  const float* WK = a.WK + ln * m_d;               // [n, m_d]
  const int row0 = w * rw;                         // the warp's first row
  const int cnt = imax(0, imin(rw, m - row0));     // its rows

  // ---- prologue: C = Ms_inv - WK (A_d Ms_inv) in float64, kKC rows of A_d at a time
  {
    double* Ac = reinterpret_cast<double*>(base + L.u);   // [kKC, ldp]: A_d[k0 ..], 0 beyond
    double* G = Ac + kKC * ldp;                           // [kKC, ldp]: Ac Ms_inv
    double* Wc = G + kKC * ldp;                           // [np, ldk]: WK[:, k0 ..], 0 beyond
    const float* Mi = a.Ms_inv;
    for (int i = tid; i < n * n; i += T) Cm[(i / n) * ldc + i % n] = static_cast<double>(Mi[i]);
    for (int k0 = 0; k0 < m_d; k0 += kKC) {
      const int kn = imin(kKC, m_d - k0), k8 = round_up(kn, 8);
      __syncthreads();                             // C's first rows, or the last chunk, done
      for (int i = tid; i < k8 * np; i += T) {
        const int kk = i / np, col = i % np;
        Ac[kk * ldp + col] =
            kk < kn && col < n ? static_cast<double>(Ad[size_t(k0 + kk) * n + col]) : 0.0;
      }
      for (int i = tid; i < np * k8; i += T) {
        const int row = i / k8, kk = i % k8;
        Wc[row * ldk + kk] =
            row < n && kk < kn ? static_cast<double>(WK[size_t(row) * m_d + k0 + kk]) : 0.0;
      }
      __syncthreads();
      mma_product(
          k8 / 8, np / 8, cdiv(n, 4), nw, [&](int i, int k) { return Ac[i * ldp + k]; },
          [&](int k, int j) { return k < n && j < n ? static_cast<double>(Mi[k * n + j]) : 0.0; },
          [&](int i, int j, double v) { G[i * ldp + j] = v; });
      __syncthreads();
      mma_product(
          np / 8, np / 8, k8 / 4, nw, [&](int i, int k) { return Wc[i * ldk + k]; },
          [&](int k, int j) { return G[k * ldp + j]; },
          [&](int i, int j, double v) {
            if (i < n && j < n) Cm[i * ldc + j] -= v;
          });
    }
    __syncthreads();                               // C done; the staging is free
  }

  // ---- the lane's vectors and rows --------------------------------------------
  for (int j = tid; j < n; j += T) {
    x[j] = a.x0[ln + j];
    q[j] = a.q[ln + j];
  }
  // row state of the row lane l owns: row0 + RW ch + l
  float zr = 0.f, yr = 0.f, lor = 0.f, hir = 0.f, rhor = 1.f;
  for (int ch = 0; ch < nch; ++ch) {
    const int jr = RW * ch + l, row = row0 + jr;
    float rr = 0.f;
    if (jr < cnt) {
      const bool s = row < m_s;
      const size_t k = s ? ls + row : ld + (row - m_s);
      const float rh = s ? a.rho_s[row] : a.rho_d[k];
      const float zi = (s ? a.zs0 : a.zd0)[k], yi = (s ? a.ys0 : a.yd0)[k];
      const float lo = (s ? a.lbs : a.lbd)[k], hi = (s ? a.ubs : a.ubd)[k];
      rr = rh * zi - yi;
      if constexpr (REG) {
        zr = zi; yr = yi; lor = lo; hir = hi; rhor = rh;
      } else {
        zs[row] = zi; ys[row] = yi; los[row] = lo; his[row] = hi; rhos[row] = rh;
      }
    }
    rv[(w * nch + ch) * RW + l] = rr;
  }

  // ---- [A_s; A_d]: the warp's rows, lane l's columns l + 32 c -------------------
  float A[REG ? RW : 1][TC];
  if constexpr (REG) {
#pragma unroll
    for (int j = 0; j < RW; ++j)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int row = row0 + j, col = l + 32 * c;
        float v = 0.f;
        if (j < cnt && col < n) v = row < m_s ? a.A_s[row * n + col] : Ad[size_t(row - m_s) * n + col];
        A[j][c] = v;
      }
  }
  __syncthreads();                                 // x, q and the row state are in place
  // a row of [A_s; A_d] in device memory, for REG false
  auto row_ptr = [&](int row) -> const float* {
    return row < m_s ? a.A_s + size_t(row) * n : Ad + size_t(row - m_s) * n;
  };

  const float alpha = a.alpha, beta = 1.0f - a.alpha, sigma = a.sigma;
  for (int it = 0; it < a.iters; ++it) {
    // 1. column partial sums of [A_s; A_d]' r over the warp's rows
    {
      float acc[TC][4];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
      if constexpr (REG) {
        const float4* r4 = reinterpret_cast<const float4*>(rv + w * RW);
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
      } else {
        for (int ch = 0; ch < nch; ++ch) {
          const float* r = rv + (w * nch + ch) * RW;
          const int cc = imin(RW, cnt - RW * ch);
          for (int j = 0; j < cc; ++j) {
            const float rj = r[j];
            const float* arow = row_ptr(row0 + RW * ch + j);
#pragma unroll
            for (int c = 0; c < TC; ++c)
              if (l + 32 * c < n) acc[c][j & 3] = fmaf(arow[l + 32 * c], rj, acc[c][j & 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < TC; ++c)
        if (l + 32 * c < n)
          pcol[w * nv + l + 32 * c] = (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
    }
    __syncthreads();
    // 2. RHS = sigma x - q + [A_s; A_d]' r: the warps' partial sums met
    for (int k = tid; k < n; k += T) {
      float s = 0.f;
      for (int v = 0; v < nw; ++v) s += pcol[v * nv + k];
      rhs[k] = static_cast<double>(sigma * x[k] - q[k] + s);
    }
    __syncthreads();
    // 3. xt = C RHS in float64, P threads a row; x = alpha xt + (1 - alpha) x
    for (int r0 = 0; r0 < n; r0 += T / P) {
      const int row = r0 + tid / P, p = tid % P;
      const double* crow = Cm + imin(row, n - 1) * ldc;
      double s0 = 0.0, s1 = 0.0;
      int k = p;
      for (; k + P < n; k += 2 * P) {
        s0 = fma(crow[k], rhs[k], s0);
        s1 = fma(crow[k + P], rhs[k + P], s1);
      }
      if (k < n) s0 = fma(crow[k], rhs[k], s0);
      double sum = s0 + s1;
#pragma unroll
      for (int o = 1; o < P; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
      if (p == 0 && row < n) {
        const float v = static_cast<float>(sum);
        xt[row] = v;
        x[row] = alpha * v + beta * x[row];
      }
    }
    __syncthreads();
    // 4. [A_s; A_d] xt: the warp's rows, met across the warp; row l's update in lane l
    float xc[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) xc[c] = l + 32 * c < n ? xt[l + 32 * c] : 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int cc = imin(RW, cnt - RW * ch);
      // from memory: row j of the chunk times xt (0 beyond the warp's rows)
      auto mem_dot = [&](int j) -> float {
        float s = 0.f;
        if (j < cc) {
          const float* arow = row_ptr(row0 + RW * ch + j);
#pragma unroll
          for (int c = 0; c < TC; ++c)
            if (l + 32 * c < n) s = fmaf(arow[l + 32 * c], xc[c], s);
        }
        return s;
      };
      // the lane's RW partial row sums as a row of the warp's tile, read back by
      // columns: lane l sums row l of the chunk
      {
        float v[RW];
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          if constexpr (REG) v[j] = dot_tc<TC>(A[j], xc);
          else v[j] = mem_dot(j);
        }
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
      __syncwarp();                                  // the tile is written again next
      if (l < cc) {                                  // row row0 + RW ch + l
        float r;
        if constexpr (REG) {
          r = row_update(v0, rhor, lor, hir, alpha, beta, zr, yr);
        } else {
          const int row = row0 + RW * ch + l;
          float z = zs[row], y = ys[row];
          r = row_update(v0, rhos[row], los[row], his[row], alpha, beta, z, y);
          zs[row] = z;
          ys[row] = y;
        }
        rv[(w * nch + ch) * RW + l] = r;
      }
    }
    __syncwarp();
  }

  for (int j = tid; j < n; j += T) a.x_out[ln + j] = x[j];
  for (int ch = 0; ch < nch; ++ch) {
    const int jr = RW * ch + l, row = row0 + jr;
    if (jr < cnt) {
      const bool s = row < m_s;
      const size_t k = s ? ls + row : ld + (row - m_s);
      (s ? a.zs_out : a.zd_out)[k] = REG ? zr : zs[row];
      (s ? a.ys_out : a.yd_out)[k] = REG ? yr : ys[row];
    }
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
//                          TC  MAXW  REG  P  MINB
using RegN64 = GenericShape<2, 8, true, 4, 2>;       // n <= 64, m <= 256: the sweep, run_sim
using RegN64Tall = GenericShape<2, 16, true>;        // n <= 64, m <= 512: 24 agents
using FromMemory = GenericShape<5, 16, false>;       // n <= 160: rows from device memory

}  // namespace

bool structured_admm_generic_has(int n, int m_s, int m_d) {
  return fits<RegN64>(n, m_s, m_d) || fits<RegN64Tall>(n, m_s, m_d) || fits<FromMemory>(n, m_s, m_d);
}

int structured_admm_generic_launch(const AdmmArgs& a, cudaStream_t stream) {
  if (fits<RegN64>(a.n, a.m_s, a.m_d)) return launch<RegN64>(a, stream);
  if (fits<RegN64Tall>(a.n, a.m_s, a.m_d)) return launch<RegN64Tall>(a, stream);
  if (fits<FromMemory>(a.n, a.m_s, a.m_d)) return launch<FromMemory>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
