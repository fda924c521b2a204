// Structured-ADMM iteration loop with one lane a block for a Hopper card
// (sm_90a): the kernel the 32-agent control steps run, fov (n = 67,
// m_s = 151, m_d = 372: a lane fills one SM) and connectivity (36, 126, 62:
// four blocks an SM).
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170); what
// one iteration computes is written out in structured_admm.cu.
//
// The numbers that decide the layout. Per lane and iteration the loop as
// the TPU kernel writes it does 95 006 float32 multiply-adds ([A_s; A_d]'r
// 523 x 67 = 35 041, A_d S 372 x 67 = 24 924, [A_s; A_d] xt 35 041) and
// 29 413 in float64 (Ms_inv RHS 67 x 67 = 4 489, WK t 24 924). One 2048-lane
// chunk of a control step is 550 + 50 + 150 + 50 iterations: 1.64 M
// lane-iterations, 4.65 ms at the 67 TFLOP/s float32 peak as written, 3.43 ms
// for the 70 082 float32 multiply-adds an iteration that the form below
// keeps (the bound the kernel is held against). The lane's A_d is 24 924
// words and its WK as many: A_d fits the 65 536-word register file of an SM
// once, a float64 WK (199 KB) does not fit a block's 227 KB of shared memory
// beside anything else. The kernel this one replaced (the streamed kernel,
// removed since) therefore left both in device memory and read 399 KB a lane
// and iteration: it ran at the rate of L2, 0.6 % of the bound.
//
// What this design does about it:
// 1. The kernel takes the lane's float64 C = (M_s + A_d' R A_d)^-1 [n, n]
//    (36 KB at n = 67), which the caller factors on the device
//    (ops/qp/structured.py::folded_c), in place of WK: xt = C RHS is one
//    product, and A_d S and WK t are gone (49 848 multiply-adds an iteration,
//    4 489 of them float64 from shared memory). C RHS accumulates in float64
//    and skips the float32 rounding of S and t, so it is at least as exact
//    as the Woodbury solve it replaces. C is read once a launch into shared
//    memory.
// 2. The whole stacked matrix [A_s; A_d] (35 041 words) lives in registers:
//    one lane a block, 640 threads, an RG x CG = 80 x 8 grid of TR x TC =
//    7 x 9 tiles (63 registers a thread, 96 in all, no spill). A tile serves
//    both directions: column sums for [A_s; A_d]'r (met across the four row
//    groups of a warp by shuffles, across warps in shared memory) and row
//    sums for [A_s; A_d] xt (met across the eight column groups in shared
//    memory, read back as two 16-byte loads a row). With one lane a block
//    the products with the shared A_s cannot be tiled across lanes as
//    structured_admm_tiled.cu does (two shared-memory loads a multiply-add,
//    about 1 260 clocks an iteration); holding A_s in the same register
//    tiles removes those loads altogether, and A_s is read from device memory
//    (L2) once a block. With A_s left in shared memory and A_d alone in
//    registers (62 x 8 tiles of 6 x 9) a chunk-step measured 41.4 ms against
//    32.9 at 512 threads (PERF.md has every layout tried).
// 3. C RHS: four threads a row of C, each 17 float64 multiply-adds on two
//    accumulators, met by two shuffles; C's row stride of 68 doubles keeps
//    the half-warp's loads on distinct banks.
// Five block-wide barriers an iteration. One lane a block: a lane never
// shares a block, so a NaN lane cannot reach another lane.
// The 32-agent connectivity shape runs the same kernel with 192 threads a
// lane (24 x 8 tiles of 8 x 5) and 22 KB of shared memory, four blocks an SM
// (registers bound it): its C is
// 10 KB a lane where the float64 WK of structured_admm_tiled.cu is 18 KB, and
// independent blocks hide each other's barriers. An instantiation
// of the tiled kernel measured 5.25 ms for that step at its best of eight
// layouts, this one 3.36 ms (PERF.md).
//
// Built without --use_fast_math: inactive dynamic rows carry rho = 1e-12
// and the loop divides by rho, so division must be IEEE and denormals kept.

#include "structured_admm.cuh"

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }
// smallest row stride >= x (in doubles) that is 4 mod 8: the 4 x 4 doubles a
// half-warp loads in C RHS (4 rows, 4 consecutive columns) then fall on 32
// distinct banks
__host__ __device__ constexpr int pad_ld(int x) { return round_up(x + 4, 8) - 4; }

// N, MS, MD: the shape. T threads a block (one lane). The stacked matrix
// [A_s; A_d] [M, N] is cut into an RG x CG grid of register tiles (RG * CG
// <= T, CG a power of two <= 32).
template <int N_, int MS_, int MD_, int T_, int RG_, int CG_>
struct FoldedShape {
  static constexpr int N = N_, MS = MS_, MD = MD_, M = MS + MD, T = T_, RG = RG_, CG = CG_;
  static constexpr int TR = cdiv(M, RG), TC = cdiv(N, CG);
  static constexpr int NW = T / 32;
  static constexpr int K4 = round_up(N, 4);           // the inner dimension of C RHS
  static constexpr int LDC = pad_ld(K4);
  static_assert(T % 32 == 0 && RG * CG <= T && 32 % CG == 0, "thread budget, column groups in a warp");
  static_assert(4 * N <= T, "C RHS: four threads a row");
  // shared memory: doubles first, every array a multiple of 16 bytes
  static constexpr int D_RHS = round_up(N * LDC, 2);
  static constexpr int D_END = D_RHS + round_up(K4, 2);
  static constexpr int MV = round_up(M, 4), NV = round_up(N, 4);
  static constexpr int F_VECS = 6 * MV;                              // after r, z, y, lo, hi, rho [M]: x, q, xt [N]
  static constexpr int F_PCOL = F_VECS + 3 * NV;                     // [NW, N]
  static constexpr int F_PROW = F_PCOL + round_up(NW * N, 4);        // [M, CG]
  static constexpr int F_END = F_PROW + round_up(M * CG, 4);
  static constexpr int BYTES = 8 * D_END + 4 * F_END;
  static_assert(BYTES <= 232448, "a block's 227 KB of shared memory");
  // blocks an SM, for __launch_bounds__: by threads (2048), shared memory (227 KB + 1 KB a
  // block) and registers (the tile and about 40 more a thread)
  static constexpr int MINB = cmax(1, cmin(cmin(2048 / T, 233472 / (BYTES + 1024)),
                                           65536 / (T * (TR * TC + 40))));
};

template <class S>
__global__ void __launch_bounds__(S::T, S::MINB) folded_kernel(const AdmmArgs a) {
  constexpr int N = S::N, MS = S::MS, MD = S::MD, M = S::M, T = S::T, RG = S::RG, CG = S::CG;
  constexpr int TR = S::TR, TC = S::TC, NW = S::NW, K4 = S::K4, LDC = S::LDC;
  const int lane = blockIdx.x;
  if (lane >= a.B) return;
  const int tid = threadIdx.x, warp = tid / 32, t32 = tid % 32;

  extern __shared__ double smem[];
  double* Cm = smem;                               // [N, LDC]: the lane's C, columns N .. K4 zero
  double* rhs = smem + S::D_RHS;                   // [K4], entries N .. K4 zero
  float* fl = reinterpret_cast<float*>(smem + S::D_END);
  float *rv = fl, *z = rv + S::MV, *y = z + S::MV, *lo = y + S::MV, *hi = lo + S::MV,
        *rho = hi + S::MV;                         // [M] each: the shared rows, then the lane's
  float *x = fl + S::F_VECS, *q = x + S::NV, *xt = q + S::NV;
  float* pcol = fl + S::F_PCOL;
  float* prow = fl + S::F_PROW;

  const size_t ln = size_t(lane) * N, ls = size_t(lane) * MS, ld = size_t(lane) * MD;
  const float* Ad = a.Ad + ld * N;                 // [MD, N]
  const double* C = a.C + size_t(lane) * N * N;    // [N, N]

  // ---- the lane's vectors ---------------------------------------------------
  for (int j = tid; j < N; j += T) {
    x[j] = a.x0[ln + j];
    q[j] = a.q[ln + j];
  }
  for (int j = N + tid; j < K4; j += T) rhs[j] = 0.0;
  for (int i = tid; i < M; i += T) {
    const bool s = i < MS;
    const size_t k = s ? ls + i : ld + (i - MS);
    const float rh = s ? a.rho_s[i] : a.rho_d[k];
    const float zi = (s ? a.zs0 : a.zd0)[k], yi = (s ? a.ys0 : a.yd0)[k];
    rho[i] = rh;
    lo[i] = (s ? a.lbs : a.lbd)[k];
    hi[i] = (s ? a.ubs : a.ubd)[k];
    z[i] = zi;
    y[i] = yi;
    rv[i] = rh * zi - yi;
  }

  // ---- the lane's C, columns N .. K4 zero -------------------------------------
  for (int i = tid; i < N * K4; i += T) {
    const int row = i / K4, col = i % K4;
    Cm[row * LDC + col] = col < N ? C[row * N + col] : 0.0;
  }

  // ---- the thread's tile of [A_s; A_d] ---------------------------------------
  const int rg = tid / CG, cg = tid % CG;
  const bool tiled = tid < RG * CG;
  float A[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int row = rg * TR + r, col = cg * TC + c;
      float v = 0.f;
      if (tiled && row < M && col < N) v = row < MS ? a.A_s[row * N + col] : Ad[(row - MS) * N + col];
      A[r][c] = v;
    }
  __syncthreads();

  const float alpha = a.alpha, beta = 1.0f - a.alpha, sigma = a.sigma;
  for (int it = 0; it < a.iters; ++it) {
    // RHS = sigma x - q + [A_s; A_d]' r: column sums of the tiles, met across
    // the row groups of the warp by shuffles, then across warps
    {
      float rr[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int row = rg * TR + r;
        rr[r] = row < M ? rv[row] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < TR; ++r) s = fmaf(A[r][c], rr[r], s);
#pragma unroll
        for (int o = CG; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const int col = cg * TC + c;
        if (t32 < CG && col < N) pcol[warp * N + col] = s;
      }
    }
    __syncthreads();
    if (tid < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += pcol[w * N + tid];
      rhs[tid] = static_cast<double>(sigma * x[tid] - q[tid] + s);
    }
    __syncthreads();
    // xt = C RHS in float64, four threads a row; x = alpha xt + (1 - alpha) x
    if ((tid - t32) / 4 < N) {
      const int row = tid / 4, p = tid % 4;
      const double* crow = Cm + (row < N ? row : N - 1) * LDC + p;
      double s0 = 0.0, s1 = 0.0;
#pragma unroll
      for (int kk = 0; kk + 1 < K4 / 4; kk += 2) {
        s0 = fma(crow[4 * kk], rhs[p + 4 * kk], s0);
        s1 = fma(crow[4 * kk + 4], rhs[p + 4 * kk + 4], s1);
      }
      if constexpr ((K4 / 4) % 2 == 1) s0 = fma(crow[K4 - 4], rhs[p + K4 - 4], s0);
      double s = s0 + s1;
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (p == 0 && row < N) {
        const float v = static_cast<float>(s);
        xt[row] = v;
        x[row] = alpha * v + beta * x[row];
      }
    }
    __syncthreads();
    // [A_s; A_d] xt: row sums of the tiles, met across the column groups in
    // shared memory
    {
      float vc[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = cg * TC + c;
        vc[c] = col < N ? xt[col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < TC; ++c) s = fmaf(A[r][c], vc[c], s);
        const int row = rg * TR + r;
        if (tiled && row < M) prow[row * CG + cg] = s;
      }
    }
    __syncthreads();
    // the z, y and r updates of every row
    for (int i = tid; i < M; i += T) {
      float zA = 0.f;
      const float* pr = prow + i * CG;
      if constexpr (CG % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CG / 4; ++c) {
          const float4 w = reinterpret_cast<const float4*>(pr)[c];
          zA += (w.x + w.y) + (w.z + w.w);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CG; ++c) zA += pr[c];
      }
      rv[i] = row_update(zA, rho[i], lo[i], hi[i], alpha, beta, z[i], y[i]);
    }
    __syncthreads();
  }

  for (int j = tid; j < N; j += T) a.x_out[ln + j] = x[j];
  for (int i = tid; i < M; i += T) {
    const bool s = i < MS;
    const size_t k = s ? ls + i : ld + (i - MS);
    (s ? a.zs_out : a.zd_out)[k] = z[i];
    (s ? a.ys_out : a.yd_out)[k] = y[i];
  }
}

template <class S>
int launch(const AdmmArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(folded_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  folded_kernel<S><<<a.B, S::T, S::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: the 32-agent fov and connectivity control steps.
//                            N   MS   MD    T  RG  CG
using SwarmFov = FoldedShape<67, 151, 372, 640, 80, 8>;       // 71 KB, one block an SM
using SwarmConn = FoldedShape<36, 126, 62, 192, 24, 8>;       // 22 KB, four blocks an SM

template <class S>
bool is_shape(int n, int m_s, int m_d) { return n == S::N && m_s == S::MS && m_d == S::MD; }

}  // namespace

bool structured_admm_folded_has(int n, int m_s, int m_d) {
  return is_shape<SwarmFov>(n, m_s, m_d) || is_shape<SwarmConn>(n, m_s, m_d);
}

int structured_admm_folded_launch(const AdmmArgs& a, cudaStream_t stream) {
  if (is_shape<SwarmFov>(a.n, a.m_s, a.m_d)) return launch<SwarmFov>(a, stream);
  if (is_shape<SwarmConn>(a.n, a.m_s, a.m_d)) return launch<SwarmConn>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
