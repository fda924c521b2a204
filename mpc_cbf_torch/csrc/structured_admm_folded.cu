// Structured-ADMM iteration loop with one lane a block for a Hopper card
// (sm_90a), in the C form: the kernel of the fov flagship (n = 43, m_s =
// 127, m_d = 84: the main path, three lanes an SM) and of the 32-agent
// control steps, fov (67, 151, 372: a lane fills an SM) and connectivity
// (36, 126, 62: four lanes an SM).
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170); what
// one iteration computes is written out in structured_admm.cu.
//
// The numbers that decide the layout. The kernel takes the lane's float64
// C = (M_s + A_d' R A_d)^-1 [n, n], which the caller factors on the device
// (ops/qp/structured.py::folded_c): xt = C RHS is one product. An iteration
// of a 32-agent fov lane is then 70 082 float32 multiply-adds ([A_s; A_d]'r
// and [A_s; A_d] xt, 523 x 67 each) and 4 489 in float64 (C RHS): 548 clocks
// of float32 issue on an SM's 128 lanes. The stacked matrix [A_s; A_d]
// (35 041 words) fits the 65 536-word register file of an SM once; C (36 KB)
// sits in shared memory. With one lane a block the iteration is a chain of
// dependent steps (the column sums feed RHS, RHS feeds xt, xt the row sums,
// those the next r): what costs is the meetings between them and the waits
// that order them, which nothing hides while one lane fills the SM.
//
// What this design does about it:
// 1. [A_s; A_d] in registers: an RG x CG grid of TR x TC tiles, the CG
//    column groups of a row group in adjacent lanes of one warp.
// 2. Rows, their state and their updates in the registers that hold the
//    rows: thread cg of a row group owns row cg of the group (TR <= CG) and
//    keeps its z, y, lo, hi, rho and r in registers, loaded once a launch.
//    The row sums [A_s; A_d] xt meet among the group's CG lanes by a
//    transposing butterfly (CG - 1 shuffles, the first step taken as the
//    sums are formed), which leaves each owner its row's sum; it applies
//    row_update in registers, and the group's threads take the next r from
//    the owners by TR shuffles. No row goes through shared memory, and no
//    barrier orders the updates.
// 3. The column sums [A_s; A_d]'r meet across the warp's row groups by a
//    transposing butterfly too (each step halves the columns a lane keeps),
//    then across warps in shared memory (pcol, a row stride that puts the
//    readers on distinct banks).
// 4. RHS and C RHS on the same N x P threads (the x warps): thread (j, p)
//    sums every P-th warp's partial of column j, the P threads meet by
//    shuffles, and thread (j, 0) forms RHS_j from x_j and q_j, which it keeps
//    in registers; then it is thread (i = j, p) of C RHS, each P-th column of
//    C's row i in float64 on two accumulators, met by shuffles; thread (i, 0)
//    keeps x_i and writes xt_i for the row sums. C's row stride (P mod 2P
//    doubles) keeps a half-warp's loads on distinct banks.
// Three waits an iteration, one of them block-wide: the x warps wait for the
// column partials (the other warps arrive and go on), the x warps wait for
// RHS among themselves (a named barrier of their threads), and every warp
// waits for xt.
// Instances (the last lines; ptxas, NVIDIA H100: no spill in any):
//   SwarmFov   640 threads (9 x warps), 80 x 8 tiles of 7 x 9, 96 registers,
//              43 KB: one block an SM, 4096 lanes in 32 waves (31.03)
//   SwarmConn  192 threads (5 x warps), 24 x 8 tiles of 8 x 5, 80 registers,
//              12 KB: four blocks an SM, 4096 lanes in 8 waves (7.76)
//   Flagship   256 threads (6 x warps), 32 x 8 tiles of 7 x 6, 80 registers,
//              18 KB: three blocks an SM, 8192 lanes in 21 waves (20.69)
// Where several blocks share an SM their waits and meetings hide each
// other's. One lane a block: a lane never shares a block, so a NaN lane
// cannot reach another lane. scripts/admm_kernel_sweep.py --swarm-fov,
// --swarm-conn and --folded-at time other layouts, --stage-clocks the
// stages of an iteration (the STAGE markers).
//
// Built without --use_fast_math: inactive dynamic rows carry rho = 1e-12
// and the loop divides by rho, so division must be IEEE and denormals kept.

#include "structured_admm.cuh"

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }
// columns a lane keeps after k halving steps of the column butterfly
__host__ __device__ constexpr int halved(int x, int k) { return k == 0 ? x : halved(cdiv(x, 2), k - 1); }

constexpr unsigned kFull = 0xffffffffu;

// N, MS, MD: the shape. T threads a block (one lane). The stacked matrix
// [A_s; A_d] [M, N] is cut into an RG x CG grid of register tiles (RG * CG
// <= T, CG a power of two <= 32, at most CG rows a tile: a row of the
// group for each of its threads). P threads a row of C (and a column of
// RHS), N * P <= T.
template <int N_, int MS_, int MD_, int T_, int RG_, int CG_, int P_>
struct FoldedShape {
  static constexpr int N = N_, MS = MS_, MD = MD_, M = MS + MD, T = T_, RG = RG_, CG = CG_;
  static constexpr int P = P_;
  static constexpr int TR = cdiv(M, RG), TC = cdiv(N, CG);
  static constexpr int NW = T / 32;
  static constexpr int NX = cdiv(N * P, 32);                // the x warps: RHS and C RHS
  static constexpr int KC = halved(TC, log2i(32 / CG));     // columns a lane keeps of its tile's
  static constexpr int KP = round_up(N, P);                 // the inner dimension of C RHS
  static constexpr int LDC = round_up(KP + P, 2 * P) - P;   // P mod 2P doubles
  static constexpr int LDP = round_up(N - 32 / P, 32) + 32 / P;   // >= N, 32 / P mod 32
  static_assert(T % 32 == 0 && RG * CG <= T && 32 % CG == 0, "thread budget, column groups in a warp");
  static_assert(TR <= CG && CG >= 2, "a row of the group for each of its threads");
  static_assert(32 % P == 0 && N * P <= T, "P threads a row of C");
  // shared memory: doubles first, every array a multiple of 16 bytes
  static constexpr int D_RHS = round_up(N * LDC, 2);        // C [N, LDC], then RHS [KP]
  static constexpr int D_END = D_RHS + round_up(KP, 2);
  static constexpr int F_PCOL = round_up(CG * TC, 4);       // after xt [CG TC]: pcol [NW, LDP]
  static constexpr int F_END = F_PCOL + round_up(NW * LDP, 4);
  static constexpr int BYTES = 8 * D_END + 4 * F_END;
  static_assert(BYTES <= 232448, "a block's 227 KB of shared memory");
  // blocks an SM, for __launch_bounds__: by threads (2048), shared memory (227 KB + 1 KB a
  // block) and registers (the tile and about 40 more a thread)
  static constexpr int MINB = cmax(1, cmin(cmin(2048 / T, 233472 / (BYTES + 1024)),
                                           65536 / (T * (TR * TC + 40))));
};

// The column sums of the warp's row groups (lane l's part of K columns of its
// tile in v, from column off of the tile): a transposing butterfly over the
// lanes O, O / 2, .. CG apart. At each step a lane keeps half of its columns,
// the upper half if bit O of l is set, and adds the partner's part of them;
// cnt counts the columns kept that the tile has. Afterwards v[0 .. cnt) holds
// whole sums over the warp's rows.
template <int K, int O, int CG>
__device__ __forceinline__ void meet_columns(float* v, int l, int& off, int& cnt) {
  if constexpr (O >= CG) {
    constexpr int H = cdiv(K, 2);
    const bool up = (l & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float top = H + i < K ? v[H + i] : 0.f;
      const float send = up ? v[i] : top;
      const float keep = up ? top : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    off += up ? H : 0;
    cnt = up ? cmax(cnt - H, 0) : cmin(cnt, H);
    meet_columns<H, O / 2, CG>(v, l, off, cnt);
  }
}

// The row sums of a row group (lane cg's part of K rows in v) over the group's
// lanes O = K / 2, .. 1 apart: a transposing butterfly (K - 1 shuffles) after
// which lane cg holds row cg's whole sum.
template <int K, int O = K / 2>
__device__ __forceinline__ float meet_rows(float* v, int cg) {
  if constexpr (K > 1) {
    const bool up = (cg & O) != 0;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float send = up ? v[i] : v[i + K / 2];
      const float keep = up ? v[i + K / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    return meet_rows<K / 2, O / 2>(v, cg);
  } else {
    return v[0];
  }
}

// Column c of the tile times r (0 past the tile's columns), and row i of the
// tile times xt (0 past its rows): one multiply-add at a time, in order.
template <int TR, int TC>
__device__ __forceinline__ float col_part(const float (&A)[TR][TC], const float (&rr)[TR], int c) {
  float s = 0.f;
  if (c < TC)
#pragma unroll
    for (int i = 0; i < TR; ++i) s = fmaf(A[i][cmin(c, TC - 1)], rr[i], s);
  return s;
}
template <int TR, int TC>
__device__ __forceinline__ float row_part(const float (&A)[TR][TC], const float (&xv)[TC], int i) {
  float s = 0.f;
  if (i < TR)
#pragma unroll
    for (int c = 0; c < TC; ++c) s = fmaf(A[cmin(i, TR - 1)][c], xv[c], s);
  return s;
}

// Named barriers: `bar.sync` waits for `count` threads of barrier `id` (its own
// arrival counted), `bar.arrive` counts the thread and goes on. Barrier 0 is
// __syncthreads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <class S>
__global__ void __launch_bounds__(S::T, S::MINB) folded_kernel(const AdmmArgs a) {
  constexpr int N = S::N, MS = S::MS, M = S::M, T = S::T, CG = S::CG, P = S::P;
  constexpr int TR = S::TR, TC = S::TC, NW = S::NW, NX = S::NX, KC = S::KC, KP = S::KP;
  constexpr int LDC = S::LDC, LDP = S::LDP;
  const int lane = blockIdx.x;
  if (lane >= a.B) return;
  const int tid = threadIdx.x, warp = tid / 32, t32 = tid % 32;

  extern __shared__ double smem[];
  double* Cm = smem;                               // [N, LDC]: the lane's C, columns N .. KP zero
  double* rhs = smem + S::D_RHS;                   // [KP], entries N .. KP zero
  float* fl = reinterpret_cast<float*>(smem + S::D_END);
  float* xt = fl;                                  // [CG TC], entries N .. zero
  float* pcol = fl + S::F_PCOL;                    // [NW, LDP]: the warps' column sums

  const size_t ln = size_t(lane) * N, ls = size_t(lane) * MS, ld = size_t(lane) * S::MD;
  const float* Ad = a.Ad + ld * N;                 // [MD, N]

  // ---- the thread's row (row cg of its group) and its state ---------------------
  const int rg = tid / CG, cg = tid % CG, row = rg * TR + cg;
  const bool owner = cg < TR && row < M;           // past RG CG threads: row >= M
  float z = 0.f, y = 0.f, lo = 0.f, hi = 0.f, rho = 1.f, r = 0.f;
  if (owner) {
    const bool s = row < MS;
    const size_t k = s ? ls + row : ld + (row - MS);
    rho = s ? a.rho_s[row] : a.rho_d[k];
    lo = (s ? a.lbs : a.lbd)[k];
    hi = (s ? a.ubs : a.ubd)[k];
    z = (s ? a.zs0 : a.zd0)[k];
    y = (s ? a.ys0 : a.yd0)[k];
    r = rho * z - y;
  }
  // ---- the thread's column of RHS and row of C: (xj, xp); x and q at xp = 0 -------
  const int xj = cmin(tid / P, N - 1), xp = tid % P;
  const bool xhead = xp == 0 && tid < N * P;
  float xv = 0.f, qv = 0.f;
  if (xhead) {
    xv = a.x0[ln + xj];
    qv = a.q[ln + xj];
  }

  // ---- the lane's C, columns N .. KP zero; the zero tails of RHS and xt ------------
  const double* C = a.C + size_t(lane) * N * N;    // [N, N]
  for (int i = tid; i < N * KP; i += T) {
    const int i_row = i / KP, col = i % KP;
    Cm[i_row * LDC + col] = col < N ? C[i_row * N + col] : 0.0;
  }
  for (int j = N + tid; j < KP; j += T) rhs[j] = 0.0;
  for (int j = N + tid; j < CG * TC; j += T) xt[j] = 0.f;

  // ---- the thread's tile of [A_s; A_d] ---------------------------------------
  const bool tiled = tid < S::RG * CG;
  float A[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int arow = rg * TR + i, col = cg * TC + c;
      float v = 0.f;
      if (tiled && arow < M && col < N)
        v = arow < MS ? a.A_s[arow * N + col] : Ad[(arow - MS) * N + col];
      A[i][c] = v;
    }
  __syncthreads();

  const float alpha = a.alpha, beta = 1.0f - a.alpha, sigma = a.sigma;
  STAGE_START;
  for (int it = 0; it < a.iters; ++it) {
    // (a) RHS = sigma x - q + [A_s; A_d]' r: the tile's column sums of r, met
    // across the warp's row groups, then the warp's partials into pcol
    {
      float rr[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) rr[i] = __shfl_sync(kFull, r, i, CG);
      // the first step of the butterfly (lanes 16 apart) as the sums are formed, columns
      // c and c + H at a time
      constexpr int H = CG <= 16 ? cdiv(TC, 2) : TC;
      float v[H];
      int off = 0, cnt = TC;
      if constexpr (CG <= 16) {
        const bool up = (t32 & 16) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float lo_c = col_part(A, rr, i), hi_c = col_part(A, rr, H + i);
          v[i] = (up ? hi_c : lo_c) + __shfl_xor_sync(kFull, up ? lo_c : hi_c, 16);
        }
        off = up ? H : 0;
        cnt = up ? TC - H : H;
      } else {
#pragma unroll
        for (int c = 0; c < TC; ++c) v[c] = col_part(A, rr, c);
      }
      meet_columns<H, 8, CG>(v, t32, off, cnt);
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        const int col = cg * TC + off + i;
        if (i < cnt && col < N) pcol[warp * LDP + col] = v[i];
      }
    }
    STAGE(0);
    if (warp >= NX) {
      // not an x warp: the partials are in place, on to xt
      bar_arrive(1, T);
      STAGE(1);
    } else {
      bar_sync(1, T);
      STAGE(1);
      // (b) RHS_j: every P-th warp's partial, met across the P threads of column j
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < cdiv(NW, P); ++k) {
        const int w = xp + P * k;
        if (w < NW) s += pcol[w * LDP + xj];
      }
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (xhead) rhs[xj] = static_cast<double>(sigma * xv - qv + s);
      STAGE(2);
      bar_sync(2, 32 * NX);
      STAGE(3);
      // (c) xt = C RHS in float64, P threads a row; x = alpha xt + (1 - alpha) x
      const double* crow = Cm + xj * LDC + xp;
      const double* rp = rhs + xp;
      double s0 = 0.0, s1 = 0.0;
#pragma unroll
      for (int k = 0; k + 1 < KP / P; k += 2) {
        s0 = fma(crow[P * k], rp[P * k], s0);
        s1 = fma(crow[P * k + P], rp[P * k + P], s1);
      }
      if constexpr ((KP / P) % 2 == 1) s0 = fma(crow[KP - P], rp[KP - P], s0);
      double sd = s0 + s1;
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) sd += __shfl_xor_sync(kFull, sd, o);
      if (xhead) {
        const float v = static_cast<float>(sd);
        xt[xj] = v;
        xv = alpha * v + beta * xv;
      }
      STAGE(4);
    }
    __syncthreads();
    STAGE(5);
    // (d) [A_s; A_d] xt: the tile's row sums, met in the row group; the owner
    // updates its row in registers
    {
      float vc[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) vc[c] = xt[cg * TC + c];
      // the first step of the butterfly (lanes CG / 2 apart) as the sums are formed, rows i
      // and i + CG / 2 at a time
      constexpr int H = CG / 2;
      const bool up = (cg & H) != 0;
      float v[H];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float lo_r = row_part(A, vc, i), hi_r = row_part(A, vc, i + H);
        v[i] = (up ? hi_r : lo_r) + __shfl_xor_sync(kFull, up ? lo_r : hi_r, H);
      }
      const float zA = meet_rows<H>(v, cg);
      STAGE(6);
      if (owner) r = row_update(zA, rho, lo, hi, alpha, beta, z, y);
    }
    STAGE(8);
  }
  STAGE_END;

  if (xhead) a.x_out[ln + xj] = xv;
  if (owner) {
    const bool s = row < MS;
    const size_t k = s ? ls + row : ld + (row - MS);
    (s ? a.zs_out : a.zd_out)[k] = z;
    (s ? a.ys_out : a.yd_out)[k] = y;
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

// The instantiations: the 32-agent fov and connectivity control steps and the fov flagship,
// each a shape that takes this kernel (a shape of the tiled kernel's is taken there first).
//                               N   MS   MD    T   RG  CG  P
using SwarmFov = FoldedShape<67, 151, 372, 640, 80, 8, 4>;
using SwarmConn = FoldedShape<36, 126, 62, 192, 24, 8, 4>;
using Flagship = FoldedShape<43, 127, 84, 256, 32, 8, 4>;

template <class S>
bool is_shape(int n, int m_s, int m_d) { return n == S::N && m_s == S::MS && m_d == S::MD; }

}  // namespace

bool structured_admm_folded_has(int n, int m_s, int m_d) {
  return is_shape<SwarmFov>(n, m_s, m_d) || is_shape<SwarmConn>(n, m_s, m_d) ||
         is_shape<Flagship>(n, m_s, m_d);
}

int structured_admm_folded_launch(const AdmmArgs& a, cudaStream_t stream) {
  if (is_shape<SwarmFov>(a.n, a.m_s, a.m_d)) return launch<SwarmFov>(a, stream);
  if (is_shape<SwarmConn>(a.n, a.m_s, a.m_d)) return launch<SwarmConn>(a, stream);
  if (is_shape<Flagship>(a.n, a.m_s, a.m_d)) return launch<Flagship>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef ADMM_STAGE_CLOCKS
// The stage clocks into host[0 .. kStageSlots), then zeroes them
// (scripts/admm_kernel_sweep.py).
extern "C" int structured_admm_folded_stage_clocks(unsigned long long* host) {
  return read_stage_clocks(host);
}
#endif
