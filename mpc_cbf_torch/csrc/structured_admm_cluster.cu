// Structured-ADMM iteration loop for lanes too large for one SM, for Hopper
// (sm_90a): one lane runs on a thread-block cluster of cs = 2, 4 or 8 blocks
// on neighbouring SMs, which read each other's shared memory (distributed
// shared memory) and meet at the cluster's hardware barrier. The kernel of
// every shape that no layout of structured_admm_tiled.cu, _folded.cu or
// _generic.cu holds: the fov teams of benchmarks/swarm.py from 85 agents
// ((35 + A, 119 + A, 12 (A - 1)): (120, 204, 1008) at 85, (163, 247, 1524) at
// 128, (291, 375, 3060) at 256) and the connectivity teams of apps/sweep.py
// and run_sim from 90 robots ((35 + R, 125 + R, 2R - 2)).
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170); what
// one iteration computes is written out in structured_admm.cu.
//
// The numbers that decide the design. At the 128-agent fov team a lane's
// stacked matrix [A_s; A_d] is 1771 x 163 float32 words (1.15 MB) and its
// folded float64 C = (I - WK A_d) Ms_inv 214 KB: neither fits the 227 KB of
// shared memory one block may have, which is where generic.cu's largest
// layout stops (n = 160, or C and the row state of a lane within one block).
// An iteration is 2 x 1771 x 163 = 577 k float32 multiply-adds and 26.6 k
// in float64 a lane. Read from device memory twice an iteration, as
// generic's FromMemory layout reads its rows, the rows of 512 lanes over
// the 800 iterations of a control step are 943 GB: >= 281 ms at 3.35 TB/s,
// against the 7.1 ms the card's arithmetic allows. Spread over 8 blocks the
// same lane is 144 KB of rows and 27 KB of C a block: it fits on chip.
//
// What this design does about it:
// 1. The folded form of generic.cu: C is built once a launch in float64 on
//    the float64 tensor cores (mma.sync m8n8k4), and an iteration is
//    [A_s; A_d]'r in float32, xt = C RHS in float64, [A_s; A_d] xt and the
//    row updates in float32 (the Woodbury cancellation, structured_admm.cu).
//    Block k of the cluster owns the rows [k n / cs, (k + 1) n / cs) of C
//    and builds them alone: H = WK[rows] A_d (the lane's A_d and WK staged
//    through shared memory as float32, 64, 32 or 16 rows of A_d at a time),
//    then C[rows] = Ms_inv[rows] - H Ms_inv, so the cluster does n m_d n + n^3
//    multiply-adds a lane and no block repeats another's.
// 2. Block k also owns the rows [k m / cs, (k + 1) m / cs) of [A_s; A_d]
//    with their z, y, bounds and rho. An iteration has two cluster barriers:
//    (a) each block forms its partial [A_s; A_d]'r over its rows (lane l of
//        a warp sums columns l + 32 c over the warp's 32-row chunks; the
//        warps' sums met in the block's shared memory);
//    -- cluster barrier --
//    (b) each block sums the cs partials of every column, in rank order,
//        by reading the other blocks' shared memory, forms the whole RHS
//        and its rows of xt = C RHS (8 threads a row), and writes them into
//        every block's copy of xt;
//    -- cluster barrier --
//    (c) each block updates its copy of x (every block holds the same x)
//        and forms its rows of [A_s; A_d] xt with their row updates (lane l
//        of a warp takes row l of the warp's chunk whole).
//    A partial is rewritten, and a block's rows of xt written again, only
//    after the next barrier, by which time every reader has read them.
// 3. Where the rows live (the template flag ROWS): in the cluster's shared
//    memory where they fit cs x 227 KB beside C and the row state (the fov
//    teams to 146 agents, connectivity to 256 robots), else read from device
//    memory twice an iteration (A_s is the same for every lane: L2; in (c)
//    lane l then takes columns l + 32 c of the chunk's rows, coalesced, and
//    the row sums meet by a transposing butterfly of shuffles).
//    Of the layouts in kLayouts below the first that holds a shape runs it:
//    rows on chip with 2, 4, then 8 blocks, then rows from memory with 2, 4,
//    then 8 (8 is the portable maximum of a cluster).
// What bounds it: (a) and (c) each read the block's rows from shared memory
// once, 222 x 163 = 36 k words at the 128-agent fov lane on 8 blocks, at
// least 1.1 k clocks at 32 words a clock; and every iteration waits at two
// cluster barriers and once on reads of other blocks' memory. The time of
// an iteration is in PERF.md (chip_smoke.py's per-iteration column).
// One lane a cluster: a NaN lane cannot reach another lane.
// scripts/admm_kernel_sweep.py --cluster times other kLayouts lines.
//
// Built without --use_fast_math: inactive dynamic rows carry rho = 1e-12
// and the loop divides by rho, so division must be IEEE and denormals kept.

#include <cooperative_groups.h>

#include "structured_admm.cuh"

namespace cg = cooperative_groups;

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// smallest row stride >= x (doubles) that is 4 mod 8: the 4 x 4 doubles a
// half-warp loads for an mma fragment then fall on 32 distinct banks
__host__ __device__ constexpr int pad_ld(int x) { return round_up(x + 4, 8) - 4; }
// smallest row stride >= x (floats) that is r mod 32 (r = 8: the 4 rows x 8
// columns of an mma B fragment fall on 32 distinct banks; r = 4: the 8 rows x
// 4 columns of an A fragment)
__host__ __device__ constexpr int pad_f(int x, int r) { return round_up(x - r, 32) + r; }

constexpr int kP = 8;                          // threads a row of C in xt = C RHS
static_assert(kP >= 8, "the threads of a row write its xt into each of up to 8 blocks");
constexpr int kSlots = 4;                      // column slots of 32 a lane copies at a time
constexpr size_t kMaxSharedBytes = 232448;     // 227 KB: what one block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;

// First row of part k of `count` rows split into cs parts (parts differ by
// at most one row).
__host__ __device__ inline int part_start(int count, int cs, int k) { return k * count / cs; }

// Smallest row stride >= x (doubles) that is kP mod 2 kP: the kP threads of
// a row and the 16 / kP rows of a half-warp then load from 32 distinct banks.
__host__ __device__ constexpr int pad_c(int x) { return round_up(x + kP, 2 * kP) - kP; }

// Shared memory of one block, byte offsets: C, then the loop's vectors, row
// state and (ROWS) rows, which the prologue's staging overlaps before they
// are loaded: H [hb, ldp] float64, kc rows of A_d [kc, ldpf] and the WK
// columns [hb, ldk] as float32. kc (64, 32 or 16 rows of A_d a step) is the
// largest with which H holds all the block's rows of C at once, else 16.
// The rows' stride lda is odd: a warp whose lanes read one row each, at the
// same column, reads 32 distinct banks.
struct ClusterLayout {
  int n, m_s, m_d, m, cs, rows, crows, nw, nv, np, ldp, ldpf, ldk, kc, ldc, lda, hb;
  size_t c, rhs, x, q, xtf, pcol, pw, rv, st, a, loop, bytes;
  __host__ __device__ ClusterLayout(int n_, int m_s_, int m_d_, int cs_, bool on_chip)
      : n(n_), m_s(m_s_), m_d(m_d_), m(m_s_ + m_d_), cs(cs_) {
    rows = cdiv(m, cs);                    // rows of [A_s; A_d] a block, at most
    crows = cdiv(n, cs);                   // rows of C a block, at most
    nw = imin(16, imax(4, cdiv(rows, 32)));
    nv = round_up(n, 4);
    np = round_up(n, 8);                   // the prologue's matrices, in 8 x 8 tiles
    ldp = pad_ld(np);
    ldpf = pad_f(np, 8);
    ldc = pad_c(n);
    lda = n | 1;
    const int rv4 = round_up(rows, 4);
    c = 0;                                                        // C [crows, ldc] f64
    rhs = align16(c + size_t(8) * crows * ldc);                   // RHS [nv] f32
    x = rhs + size_t(4) * nv;                                     // x, q, xt [nv] f32
    q = x + size_t(4) * nv;
    xtf = q + size_t(4) * nv;
    pcol = xtf + size_t(4) * nv;                                  // the block's partial [nv]
    pw = pcol + size_t(4) * nv;                                   // the warps' partials [nw, nv]
    rv = pw + size_t(4) * nw * nv;                                // r = rho z - y [rv4]
    st = rv + size_t(4) * rv4;                                    // z, y, lo, hi, rho [rv4]
    a = st + size_t(4) * 5 * rv4;                                 // ROWS: rows [rv4, lda]
    loop = a + (on_chip ? size_t(4) * rv4 * lda : 0);
    // the prologue's staging after C: as many rows of H at a time as fit, a multiple of 8
    size_t pro = 0;
    for (kc = 64;; kc /= 2) {
      ldk = pad_f(kc, 4);
      const size_t fixed = rhs + size_t(4) * kc * ldpf;
      const size_t per8 = size_t(8) * (size_t(8) * ldp + size_t(4) * ldk);
      const size_t room = fixed < kMaxSharedBytes ? kMaxSharedBytes - fixed : 0;
      hb = imin(round_up(crows, 8), static_cast<int>(room / per8) * 8);
      pro = fixed + per8 / 8 * hb;
      if (hb == round_up(crows, 8) || kc == 16) break;
    }
    bytes = align16(loop > pro ? loop : pro);
  }
  __host__ __device__ bool fits() const { return hb >= 8 && bytes <= kMaxSharedBytes; }
};

struct ClusterChoice {
  int cs;
  bool on_chip;
};

// dst_row(r)[c] = src_row(r)[c] for r < R, c < C, and 0 where c >= C_in or
// src_row(r) is null. The block's warps take two rows at a time, the lanes
// kSlots columns of each: 2 kSlots loads are in flight before a thread stores.
template <class Src, class Dst>
__device__ __forceinline__ void copy_rows(int R, int C, int C_in, Src src_row, Dst dst_row) {
  const int nw = blockDim.x / 32, w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int r0 = w; r0 < R; r0 += 2 * nw) {
    const float* s[2] = {src_row(r0), r0 + nw < R ? src_row(r0 + nw) : nullptr};
    for (int c0 = l; c0 < C; c0 += 32 * kSlots) {
      float v[2][kSlots];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const int c = c0 + 32 * u;
          v[h][u] = s[h] != nullptr && c < C_in ? s[h][c] : 0.f;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const int r = r0 + h * nw, c = c0 + 32 * u;
          if (r < R && c < C) dst_row(r)[c] = v[h][u];
        }
    }
  }
}

// One round of a transposing butterfly over the warp: v[0 .. 2S) are partial
// sums of 2S rows; after it v[0 .. S) hold the half of them that bit S of the
// lane selects, each plus the partner lane's partial of the same row. After
// the rounds 16, 8, 4, 2, 1, v[0] of lane l is the sum of row l over the warp.
template <int S>
__device__ __forceinline__ void butterfly_round(float (&v)[32], int l) {
  const bool up = l & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = up ? v[i] : v[i + S];
    const float keep = up ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

// One lane a cluster of cs blocks (grid: B cs blocks, cluster: cs); ROWS:
// the block's rows of [A_s; A_d] in shared memory, else read from device
// memory each iteration.
template <bool ROWS>
__global__ void __launch_bounds__(512) cluster_kernel(const AdmmArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / cs;                 // grid = B cs: every cluster is a lane
  const int n = a.n, m_s = a.m_s, m_d = a.m_d;
  const ClusterLayout L(n, m_s, m_d, cs, ROWS);
  const int m = L.m, nw = L.nw, nv = L.nv, np = L.np, ldp = L.ldp, ldk = L.ldk, ldc = L.ldc;
  const int lda = L.lda, ldpf = L.ldpf;
  const int T = 32 * nw, tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int rb = part_start(m, cs, k), rows = part_start(m, cs, k + 1) - rb;   // its rows
  const int cb = part_start(n, cs, k), nc = part_start(n, cs, k + 1) - cb;     // its rows of C
  const int nch = cdiv(rows, 32);                   // chunks of 32 rows, chunk ch to warp ch % nw

  extern __shared__ double smem[];
  char* base = reinterpret_cast<char*>(smem);
  double* Cm = reinterpret_cast<double*>(base + L.c);        // [nc, ldc]
  float* rhs = reinterpret_cast<float*>(base + L.rhs);       // f32 values, used in float64
  float* x = reinterpret_cast<float*>(base + L.x);
  float* q = reinterpret_cast<float*>(base + L.q);
  float* xtf = reinterpret_cast<float*>(base + L.xtf);       // xt, each block's rows written by it
  float* pcol = reinterpret_cast<float*>(base + L.pcol);     // its partial [A_s; A_d]'r, published
  float* pw = reinterpret_cast<float*>(base + L.pw);
  float* rv = reinterpret_cast<float*>(base + L.rv);
  const int rv4 = round_up(L.rows, 4);
  float* zs = reinterpret_cast<float*>(base + L.st);
  float *ys = zs + rv4, *los = zs + 2 * rv4, *his = zs + 3 * rv4, *rhos = zs + 4 * rv4;
  float* As = reinterpret_cast<float*>(base + L.a);          // ROWS: [rows, lda]

  const size_t ln = size_t(lane) * n, ls = size_t(lane) * m_s, ld = size_t(lane) * m_d;
  const float* Ad = a.Ad + ld * n;                 // [m_d, n]
  const float* WK = a.WK + ln * m_d;               // [n, m_d]
  const float* Mi = a.Ms_inv;

  // ---- prologue: C[cb ..] = Ms_inv[cb ..] - (WK[cb ..] A_d) Ms_inv in float64 ----------------
  const int kc = L.kc;
  for (int h0 = 0; h0 < nc; h0 += L.hb) {
    const int hn = imin(L.hb, nc - h0), hn8 = round_up(hn, 8);
    double* H = reinterpret_cast<double*>(base + L.rhs);    // [hn8, ldp]
    float* Ac = reinterpret_cast<float*>(H + size_t(L.hb) * ldp);   // [kc, ldpf]: A_d[k0 ..]
    float* Wc = Ac + size_t(kc) * ldpf;                     // [hn8, ldk]: WK[rows, k0 ..]
    for (int i = tid; i < hn8 * ldp; i += T) H[i] = 0.0;
    for (int k0 = 0; k0 < m_d; k0 += kc) {
      const int kn = imin(kc, m_d - k0), k4 = round_up(kn, 4);
      __syncthreads();                             // H zeroed, or the last chunk consumed
      copy_rows(
          k4, np, n, [&](int kk) { return kk < kn ? Ad + size_t(k0 + kk) * n : nullptr; },
          [&](int kk) { return Ac + size_t(kk) * ldpf; });
      copy_rows(
          hn8, k4, kn,
          [&](int row) { return row < hn ? WK + size_t(cb + h0 + row) * m_d + k0 : nullptr; },
          [&](int row) { return Wc + size_t(row) * ldk; });
      __syncthreads();
      mma_product(
          hn8 / 8, np / 8, k4 / 4, nw,
          [&](int i, int kk) { return static_cast<double>(Wc[i * ldk + kk]); },
          [&](int kk, int j) { return static_cast<double>(Ac[kk * ldpf + j]); },
          [&](int i, int j, double v) { H[i * ldp + j] += v; });
    }
    __syncthreads();
    mma_product(
        hn8 / 8, np / 8, cdiv(n, 4), nw, [&](int i, int kk) { return H[i * ldp + kk]; },
        [&](int kk, int j) { return kk < n && j < n ? static_cast<double>(Mi[kk * n + j]) : 0.0; },
        [&](int i, int j, double v) {
          if (i < hn && j < n)
            Cm[(h0 + i) * ldc + j] = static_cast<double>(Mi[(cb + h0 + i) * n + j]) - v;
        });
    __syncthreads();                               // H is staged again, or the loop takes it
  }

  // ---- the lane's vectors, its rows and their state ------------------------------------------
  for (int j = tid; j < n; j += T) {
    x[j] = a.x0[ln + j];
    q[j] = a.q[ln + j];
  }
  for (int i = tid; i < rv4; i += T) {
    float rr = 0.f;
    if (i < rows) {
      const int row = rb + i;
      const bool s = row < m_s;
      const size_t kk = s ? ls + row : ld + (row - m_s);
      const float rh = s ? a.rho_s[row] : a.rho_d[kk];
      const float zi = (s ? a.zs0 : a.zd0)[kk], yi = (s ? a.ys0 : a.yd0)[kk];
      zs[i] = zi;
      ys[i] = yi;
      los[i] = (s ? a.lbs : a.lbd)[kk];
      his[i] = (s ? a.ubs : a.ubd)[kk];
      rhos[i] = rh;
      rr = rh * zi - yi;
    }
    rv[i] = rr;                                    // 0 past the rows: the float4 loads below
  }
  // row i of the block's rows of [A_s; A_d] in device memory; whether rows i .. i + cnt
  // lie on both sides of A_s's last row (then they are not one run of stride n)
  auto row_ptr = [&](int i) -> const float* {
    const int row = rb + i;
    return row < m_s ? a.A_s + size_t(row) * n : Ad + size_t(row - m_s) * n;
  };
  auto straddles = [&](int i, int cnt) { return rb + i < m_s && rb + i + cnt > m_s; };
  if constexpr (ROWS) {
    copy_rows(
        rv4, n, n, [&](int i) { return i < rows ? row_ptr(i) : nullptr; },
        [&](int i) { return As + size_t(i) * lda; });
  }
  cluster.sync();                                  // every block of the lane runs; all in place

  const float alpha = a.alpha, beta = 1.0f - a.alpha, sigma = a.sigma;
  for (int it = 0; it < a.iters; ++it) {
    // (a) the warps' column sums of [A_s; A_d]'r over their chunks, met in the block. The
    // rows of a chunk are base + j stride (past its last row: that row again, times r = 0),
    // so that every load of a step is issued before its multiply-adds wait
    for (int col = l; col < n; col += 32) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int ch = w; ch < nch; ch += nw) {
        const int j0 = 32 * ch, cnt = imin(32, rows - j0), c4 = round_up(cnt, 4);
        const float4* r4 = reinterpret_cast<const float4*>(rv + j0);
        if (!ROWS && straddles(j0, cnt)) {
          for (int j = 0; j < cnt; ++j) s0 = fmaf(row_ptr(j0 + j)[col], rv[j0 + j], s0);
          continue;
        }
        const float* base = (ROWS ? As + size_t(j0) * lda : row_ptr(j0)) + col;
        const size_t stride = ROWS ? lda : n;
        const int last = cnt - 1;
#pragma unroll 4
        for (int j = 0; j < c4; j += 4) {
          const float4 r = r4[j / 4];
          s0 = fmaf(base[j * stride], r.x, s0);
          s1 = fmaf(base[imin(j + 1, last) * stride], r.y, s1);
          s2 = fmaf(base[imin(j + 2, last) * stride], r.z, s2);
          s3 = fmaf(base[imin(j + 3, last) * stride], r.w, s3);
        }
      }
      pw[w * nv + col] = (s0 + s1) + (s2 + s3);
    }
    __syncthreads();
    for (int j = tid; j < n; j += T) {
      float s = 0.f;
      for (int v = 0; v < nw; ++v) s += pw[v * nv + j];
      pcol[j] = s;
    }
    cluster.sync();                                // every block's partial is published
    // (b) RHS = sigma x - q + the blocks' partials in rank order; its rows of xt = C RHS
    for (int j = tid; j < n; j += T) {
      float s = 0.f;
      for (int b = 0; b < cs; ++b) s += cluster.map_shared_rank(pcol, b)[j];
      rhs[j] = sigma * x[j] - q[j] + s;
    }
    __syncthreads();
    for (int r0 = 0; r0 < nc; r0 += T / kP) {
      const int row = r0 + tid / kP, p = tid % kP;
      const double* crow = Cm + size_t(imin(row, nc - 1)) * ldc;
      double s0 = 0.0, s1 = 0.0;
      int c = p;
      for (; c + kP < n; c += 2 * kP) {
        s0 = fma(crow[c], static_cast<double>(rhs[c]), s0);
        s1 = fma(crow[c + kP], static_cast<double>(rhs[c + kP]), s1);
      }
      if (c < n) s0 = fma(crow[c], static_cast<double>(rhs[c]), s0);
      double s = s0 + s1;
#pragma unroll
      for (int o = 1; o < kP; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
      // the row's kP threads hold the sum: thread p writes it into block p's copy of xt
      if (row < nc && p < cs) cluster.map_shared_rank(xtf, p)[cb + row] = static_cast<float>(s);
    }
    cluster.sync();                                // every block's rows of xt are in every block
    // (c) relax x, then the block's rows of [A_s; A_d] xt and their updates
    for (int j = tid; j < n; j += T) x[j] = alpha * xtf[j] + beta * x[j];
    __syncthreads();
    for (int ch = w; ch < nch; ch += nw) {
      const int j0 = 32 * ch, cnt = imin(32, rows - j0);
      if constexpr (ROWS) {                        // lane l takes row j0 + l whole
        if (l < cnt) {
          const int i = j0 + l;
          const float* arow = As + size_t(i) * lda;
          const float4* x4 = reinterpret_cast<const float4*>(xtf);
          float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
          int c = 0;
#pragma unroll 4
          for (; c + 4 <= n; c += 4) {
            const float4 xv = x4[c / 4];
            s0 = fmaf(arow[c], xv.x, s0);
            s1 = fmaf(arow[c + 1], xv.y, s1);
            s2 = fmaf(arow[c + 2], xv.z, s2);
            s3 = fmaf(arow[c + 3], xv.w, s3);
          }
          for (; c < n; ++c) s0 = fmaf(arow[c], xtf[c], s0);
          float z = zs[i], y = ys[i];
          rv[i] = row_update((s0 + s1) + (s2 + s3), rhos[i], los[i], his[i], alpha, beta, z, y);
          zs[i] = z;
          ys[i] = y;
        }
      } else {
        // rows in device memory: lane l takes columns l + 32 c of the 32 rows (coalesced), and
        // the partial sums meet by a butterfly
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = 0.f;
        const int last = cnt - 1;                  // past it: that row again, never used
        if (straddles(j0, cnt)) {
          for (int col = l; col < n; col += 32) {
            const float xc = xtf[col];
#pragma unroll
            for (int j = 0; j < 32; ++j) v[j] = fmaf(row_ptr(j0 + imin(j, last))[col], xc, v[j]);
          }
        } else {
          const float* base = row_ptr(j0);
          for (int col = l; col < n; col += 32) {
            const float xc = xtf[col];
#pragma unroll
            for (int j = 0; j < 32; ++j) v[j] = fmaf(base[size_t(imin(j, last)) * n + col], xc, v[j]);
          }
        }
        butterfly_round<16>(v, l);
        butterfly_round<8>(v, l);
        butterfly_round<4>(v, l);
        butterfly_round<2>(v, l);
        butterfly_round<1>(v, l);
        if (l < cnt) {                             // v[0]: the sum of row j0 + l
          const int i = j0 + l;
          float z = zs[i], y = ys[i];
          rv[i] = row_update(v[0], rhos[i], los[i], his[i], alpha, beta, z, y);
          zs[i] = z;
          ys[i] = y;
        }
      }
      __syncwarp();                                // rv is read by the whole warp next
    }
  }

  for (int j = cb + tid; j < cb + nc; j += T) a.x_out[ln + j] = x[j];
  for (int i = tid; i < rows; i += T) {
    const int row = rb + i;
    const bool s = row < m_s;
    const size_t kk = s ? ls + row : ld + (row - m_s);
    (s ? a.zs_out : a.zd_out)[kk] = zs[i];
    (s ? a.ys_out : a.yd_out)[kk] = ys[i];
  }
  cluster.sync();                                  // no block leaves while another reads it
}

template <bool ROWS>
int launch(const AdmmArgs& a, int cs, cudaStream_t stream) {
  const ClusterLayout L(a.n, a.m_s, a.m_d, cs, ROWS);
  cudaError_t err = cudaFuncSetAttribute(cluster_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B) * cs);
  cfg.blockDim = dim3(32 * L.nw);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_kernel<ROWS>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The layouts, tried in this order: the first that holds a shape runs it.
constexpr ClusterChoice kLayouts[] = {{2, true}, {4, true}, {8, true}, {2, false}, {4, false}, {8, false}};

// The first layout of kLayouts that holds the shape, or nullptr.
const ClusterChoice* layout_for(int n, int m_s, int m_d) {
  for (const ClusterChoice& c : kLayouts)
    if (ClusterLayout(n, m_s, m_d, c.cs, c.on_chip).fits()) return &c;
  return nullptr;
}

}  // namespace

bool structured_admm_cluster_has(int n, int m_s, int m_d) {
  return layout_for(n, m_s, m_d) != nullptr;
}

int structured_admm_cluster_launch(const AdmmArgs& a, cudaStream_t stream) {
  const ClusterChoice* c = layout_for(a.n, a.m_s, a.m_d);
  if (c == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return c->on_chip ? launch<true>(a, c->cs, stream) : launch<false>(a, c->cs, stream);
}
