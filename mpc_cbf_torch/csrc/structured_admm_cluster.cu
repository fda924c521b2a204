// Structured-ADMM iteration loop for lanes too large for one SM, for Hopper
// (sm_90a): one lane runs on a thread-block cluster of cs = 2, 4 or 8 blocks
// on neighbouring SMs, which read each other's shared memory (distributed
// shared memory) and meet at the cluster's hardware barrier. The kernel of
// every shape that no layout of structured_admm_tiled.cu, _folded.cu or
// _generic.cu holds: the fov teams of benchmarks/swarm.py from 30 agents
// ((35 + A, 119 + A, 12 (A - 1)): (163, 247, 1524) at 128 agents, (291, 375,
// 3060) at 256, (435, 519, 4788) at 400; the 32-agent team is folded's) and
// the connectivity teams of apps/sweep.py and run_sim from 30 robots
// ((35 + R, 125 + R, 2R - 2)).
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170); what
// one iteration computes is written out in structured_admm.cu.
//
// The numbers that decide the design. At the 128-agent fov team a lane's
// stacked matrix [A_s; A_d] is 1771 x 163 float32 words (1.15 MB) and its
// float64 C = (M_s + A_d' R A_d)^-1 (the operand, factored by the caller)
// 213 KB: neither fits the 227 KB of shared memory one block may have. An
// iteration is 2 x 1771 x 163 = 577 k float32 multiply-adds and 26.6 k in
// float64 a lane. Spread over 8 blocks the same lane is 144 KB of rows and
// 27 KB of C a block: it fits on chip. From 147 fov agents on it does not
// (a 256-agent lane is 4 MB of rows, a 400-agent lane 9.2 MB), and the rows
// must come from device memory in every iteration: at 400 lanes of 400
// agents that is at least 0.94 s a control step at 3.35 TB/s, against the
// 0.12 s of its float32 arithmetic. There the bytes bound the loop.
//
// What this design does about it:
// 1. xt = C RHS in float64 from the lane's C, read from device memory: block
//    k of the cluster owns the rows [k n / cs, (k + 1) n / cs) of C. C RHS
//    accumulates in float64 (the Woodbury cancellation, structured_admm.cu).
// 2. Block k also owns the rows [k m / cs, (k + 1) m / cs) of [A_s; A_d]
//    with their z, y, bounds and rho in its shared memory. An iteration has
//    two cluster barriers: the blocks' partial column sums [A_s; A_d]'r are
//    published at the first; each block then sums the cs partials of every
//    column in rank order by reading the other blocks' shared memory, forms
//    the whole RHS and its rows of xt = C RHS, and writes them into every
//    block's copy of xt; the second barrier publishes xt.
// 3. Where the rows live. Two layouts, kLayouts below:
//    (a) on chip (fov teams to 146 agents, connectivity teams to 257 robots):
//        the block's rows and its rows of C sit in shared memory, read twice
//        an iteration: the column sums (lane l of a warp sums columns
//        l + 32 c over the warp's 32-row chunks) before the first barrier,
//        and after the second the row sums [A_s; A_d] xt (lane l takes row l
//        of the chunk whole, odd row stride: 32 banks) with the row updates.
//    (b) streamed (every larger lane): one pass over the block's rows an
//        iteration. A warp takes chunks of kRC rows, staged from device
//        memory into a ring of 2 stages of its own by 16-byte cp.async
//        copies (4-byte ones at a run's unaligned ends); while a chunk is on
//        chip the warp forms its row sums a_i xt (lanes over the columns,
//        met by shuffles), the row updates, and the chunk's share r_i a_i of
//        the next iteration's column sums. The first column sums come from
//        the initial state in a pass before the loop; the last iteration
//        forms none. The long sums meet in float64 (a lane's part of a row
//        sum across the warp, a chunk's column sums across the chunks, RHS):
//        the scaled problems of such teams reach |x| ~ 1e5 with rho = 100 on
//        the equality rows, where float32 sums over a warp's hundred rows cost
//        20 of 400 lanes of a 400-agent ring the usable bar that the twin met
//        (the chunk's and lane's short partial sums stay float32: float64
//        products of every element were slower). The copies run
//        ahead of the warp by the ring's depth and wrap round from one
//        iteration to the next, so the loads of the next pass start before
//        the barriers. C's rows stream through the same ring, two rows a
//        chunk, read between the barriers (a 400-agent lane's C is 1.5 MB
//        against 8.3 MB of A_d): a block then needs little beside the ring,
//        and two or more blocks share an SM (kStreamWarps). A_s is the same
//        for every lane: it is read from L2.
//    The first layout of kLayouts that holds a shape runs it: rows on chip
//    with 2, 4, then 8 blocks, then streamed with 8 (the portable maximum of
//    a cluster; 16 blocks measured slower, PERF.md).
// One lane a cluster: a NaN lane cannot reach another lane.
// scripts/admm_kernel_sweep.py --cluster times other kLayouts lines.
//
// Built without --use_fast_math: inactive dynamic rows carry rho = 1e-12
// and the loop divides by rho, so division must be IEEE and denormals kept.

#include <cooperative_groups.h>
#include <cstdint>

#include "structured_admm.cuh"

namespace cg = cooperative_groups;

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

constexpr int kP = 8;                          // threads a row of C in xt = C RHS (on chip)
constexpr int kSlots = 4;                      // column slots of 32 a lane copies at a time
constexpr int kRC = 4;                         // rows of [A_s; A_d] a streamed chunk (2 of C)
static_assert(kRC % 2 == 0, "a chunk of C is kRC / 2 float64 rows");
constexpr int kStages = 2;                     // chunks of a warp's ring
constexpr size_t kMaxSharedBytes = 232448;     // 227 KB: what one block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;

// First row of part k of `count` rows split into cs parts (parts differ by
// at most one row).
__host__ __device__ inline int part_start(int count, int cs, int k) { return k * count / cs; }

// Smallest row stride >= x (doubles) that is kP mod 2 kP: the kP threads of
// a row and the 16 / kP rows of a half-warp then load from 32 distinct banks.
__host__ __device__ constexpr int pad_c(int x) { return round_up(x + kP, 2 * kP) - kP; }

// Shared memory of one block of the on-chip layout, byte offsets: C's rows,
// the loop's vectors, the row state and the rows. The rows' stride lda is
// odd: a warp whose lanes read one row each, at the same column, reads 32
// distinct banks.
struct ClusterLayout {
  int n, m_s, m_d, m, cs, rows, crows, nw, nv, ldc, lda;
  size_t c, rhs, x, q, xtf, pcol, pw, rv, st, a, bytes;
  __host__ __device__ ClusterLayout(int n_, int m_s_, int m_d_, int cs_)
      : n(n_), m_s(m_s_), m_d(m_d_), m(m_s_ + m_d_), cs(cs_) {
    rows = cdiv(m, cs);                    // rows of [A_s; A_d] a block, at most
    crows = cdiv(n, cs);                   // rows of C a block, at most
    nw = imin(16, imax(4, cdiv(rows, 32)));
    nv = round_up(n, 4);
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
    a = st + size_t(4) * 5 * rv4;                                 // rows [rv4, lda]
    bytes = align16(a + size_t(4) * rv4 * lda);
  }
  __host__ __device__ bool fits() const { return bytes <= kMaxSharedBytes; }
};

// Shared memory of one block of the streamed layout, nw warps, byte offsets:
// the sums RHS, the block's and the warps' partial column sums (float64), the
// lane's vectors, the row state and the warps' rings of kStages chunks (a
// stage holds kRC rows of [A_s; A_d] or kRC / 2 rows of C, and up to 3 floats
// before them that align the copy).
struct StreamLayout {
  int n, m_s, m_d, m, cs, rows, nw, nv, sf;
  size_t rhs, x, q, xtf, pcol, pw, st, ring, bytes;
  __host__ __device__ StreamLayout(int n_, int m_s_, int m_d_, int cs_, int nw_)
      : n(n_), m_s(m_s_), m_d(m_d_), m(m_s_ + m_d_), cs(cs_), nw(nw_) {
    rows = cdiv(m, cs);
    nv = round_up(n, 4);
    sf = round_up(kRC * n + 3, 4);
    rhs = 0;                                                      // RHS [nv] f64
    pcol = rhs + size_t(8) * nv;                                  // the block's partial [nv] f64
    pw = pcol + size_t(8) * nv;                                   // the warps' partials, f64
    x = pw + size_t(8) * nw * nv;                                 // x, q, xt [nv] f32
    q = x + size_t(4) * nv;
    xtf = q + size_t(4) * nv;
    st = xtf + size_t(4) * nv;                                    // z, y, lo, hi, rho [rv4]
    ring = align16(st + size_t(4) * 5 * round_up(rows, 4));       // [nw, kStages, sf]
    bytes = ring + size_t(4) * nw * kStages * sf;
  }
  __host__ __device__ bool fits() const { return bytes <= kMaxSharedBytes; }
};

// The streamed layout's warps a block: of these, the count that keeps the most warps
// on an SM (blocks an SM by shared memory and by the launch bounds' registers), then the
// most blocks. Measured steps of a 256-lane chunk (PERF.md): 256 agents 375 ms with 8
// warps (two blocks an SM) against 398 with 4 (three); 400 agents 938 ms with 4 (two
// blocks) against 989 with 8 (one). Deeper rings, C's rows in shared memory and 12 or 16
// warps a block, each leaving one block an SM, were slower.
constexpr int kStreamWarps[] = {8, 4};
constexpr int kStreamMinBlocks = 2;            // __launch_bounds__: at most 128 registers
constexpr size_t kSharedBytesPerSM = 233472;   // 228 KB, 1 KB of it reserved for each block

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

// The block's rows [cb, cb + nc) of C (the lane's [n, n] in device memory)
// into Cm [nc, ldc].
__device__ __forceinline__ void load_c_rows(double* Cm, int ldc, const double* Cg, int cb, int nc,
                                            int n) {
  for (int i = threadIdx.x; i < nc * n; i += blockDim.x)
    Cm[(i / n) * ldc + i % n] = Cg[size_t(cb) * n + i];
}

// The lane's vectors x and q, and the z, y, bounds and rho of the block's rows
// [rb, rb + rows) of [A_s; A_d]; r = rho z - y into rv (if not null), 0 up to rv4.
__device__ __forceinline__ void load_state(const AdmmArgs& a, int lane, int rb, int rows, int rv4,
                                           float* x, float* q, float* st, float* rv) {
  const int n = a.n, m_s = a.m_s;
  const size_t ln = size_t(lane) * n, ls = size_t(lane) * m_s, ld = size_t(lane) * a.m_d;
  float *zs = st, *ys = st + rv4, *los = st + 2 * rv4, *his = st + 3 * rv4, *rhos = st + 4 * rv4;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    x[j] = a.x0[ln + j];
    q[j] = a.q[ln + j];
  }
  for (int i = threadIdx.x; i < rv4; i += blockDim.x) {
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
    if (rv != nullptr) rv[i] = rr;                 // 0 past the rows: the float4 loads
  }
}

// The block's rows of x and of z and y into the outputs.
__device__ __forceinline__ void store_state(const AdmmArgs& a, int lane, int rb, int rows, int rv4,
                                            int cb, int nc, const float* x, const float* st) {
  const size_t ln = size_t(lane) * a.n, ls = size_t(lane) * a.m_s, ld = size_t(lane) * a.m_d;
  for (int j = cb + threadIdx.x; j < cb + nc; j += blockDim.x) a.x_out[ln + j] = x[j];
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int row = rb + i;
    const bool s = row < a.m_s;
    const size_t kk = s ? ls + row : ld + (row - a.m_s);
    (s ? a.zs_out : a.zd_out)[kk] = st[i];
    (s ? a.ys_out : a.yd_out)[kk] = st[rv4 + i];
  }
}

// RHS = sigma x - q + the blocks' partial column sums pcol, in rank order (R:
// float, or double for the streamed layout's sums).
template <class R>
__device__ __forceinline__ void form_rhs(cg::cluster_group& cluster, int cs, int n, float sigma,
                                         const float* x, const float* q, R* pcol, R* rhs) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    R s = 0;
    for (int b = 0; b < cs; ++b) s += cluster.map_shared_rank(pcol, b)[j];
    rhs[j] = static_cast<R>(sigma * x[j] - q[j]) + s;
  }
}

// The block's rows [cb, cb + nc) of xt = C RHS from C's rows Cm [nc, ldc] in
// shared memory, kP threads a row; thread p of a row writes the row's value
// into the copies of xt of blocks p, p + kP, ...
__device__ __forceinline__ void xt_rows(cg::cluster_group& cluster, int cs, const double* Cm,
                                        int ldc, int cb, int nc, int n, const float* rhs,
                                        float* xtf) {
  const int T = blockDim.x, tid = threadIdx.x;
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
    if (row < nc)
      for (int b = p; b < cs; b += kP)
        cluster.map_shared_rank(xtf, b)[cb + row] = static_cast<float>(s);
  }
}

// ---- the on-chip layout ---------------------------------------------------------------------

// One lane a cluster of cs blocks (grid: B cs blocks, cluster: cs); the
// block's rows of [A_s; A_d] and of C in its shared memory.
__global__ void __launch_bounds__(512) cluster_kernel(const AdmmArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / cs;                 // grid = B cs: every cluster is a lane
  const int n = a.n, m_s = a.m_s;
  const ClusterLayout L(n, m_s, a.m_d, cs);
  const int nw = L.nw, nv = L.nv, ldc = L.ldc, lda = L.lda;
  const int T = 32 * nw, tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int rb = part_start(L.m, cs, k), rows = part_start(L.m, cs, k + 1) - rb;   // its rows
  const int cb = part_start(n, cs, k), nc = part_start(n, cs, k + 1) - cb;         // its rows of C
  const int nch = cdiv(rows, 32);                   // chunks of 32 rows, chunk ch to warp ch % nw
  const int rv4 = round_up(L.rows, 4);

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
  float* st = reinterpret_cast<float*>(base + L.st);
  float *zs = st, *ys = st + rv4, *los = st + 2 * rv4, *his = st + 3 * rv4, *rhos = st + 4 * rv4;
  float* As = reinterpret_cast<float*>(base + L.a);          // [rows, lda]
  const float* Ad = a.Ad + size_t(lane) * a.m_d * n;         // [m_d, n]

  load_c_rows(Cm, ldc, a.C + size_t(lane) * n * n, cb, nc, n);
  load_state(a, lane, rb, rows, rv4, x, q, st, rv);
  copy_rows(
      rv4, n, n,
      [&](int i) -> const float* {
        if (i >= rows) return nullptr;
        const int row = rb + i;
        return row < m_s ? a.A_s + size_t(row) * n : Ad + size_t(row - m_s) * n;
      },
      [&](int i) { return As + size_t(i) * lda; });
  cluster.sync();                                  // every block of the lane runs; all in place

  const float alpha = a.alpha, beta = 1.0f - a.alpha;
  for (int it = 0; it < a.iters; ++it) {
    // (a) the warps' column sums of [A_s; A_d]'r over their chunks, met in the block. The
    // rows of a chunk are base + j lda (past its last row: that row again, times r = 0),
    // so that every load of a step is in flight before its multiply-adds wait
    for (int col = l; col < n; col += 32) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int ch = w; ch < nch; ch += nw) {
        const int j0 = 32 * ch, cnt = imin(32, rows - j0), c4 = round_up(cnt, 4);
        const float4* r4 = reinterpret_cast<const float4*>(rv + j0);
        const float* arow = As + size_t(j0) * lda + col;
        const int last = cnt - 1;
#pragma unroll 4
        for (int j = 0; j < c4; j += 4) {
          const float4 r = r4[j / 4];
          s0 = fmaf(arow[j * lda], r.x, s0);
          s1 = fmaf(arow[imin(j + 1, last) * lda], r.y, s1);
          s2 = fmaf(arow[imin(j + 2, last) * lda], r.z, s2);
          s3 = fmaf(arow[imin(j + 3, last) * lda], r.w, s3);
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
    form_rhs(cluster, cs, n, a.sigma, x, q, pcol, rhs);
    __syncthreads();
    xt_rows(cluster, cs, Cm, ldc, cb, nc, n, rhs, xtf);
    cluster.sync();                                // every block's rows of xt are in every block
    // (c) relax x, then the block's rows of [A_s; A_d] xt and their updates; lane l takes
    // row j0 + l of its warp's chunk whole
    for (int j = tid; j < n; j += T) x[j] = alpha * xtf[j] + beta * x[j];
    __syncthreads();
    for (int ch = w; ch < nch; ch += nw) {
      const int j0 = 32 * ch, cnt = imin(32, rows - j0);
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
      __syncwarp();                                // rv is read by the whole warp next
    }
  }

  __syncthreads();                                 // x and the row state, written by other warps
  store_state(a, lane, rb, rows, rv4, cb, nc, x, st);
  cluster.sync();                                  // no block leaves while another reads it
}

// ---- the streamed layout --------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's copy of src[0 .. len) into dst[ph .. ph + len), ph = the float
// offset of src in its 16-byte line (dst is 16-byte aligned): 16-byte copies
// where a whole line lies in the run, 4-byte ones at its ends.
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int len, int l) {
  const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float* line = src - ph;
  const int units = (ph + len + 3) / 4;
  for (int u = l; u < units; u += 32) {
    const int f0 = 4 * u;
    if (f0 >= ph && f0 + 4 <= ph + len) {
      cp_async16(dst + f0, line + f0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (f0 + e >= ph && f0 + e < ph + len) cp_async4(dst + f0 + e, line + f0 + e);
    }
  }
}

// One lane a cluster of cs blocks; the block's rows of [A_s; A_d] streamed
// from device memory once an iteration (see 3 (b) above).
__global__ void __launch_bounds__(256, kStreamMinBlocks) stream_kernel(const AdmmArgs a,
                                                                       const int nw) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / cs;
  const int n = a.n, m_s = a.m_s;
  const StreamLayout L(n, m_s, a.m_d, cs, nw);
  const int nv = L.nv, S = kStages;
  const int T = 32 * nw, tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int rb = part_start(L.m, cs, k), rows = part_start(L.m, cs, k + 1) - rb;
  const int cb = part_start(n, cs, k), nc = part_start(n, cs, k + 1) - cb;
  const int rv4 = round_up(L.rows, 4);
  // the block's chunks of rows: those of A_s first, then those of A_d; chunk i to warp i % nw
  const int rows_s = imax(0, imin(m_s, rb + rows) - rb);
  const int nqs = cdiv(rows_s, kRC), nq = nqs + cdiv(rows - rows_s, kRC);
  const int nqw = w < nq ? cdiv(nq - w, nw) : 0;
  // and of C's rows, kRC / 2 rows a chunk
  constexpr int kCR = kRC / 2;
  const int ncq = cdiv(nc, kCR);
  const int ncw = w < ncq ? cdiv(ncq - w, nw) : 0;
  const int period = nqw + ncw;                     // a warp's chunks an iteration

  extern __shared__ double smem[];
  char* base = reinterpret_cast<char*>(smem);
  double* rhs = reinterpret_cast<double*>(base + L.rhs);
  double* pcol = reinterpret_cast<double*>(base + L.pcol);
  double* acc = reinterpret_cast<double*>(base + L.pw) + w * nv;  // the warp's column sums
  float* x = reinterpret_cast<float*>(base + L.x);
  float* q = reinterpret_cast<float*>(base + L.q);
  float* xtf = reinterpret_cast<float*>(base + L.xtf);
  float* st = reinterpret_cast<float*>(base + L.st);
  float *zs = st, *ys = st + rv4, *los = st + 2 * rv4, *his = st + 3 * rv4, *rhos = st + 4 * rv4;
  float* ring = reinterpret_cast<float*>(base + L.ring) + size_t(w) * S * L.sf;
  const float* Ad = a.Ad + size_t(lane) * a.m_d * n;
  const double* Cg = a.C + size_t(lane) * n * n;

  // element e of the warp's period: its row chunk e (e < nqw), else its chunk e - nqw of C.
  // Returns the run to copy (len floats) and the chunk's first row and row count
  auto chunk = [&](int e, int& i0, int& cnt, int& len) -> const float* {
    if (e < nqw) {
      const int qi = w + nw * e;
      if (qi < nqs) {
        i0 = qi * kRC;
        cnt = imin(kRC, rows_s - i0);
        len = cnt * n;
        return a.A_s + size_t(rb + i0) * n;
      }
      i0 = rows_s + (qi - nqs) * kRC;
      cnt = imin(kRC, rows - i0);
      len = cnt * n;
      return Ad + size_t(rb + i0 - m_s) * n;
    }
    i0 = (w + nw * (e - nqw)) * kCR;
    cnt = imin(kCR, nc - i0);
    len = 2 * cnt * n;
    return reinterpret_cast<const float*>(Cg + size_t(cb + i0) * n);
  };
  // copies of the warp's g-th chunk (counted over the whole run) into stage g % S
  auto fetch = [&](int g) {
    if (period > 0) {
      int i0, cnt, len;
      const float* src = chunk(g % period, i0, cnt, len);
      stage_copy(ring + (g % S) * L.sf, src, len, l);
    }
    cp_async_commit();
  };
  int g = 0;                                        // the warp's chunks consumed so far
  // the chunk g: waits for its copies; returns it in the stage (past the alignment floats)
  auto next = [&](int& i0, int& cnt) -> const float* {
    fetch(g + S - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();                                   // every lane's copies are visible
    int len;
    const float* src = chunk(g % period, i0, cnt, len);
    return ring + (g % S) * L.sf + ((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  };

  for (int s = 0; s < S - 1; ++s) fetch(s);        // the ring's first chunks, while the state loads
  load_state(a, lane, rb, rows, rv4, x, q, st, nullptr);
  __syncthreads();

  const float alpha = a.alpha, beta = 1.0f - a.alpha;
  // one pass over the warp's row chunks: with rowsum, the row sums of [A_s; A_d] xt and the
  // row updates, else r from the state as it is; with colsum, the chunks' r_i a_i into acc.
  // The sums that run long meet in float64: a lane's part of a row sum (n / 32 products in
  // float32) is reduced across the warp in float64, and each chunk's column sums (kRC
  // products in float32) are added into acc in float64. The large teams' scaled problems
  // reach |x| ~ 1e5 with rho = 100 on the equality rows, where a float32 column sum running
  // over a warp's hundred rows lost enough bits that 20 of 400 lanes of a 400-agent ring
  // missed the usable bar that the twin met
  auto pass = [&](bool rowsum, bool colsum) {
    if (colsum)
      for (int t = l; t < n; t += 32) acc[t] = 0.0;
    for (int e = 0; e < nqw; ++e, ++g) {
      int i0, cnt;
      const float* buf = next(i0, cnt);
      float r[kRC];
      if (rowsum) {
        float v[kRC];
#pragma unroll
        for (int j = 0; j < kRC; ++j) v[j] = 0.f;
        for (int t = l; t < n; t += 32) {
          const float xv = xtf[t];
#pragma unroll
          for (int j = 0; j < kRC; ++j)
            if (j < cnt) v[j] = fmaf(buf[j * n + t], xv, v[j]);
        }
        double mine = 0.0;                          // lane j keeps the sum of row j
#pragma unroll
        for (int j = 0; j < kRC; ++j) {
          double d = v[j];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
          if (l == j) mine = d;
        }
        float rl = 0.f;
        if (l < cnt) {
          const int i = i0 + l;
          float z = zs[i], y = ys[i];
          rl = row_update(static_cast<float>(mine), rhos[i], los[i], his[i], alpha, beta, z, y);
          zs[i] = z;
          ys[i] = y;
        }
#pragma unroll
        for (int j = 0; j < kRC; ++j) r[j] = __shfl_sync(kFull, rl, j);
      } else {
#pragma unroll
        for (int j = 0; j < kRC; ++j)
          r[j] = j < cnt ? rhos[i0 + j] * zs[i0 + j] - ys[i0 + j] : 0.f;
      }
      if (colsum) {
        for (int t = l; t < n; t += 32) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kRC; ++j)
            if (j < cnt) s = fmaf(buf[j * n + t], r[j], s);
          acc[t] += s;
        }
      }
      __syncwarp();                                 // the stage is free for the next copy
    }
  };
  // the block's partial column sums: the warps' in order
  auto publish = [&]() {
    __syncthreads();
    const double* pw = reinterpret_cast<const double*>(base + L.pw);
    for (int j = tid; j < n; j += T) {
      double s = 0.0;
      for (int v = 0; v < nw; ++v) s += pw[v * nv + j];
      pcol[j] = s;
    }
  };

  pass(false, true);                                // the first column sums, from the initial state
  publish();
  for (int it = 0; it < a.iters; ++it) {
    cluster.sync();                                 // every block's partial is published
    form_rhs(cluster, cs, n, a.sigma, x, q, pcol, rhs);
    __syncthreads();
    // C's rows through the ring, a warp a chunk
    for (int e = 0; e < ncw; ++e, ++g) {
      int i0, cnt;
      const double* cbuf = reinterpret_cast<const double*>(next(i0, cnt));
      double s[kCR];
#pragma unroll
      for (int j = 0; j < kCR; ++j) s[j] = 0.0;
      for (int t = l; t < n; t += 32) {
        const double rt = rhs[t];
#pragma unroll
        for (int j = 0; j < kCR; ++j)
          if (j < cnt) s[j] = fma(cbuf[j * n + t], rt, s[j]);
      }
#pragma unroll
      for (int j = 0; j < kCR; ++j) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s[j] += __shfl_xor_sync(kFull, s[j], o);
        if (j < cnt && l < cs)
          cluster.map_shared_rank(xtf, l)[cb + i0 + j] = static_cast<float>(s[j]);
      }
      __syncwarp();                                 // the stage is free for the next copy
    }
    cluster.sync();                                 // every block's rows of xt are in every block
    for (int j = tid; j < n; j += T) x[j] = alpha * xtf[j] + beta * x[j];
    const bool more = it + 1 < a.iters;
    pass(true, more);
    if (more) publish();
  }
  cp_async_wait<0>();                               // the copies run ahead of the last pass
  __syncthreads();                                  // x and the row state, written by other warps
  store_state(a, lane, rb, rows, rv4, cb, nc, x, st);
  cluster.sync();                                   // no block leaves while another reads it
}

// ---- layouts and launch ---------------------------------------------------------------------

struct ClusterChoice {
  int cs;
  bool on_chip;
};

// The layouts, tried in this order: the first that holds a shape runs it.
constexpr ClusterChoice kLayouts[] = {{2, true}, {4, true}, {8, true}, {8, false}};

// The streamed layout's warps a block for cs blocks a lane (kStreamWarps), or 0 where
// none fits.
int stream_warps(int n, int m_s, int m_d, int cs) {
  int best = 0, best_warps = 0, best_blocks = 0;
  for (int nw : kStreamWarps) {
    const StreamLayout L(n, m_s, m_d, cs, nw);
    if (!L.fits()) continue;
    const int by_regs = kStreamMinBlocks * 8 / nw;         // 128 registers x 256 threads x 2
    const int blocks = imin(by_regs, static_cast<int>(kSharedBytesPerSM / (L.bytes + 1024)));
    if (blocks * nw > best_warps || (blocks * nw == best_warps && blocks > best_blocks)) {
      best = nw;
      best_warps = blocks * nw;
      best_blocks = blocks;
    }
  }
  return best;
}

bool holds(const ClusterChoice& c, int n, int m_s, int m_d) {
  return c.on_chip ? ClusterLayout(n, m_s, m_d, c.cs).fits()
                   : stream_warps(n, m_s, m_d, c.cs) > 0;
}

// The first layout of kLayouts that holds the shape, or nullptr.
const ClusterChoice* layout_for(int n, int m_s, int m_d) {
  for (const ClusterChoice& c : kLayouts)
    if (holds(c, n, m_s, m_d)) return &c;
  return nullptr;
}

// Launches kernel on a grid of `grid` blocks in clusters of cs.
template <class Kernel, class... Args>
int launch_grid(Kernel kernel, unsigned grid, int cs, int threads, size_t bytes,
                cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

bool structured_admm_cluster_has(int n, int m_s, int m_d) {
  return layout_for(n, m_s, m_d) != nullptr;
}

int structured_admm_cluster_launch(const AdmmArgs& a, cudaStream_t stream) {
  const ClusterChoice* c = layout_for(a.n, a.m_s, a.m_d);
  if (c == nullptr || a.C == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(a.B) * c->cs;
  if (c->on_chip) {
    const ClusterLayout L(a.n, a.m_s, a.m_d, c->cs);
    return launch_grid(cluster_kernel, grid, c->cs, 32 * L.nw, L.bytes, stream, a);
  }
  const int nw = stream_warps(a.n, a.m_s, a.m_d, c->cs);
  const StreamLayout L(a.n, a.m_s, a.m_d, c->cs, nw);
  return launch_grid(stream_kernel, grid, c->cs, 32 * nw, L.bytes, stream, a, nw);
}
