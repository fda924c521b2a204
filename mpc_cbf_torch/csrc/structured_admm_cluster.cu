// Structured-ADMM iteration loop for the lanes past the one-block kernels, for
// Hopper (sm_90a): one lane runs on a thread-block cluster of cs = 2, 4 or 8
// blocks on neighbouring SMs, which write into each other's shared memory
// (distributed shared memory), or, where its rows fit the registers of one
// SM with two lanes on it, on one block of its own (cs = 1, no cluster). The
// kernel of every shape that no layout of structured_admm_tiled.cu,
// _folded.cu or _generic.cu holds: the fov teams of benchmarks/swarm.py from
// 30 agents ((35 + A, 119 + A, 12 (A - 1)): (163, 247, 1524) at 128 agents,
// (291, 375, 3060) at 256, (435, 519, 4788) at 400; the 32-agent team is
// folded's) and the connectivity teams of apps/sweep.py and run_sim from 30
// robots ((35 + R, 125 + R, 2R - 2); those of 30-33 robots, conn32's (67,
// 157, 62) among them, on one SM).
//
// Replaces the Pallas TPU kernel mpc_cbf_tpu/ops/qp/pallas_admm.py::_kernel
// (launched by structured_admm_iterations, pl.pallas_call at :170); what
// one iteration computes is written out in structured_admm.cu.
//
// The numbers that decide the design. At the 128-agent fov team a lane's
// stacked matrix [A_s; A_d] is 1771 x 163 float32 words (1.15 MB) and its
// float64 C = (M_s + A_d' R A_d)^-1 (the operand, factored by the caller)
// 213 KB: neither fits one SM. An iteration is 2 x 1771 x 163 = 577 k
// float32 multiply-adds and 26.6 k in float64 a lane: spread over 8 blocks,
// 72 k multiply-adds a block, 566 clocks of the SM's 128 float32 lanes. The
// rows fit 8 SMs' registers (222 rows x 6 column slots of 32 = 42.6 k of an
// SM's 64 k registers). The layout this one replaced kept them in shared
// memory and read them twice an iteration (289 KB a block, 2.3 k clocks at
// 128 bytes a clock), with 7 warps an SM, and met the blocks at two cluster
// barriers after loads from the other blocks: its stages measured 12.1-12.2 k
// clocks an iteration, 4.6 k of them the column sums and 2.4-2.5 k the two
// barriers (PERF.md, scripts/admm_kernel_sweep.py --stage-clocks). From 150
// fov agents on the rows fit no cluster's registers (a 256-agent lane is 4 MB
// of rows, a 400-agent lane 9.2 MB), and they come from device memory in
// every iteration: at 400 lanes of 400 agents that is at least 0.94 s a
// control step at 3.35 TB/s, against the 0.12 s of its float32 arithmetic.
// There the bytes bound the loop.
//
// A lane that fits one SM is the other case. conn32's (67, 157, 62) lane is
// 219 x 67 float32 rows (28 rows x 3 column slots = 84 floats a thread of 8
// warps) and a float64 C of 67 x 72 x 8 B = 38.6 KB (47.7 KB of shared memory
// a block, RegLayout). On the 2 blocks of 16 warps of the cluster layout each
// SM held half a lane: 66 lanes on 132 SMs, 496 waves for 32768 lanes, each
// warp's strip 7 of its 20 rows, and an iteration ~1.86 us (3.3-3.7 k clocks)
// of latency that nothing hid: about 21 row products a thread, two block
// barriers and two pushes across SMs with their waits (PERF.md). Fixed costs
// held it, not its rows.
//
// What this design does about it:
// 1. xt = C RHS in float64 from the lane's C: block k of the cluster owns the
//    rows [k n / cs, (k + 1) n / cs) of C, kP threads a row. C RHS
//    accumulates in float64 (the Woodbury cancellation, structured_admm.cu).
// 2. Block k also owns the rows [k m / cs, (k + 1) m / cs) of [A_s; A_d]
//    with their z, y, bounds and rho. An iteration has two exchanges between
//    the blocks, and each is a push: the values go into the receiver's
//    shared memory by st.async, each store counting its bytes on the
//    receiver's mbarrier, and the receiver waits on its own mbarrier for the
//    bytes of the phase, not for every block at a cluster barrier. Each block
//    meets its warps' partial column sums [A_s; A_d]'r and pushes them into
//    its own row of every block's buffer [cs, n]; each block then sums its
//    buffer in rank order (RHS, the same in every block), forms its rows of
//    xt = C RHS and pushes them into every block's copy of xt. No block reads
//    another block's memory. At 128 agents the two waits take 1.0 k clocks an
//    iteration where the replaced layout's two cluster barriers took 2.4-2.5 k
//    (PERF.md).
// 3. Where the rows live. Three layouts, kLayouts below:
//    (a) registers (fov teams to 149 agents, connectivity teams to 285
//        robots): warp w of a block holds a strip of the block's rows, lane l
//        columns l, l + 32, ... of each (RegShape: at most RW rows a strip, TC
//        column slots), loaded once a launch. Both products come from those
//        registers: the column sums as each lane's sums over its strip, met
//        across the warps in shared memory; the row sums as each lane's
//        partial sums, met across the warp by a transposing butterfly of
//        shuffles (16 rows meet in 16 shuffles, and lane l ends with row
//        l / 2 whole), after which the row's first lane updates it at once,
//        with no block barrier of its own. The row state and the strip's r
//        sit in shared memory (read by the row's lane and by the warp:
//        __syncwarp). ptxas keeps RW x TC <= 84 floats of rows in the 128
//        registers of a thread of 16 warps and 192 in the 255 of 8 warps
//        without spilling; the fewest blocks whose strips fit run a shape, on
//        16 warps where they fit (16 warps ran the 128-agent team 1.2 times
//        faster than 8). An iteration at 128 agents is 6.3 k clocks against
//        the replaced layout's 12.1-12.2 k (PERF.md).
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
//        for every lane: it is read from L2. This layout still reads the
//        other blocks' partial column sums (form_rhs).
//    (c) registers on one SM (cs = 1; connectivity teams of 30-33 robots,
//        RegShape<8, 28, 3, true>): one lane a block of 8 warps, launch
//        bounds of two blocks an SM (RW x TC = 84 floats of rows within 128
//        registers; 2 x 47.7 KB of shared memory at conn32), so an SM holds
//        two lanes (264 resident, 124 waves at 32768 lanes) whose waits hide
//        each other. The rows stay in the warps' registers as in (a); C is
//        whole in the block's shared memory, and both exchanges stay in it:
//        the warps' partial column sums meet into RHS behind one block
//        barrier, xt = C RHS (2 threads a row, one pass) is written straight
//        into xt behind another, three block barriers an iteration and no
//        push, mbarrier or cluster barrier (compiled out: ONE_SM). conn32's
//        four launches of a step took 144.6 ms against 369.2 ms on 2 blocks
//        of 16 warps; 16 warps a block (one lane an SM) 196.8 ms and two
//        lanes a block of 16 warps 173.1 ms (PERF.md).
//    The first layout of kLayouts that holds a shape runs it: one SM, then
//    registers with 2, 4, then 8 blocks (16, then 8 warps), then streamed
//    with 8 (the portable maximum of a cluster; 16 blocks measured slower,
//    PERF.md).
// One lane a cluster or a block: a NaN lane cannot reach another lane.
// scripts/admm_kernel_sweep.py --cluster times other kLayouts lines, and
// --stage-clocks the stages of an iteration (the STAGE markers).
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
__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

constexpr int kGroup = 16;                     // rows of a strip one butterfly meets
constexpr int kRC = 4;                         // rows of [A_s; A_d] a streamed chunk (2 of C)
static_assert(kRC % 2 == 0, "a chunk of C is kRC / 2 float64 rows");
constexpr int kStages = 2;                     // chunks of a warp's ring
constexpr size_t kMaxSharedBytes = 232448;     // 227 KB: what one block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;

// First row of part k of `count` rows split into cs parts (parts differ by
// at most one row).
__host__ __device__ inline int part_start(int count, int cs, int k) { return k * count / cs; }

// Threads a row of C in xt = C RHS: kP where a lane spans a cluster, kP1 where it has one SM
// (cs = 1): there a lane's n <= 96 rows take one pass of its 256 threads (conn32's four
// launches of a step: 142 ms with 2, 160 with 8 threads a row in three passes, 176 with 1;
// PERF.md).
constexpr int kP = 8, kP1 = 2;
__host__ __device__ constexpr int row_threads(int cs) { return cs == 1 ? kP1 : kP; }

// Smallest row stride >= x (doubles) that is p mod 2 p: the p threads of a
// row and the 16 / p rows of a half-warp then load from 32 distinct banks.
__host__ __device__ constexpr int pad_c(int x, int p) { return round_up(x + p, 2 * p) - p; }

// Shared memory of one block of the register layout, byte offsets: the two
// exchanges' mbarriers, C's rows, the loop's vectors, the pushed partial column
// sums, the warps' partials, each strip's r and the row state.
struct RegLayout {
  int n, m, cs, nw, rows, crows, rw, nv, ldc, rwp, rv4;
  size_t bar, c, rhs, x, q, xtf, buf, pw, rv, st, bytes;
  __host__ __device__ RegLayout(int n_, int m_s, int m_d, int cs_, int nw_)
      : n(n_), m(m_s + m_d), cs(cs_), nw(nw_) {
    rows = cdiv(m, cs);                    // rows of [A_s; A_d] a block, at most
    crows = cdiv(n, cs);                   // rows of C a block, at most
    rw = cdiv(rows, nw);                   // rows a warp's strip, at most
    nv = round_up(n, 4);
    ldc = pad_c(n, row_threads(cs));
    rwp = round_up(rw, 4);
    rv4 = round_up(rows, 4);
    bar = 0;                                                      // 2 mbarriers
    c = 16;                                                       // C [crows, ldc] f64
    rhs = align16(c + size_t(8) * crows * ldc);                   // RHS [nv] f64
    x = rhs + size_t(8) * nv;                                     // x, q, xt [nv] f32
    q = x + size_t(4) * nv;
    xtf = q + size_t(4) * nv;
    buf = xtf + size_t(4) * nv;                                   // the blocks' partials [cs, nv]
    pw = buf + size_t(4) * cs * nv;                               // the warps' partials [nw, nv]
    rv = pw + size_t(4) * nw * nv;                                // r of each strip [nw, rwp]
    st = rv + size_t(4) * nw * rwp;                               // z, y, lo, hi, rho [5, rv4]
    bytes = align16(st + size_t(4) * 5 * rv4);
  }
};

// Blocks an SM that the launch bounds of an instance of the register layout ask for: one where
// a lane spans a cluster (a block's rows fill its SM's registers), else as many as make 16 warps
// an SM, so that each thread keeps 128 registers.
__host__ __device__ constexpr int reg_min_blocks(int nw, bool one_sm) {
  return one_sm ? imax(1, 16 / nw) : 1;
}

// One instance of the register layout: NW warps a block, at most RW rows a strip, TC column
// slots of 32 a lane (n <= 32 TC); ONE_SM: one lane a block, no cluster, else a lane spans a
// cluster of blocks. RW x TC floats of rows a thread, within the 65 536 / (32 NW
// reg_min_blocks) registers the launch bounds give it.
template <int NW_, int RW_, int TC_, bool ONE_SM_ = false>
struct RegShape {
  static constexpr int NW = NW_, RW = RW_, TC = TC_;
  static constexpr bool ONE_SM = ONE_SM_;
  static_assert(RW % 2 == 0 && RW >= 4 && TC >= 1 && (NW == 8 || NW == 16), "layout");
};
template <class... S>
struct ShapeList {};


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



// The block's rows [cb, cb + nc) of C (the lane's [n, n] in device memory)
// into Cm [nc, ldc].
__device__ __forceinline__ void load_c_rows(double* Cm, int ldc, const double* Cg, int cb, int nc,
                                            int n) {
  for (int i = threadIdx.x; i < nc * n; i += blockDim.x)
    Cm[(i / n) * ldc + i % n] = Cg[size_t(cb) * n + i];
}

// The lane's vectors x and q, and the z, y, bounds and rho of the block's rows
// [rb, rb + rows) of [A_s; A_d] into st (five arrays at stride rv4).
__device__ __forceinline__ void load_state(const AdmmArgs& a, int lane, int rb, int rows, int rv4,
                                           float* x, float* q, float* st) {
  const int n = a.n, m_s = a.m_s;
  const size_t ln = size_t(lane) * n, ls = size_t(lane) * m_s, ld = size_t(lane) * a.m_d;
  float *zs = st, *ys = st + rv4, *los = st + 2 * rv4, *his = st + 3 * rv4, *rhos = st + 4 * rv4;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    x[j] = a.x0[ln + j];
    q[j] = a.q[ln + j];
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int row = rb + i;
    const bool s = row < m_s;
    const size_t kk = s ? ls + row : ld + (row - m_s);
    zs[i] = (s ? a.zs0 : a.zd0)[kk];
    ys[i] = (s ? a.ys0 : a.yd0)[kk];
    los[i] = (s ? a.lbs : a.lbd)[kk];
    his[i] = (s ? a.ubs : a.ubd)[kk];
    rhos[i] = s ? a.rho_s[row] : a.rho_d[kk];
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

// RHS = sigma x - q + the blocks' partial column sums pcol, read from each block in rank
// order (the streamed layout).
__device__ __forceinline__ void form_rhs(cg::cluster_group& cluster, int cs, int n, float sigma,
                                         const float* x, const float* q, double* pcol,
                                         double* rhs) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    double s = 0;
    for (int b = 0; b < cs; ++b) s += cluster.map_shared_rank(pcol, b)[j];
    rhs[j] = static_cast<double>(sigma * x[j] - q[j]) + s;
  }
}


// ---- the register layout --------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The exchanges between a cluster's blocks: a block pushes values into another
// block's shared memory with st.async, each store counting its bytes on that
// block's mbarrier; the receiver arms the mbarrier with the bytes a phase
// brings (its one arrival) and waits for the phase to complete, which makes the
// values visible. An mbarrier completes one phase an iteration: parity it & 1.
// The address of p (this block's shared memory) in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void push(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Waits for the phase of parity `parity`, the thread suspended for up to a millisecond a try
// (a spinning warp would take instruction slots and shared-memory cycles from the warps
// still working). The values pushed are in this block's shared memory: the wait's default
// acquire at CTA scope makes them visible. A push that never came would hang the card:
// after 2^14 tries the kernel traps instead.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (int tries = 0; !done; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity), "r"(1000000u) : "memory");
    if (tries > (1 << 14)) __trap();
  }
}

// The sums over the warp of GS rows' partial sums v (lane l's part of each):
// a transposing butterfly. At the step across lanes O apart a lane keeps half
// of its rows and adds the partner's part of them (GS / 2 shuffles), so after
// log2 GS steps lane l holds row l / (32 / GS) summed over 32 / GS lanes, and
// the remaining steps add the rest. Returns that row's whole sum.
template <int GS, int O = 16>
__device__ __forceinline__ float meet_rows(float* v, int l) {
  if constexpr (GS > 1) {
    const bool up = (l & O) != 0;
#pragma unroll
    for (int i = 0; i < GS / 2; ++i) {
      const float send = up ? v[i] : v[i + GS / 2];
      const float keep = up ? v[i + GS / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    return meet_rows<GS / 2, O / 2>(v, l);
  } else {
    float t = v[0];
#pragma unroll
    for (int o = O; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    return t;
  }
}

// Lane l's part of row j of the strip, [A_s; A_d]_j xt over its columns. The registers past
// the strip's rows and past n hold 0: no row or column is skipped.
template <int RW, int TC>
__device__ __forceinline__ float row_part(const float (&A)[RW][TC], const float (&xv)[TC], int j) {
  float s = 0.f;
  if (j < RW)
#pragma unroll
    for (int c = 0; c < TC; ++c) s = fmaf(A[imin(j, RW - 1)][c], xv[c], s);
  return s;
}

// The row sums [A_s; A_d] xt of the strip's rows J0, J0 + kGroup, ... (cnt rows
// of RW), a group of GS <= kGroup at a time, and their updates. The first two
// steps of the butterfly are taken as the partial sums are formed (four rows at
// a time), so that a lane holds GS / 4 partials, not GS. Lane l of a group holds row
// J0 + l / (32 / GS) whole; the first of its 32 / GS lanes updates the row's
// state st (z, y, lo, hi, rho at stride rv4, from the strip's first row sb) and
// its r in rs.
template <int RW, int TC, int J0 = 0>
__device__ __forceinline__ void strip_rows(const float (&A)[RW][TC], const float (&xv)[TC], int cnt,
                                           int l, int sb, float* st, int rv4, float* rs,
                                           float alpha, float beta) {
  if constexpr (J0 < RW) {
    constexpr int GS = pow2_at_least(imin(kGroup, RW - J0));
    static_assert(GS >= 4, "a group of at least four rows");
    if (J0 < cnt) {
      constexpr int Q = GS / 4;
      float v[Q];
      const bool up16 = (l & 16) != 0, up8 = (l & 8) != 0;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        // rows i, i + Q, i + 2Q, i + 3Q: the step across 16 lanes pairs the first and third,
        // the second and fourth; the step across 8 the two sums
        const float a0 = row_part(A, xv, J0 + i);
        const float a1 = row_part(A, xv, J0 + i + Q);
        const float a2 = row_part(A, xv, J0 + i + 2 * Q);
        const float a3 = row_part(A, xv, J0 + i + 3 * Q);
        const float u0 = (up16 ? a2 : a0) + __shfl_xor_sync(kFull, up16 ? a0 : a2, 16);
        const float u1 = (up16 ? a3 : a1) + __shfl_xor_sync(kFull, up16 ? a1 : a3, 16);
        v[i] = (up8 ? u1 : u0) + __shfl_xor_sync(kFull, up8 ? u0 : u1, 8);
      }
      const float zA = meet_rows<Q, 4>(v, l);
      const int d = 32 / GS, j = J0 + l / d;
      if (l % d == 0 && j < cnt) {
        const int i = sb + j;
        float z = st[i], y = st[rv4 + i];
        rs[j] = row_update(zA, st[4 * rv4 + i], st[2 * rv4 + i], st[3 * rv4 + i], alpha, beta, z,
                           y);
        st[i] = z;
        st[rv4 + i] = y;
      }
    }
    strip_rows<RW, TC, J0 + kGroup>(A, xv, cnt, l, sb, st, rv4, rs, alpha, beta);
  }
}

// The block's partial column sum j: its even and its odd warps' partials pw [NW, nv] each in
// order, then the two.
template <int NW>
__device__ __forceinline__ float meet_warps(const float* pw, int nv, int j) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int v = 0; v < NW; v += 2) {
    s0 += pw[v * nv + j];
    s1 += pw[(v + 1) * nv + j];
  }
  return s0 + s1;
}

// One lane a cluster of cs blocks (grid: B cs blocks, cluster: cs), or with ONE_SM one lane a
// block and no cluster (grid: B blocks), both exchanges in the block's shared memory; the
// block's rows of [A_s; A_d] in its warps' registers, its rows of C in shared memory (see 3 (a)
// and (c) above).
template <int NW, int RW, int TC, bool ONE_SM>
__global__ void __launch_bounds__(32 * NW, reg_min_blocks(NW, ONE_SM))
    reg_kernel(const AdmmArgs a) {
  constexpr int T = 32 * NW, P = ONE_SM ? kP1 : kP;       // P: threads a row of C
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  int cs = 1, k = 0, lane = blockIdx.x;
  if constexpr (!ONE_SM) {
    cs = static_cast<int>(cg::this_cluster().num_blocks());
    k = static_cast<int>(cg::this_cluster().block_rank());
    lane = blockIdx.x / cs;                         // grid = B cs: every cluster is a lane
  }
  const int n = a.n, m_s = a.m_s;
  const RegLayout L(n, m_s, a.m_d, cs, NW);
  const int nv = L.nv, ldc = L.ldc, rv4 = L.rv4;
  const int rb = part_start(L.m, cs, k), rows = part_start(L.m, cs, k + 1) - rb;   // its rows
  const int cb = part_start(n, cs, k), nc = part_start(n, cs, k + 1) - cb;         // its rows of C
  const int sb = part_start(rows, NW, w), cnt = part_start(rows, NW, w + 1) - sb;  // the strip

  extern __shared__ double smem[];
  char* base = reinterpret_cast<char*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bar);  // [0]: the partials, [1]: xt
  double* Cm = reinterpret_cast<double*>(base + L.c);        // [nc, ldc]
  double* rhs = reinterpret_cast<double*>(base + L.rhs);
  float* x = reinterpret_cast<float*>(base + L.x);
  float* q = reinterpret_cast<float*>(base + L.q);
  float* xtf = reinterpret_cast<float*>(base + L.xtf);       // xt, each block's rows pushed by it
  float* buf = reinterpret_cast<float*>(base + L.buf);       // [cs, nv]: block b's partial in row b
  float* pw = reinterpret_cast<float*>(base + L.pw);
  float* rs = reinterpret_cast<float*>(base + L.rv) + w * L.rwp;   // r of the strip's rows
  float* st = reinterpret_cast<float*>(base + L.st);
  const float *zs = st, *ys = st + rv4, *rhos = st + 4 * rv4;
  const float* Ad = a.Ad + size_t(lane) * a.m_d * n;         // [m_d, n]

  if constexpr (!ONE_SM) {
    if (tid == 0) {
      bar_init(&bars[0]);
      bar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  load_c_rows(Cm, ldc, a.C + size_t(lane) * n * n, cb, nc, n);
  load_state(a, lane, rb, rows, rv4, x, q, st);
  // the strip: A[j][c] = [A_s; A_d] at row rb + sb + j, column l + 32 c (0 past them)
  float A[RW][TC];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int row = rb + sb + imin(j, imax(cnt - 1, 0));
    const float* src = row < m_s ? a.A_s + size_t(row) * n : Ad + size_t(row - m_s) * n;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = l + 32 * c;
      A[j][c] = j < cnt && col < n ? src[col] : 0.f;
    }
  }
  for (int j = tid; j < NW * nv; j += T) pw[j] = 0.f;    // the columns past n stay 0
  __syncthreads();                                 // the row state is in place
  for (int j = l; j < L.rwp; j += 32)
    rs[j] = j < cnt ? rhos[sb + j] * zs[sb + j] - ys[sb + j] : 0.f;
  __syncwarp();
  // every block of the lane runs, with its mbarriers set up, before the first push
  if constexpr (!ONE_SM) cg::this_cluster().sync();
  // the bytes a phase brings: every block's partial (nv floats), and xt
  [[maybe_unused]] const unsigned bytes_partials = 4u * cs * nv, bytes_xt = 4u * n;

  const float alpha = a.alpha, beta = 1.0f - a.alpha;
  STAGE_START;
  for (int it = 0; it < a.iters; ++it) {
    [[maybe_unused]] const unsigned parity = it & 1;
    // (a) the strip's column sums of [A_s; A_d]'r: lane l over its columns, r broadcast
    {
      float s[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) s[c] = 0.f;
      const float4* r4 = reinterpret_cast<const float4*>(rs);
#pragma unroll
      for (int j4 = 0; j4 < RW / 4; ++j4) {
        if (4 * j4 < cnt) {                        // past cnt: A and r are 0
          const float4 r = r4[j4];
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            s[c] = fmaf(A[4 * j4][c], r.x, s[c]);
            s[c] = fmaf(A[4 * j4 + 1][c], r.y, s[c]);
            s[c] = fmaf(A[4 * j4 + 2][c], r.z, s[c]);
            s[c] = fmaf(A[4 * j4 + 3][c], r.w, s[c]);
          }
        }
      }
      if constexpr (RW % 4 == 2) {                 // the strip's last two rows
        if (RW - 2 < cnt) {
          const float2 r = reinterpret_cast<const float2*>(rs)[RW / 2 - 1];
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            s[c] = fmaf(A[RW - 2][c], r.x, s[c]);
            s[c] = fmaf(A[RW - 1][c], r.y, s[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = l + 32 * c;
        if (col < n) pw[w * nv + col] = s[c];
      }
    }
    STAGE(0);
    if constexpr (ONE_SM) {
      __syncthreads();
      STAGE(1);
      // (b, c) RHS = sigma x - q + the lane's column sums (thread j keeps x_j)
      for (int j = tid; j < n; j += T)
        rhs[j] = static_cast<double>((a.sigma * x[j] - q[j]) + meet_warps<NW>(pw, nv, j));
      STAGE(2);
      __syncthreads();
      STAGE(3);
    } else {
      if (tid == 0) bar_expect(&bars[0], bytes_partials);
      __syncthreads();
      // (b) the block's partial, pushed into row k of every block's buf
      for (int j = tid; j < nv; j += T) {
        const float s = meet_warps<NW>(pw, nv, j);
        for (int b = 0; b < cs; ++b)
          push(cluster_addr(buf + k * nv + j, b), s, cluster_addr(&bars[0], b));
      }
      STAGE(1);
      bar_wait(&bars[0], parity);                  // every block's partial is here
      STAGE(2);
      // (c) RHS = sigma x - q + the blocks' partials in rank order (thread j keeps x_j)
      for (int j = tid; j < n; j += T) {
        float s = 0.f;
        for (int b = 0; b < cs; ++b) s += buf[b * nv + j];
        rhs[j] = static_cast<double>((a.sigma * x[j] - q[j]) + s);
      }
      if (tid == 0) bar_expect(&bars[1], bytes_xt);
      __syncthreads();
      STAGE(3);
    }
    // (d) the block's rows of xt = C RHS, P threads a row (a warp past the rows skips); on one
    // SM the row's first thread writes it, else thread p of a row pushes it into the xt of
    // blocks p, p + P, ...
    for (int r0 = 0; r0 < nc; r0 += T / P) {
      if (r0 + (tid & ~31) / P >= nc) continue;
      const int row = r0 + tid / P, p = tid % P;
      const double* crow = Cm + size_t(imin(row, nc - 1)) * ldc;
      double s0 = 0.0, s1 = 0.0;
      int c = p;
      for (; c + P < n; c += 2 * P) {
        s0 = fma(crow[c], rhs[c], s0);
        s1 = fma(crow[c + P], rhs[c + P], s1);
      }
      if (c < n) s0 = fma(crow[c], rhs[c], s0);
      double s = s0 + s1;
#pragma unroll
      for (int o = 1; o < P; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
      if (row < nc) {
        if constexpr (ONE_SM) {
          if (p == 0) xtf[row] = static_cast<float>(s);
        } else {
          for (int b = p; b < cs; b += P)
            push(cluster_addr(xtf + cb + row, b), static_cast<float>(s), cluster_addr(&bars[1], b));
        }
      }
    }
    STAGE(4);
    if constexpr (ONE_SM)
      __syncthreads();                             // xt is whole
    else
      bar_wait(&bars[1], parity);                  // every block's rows of xt are here
    STAGE(5);
    // (e) relax x; the strip's row sums [A_s; A_d] xt from the registers, and their updates
    for (int j = tid; j < n; j += T) x[j] = alpha * xtf[j] + beta * x[j];
    float xv[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = l + 32 * c;
      xv[c] = col < n ? xtf[col] : 0.f;
    }
    strip_rows<RW, TC>(A, xv, cnt, l, sb, st, rv4, rs, alpha, beta);
    __syncwarp();                                  // rs is read by the whole warp next
    STAGE(6);
  }
  STAGE_END;

  __syncthreads();                                 // x and the row state, written by other warps
  store_state(a, lane, rb, rows, rv4, cb, nc, x, st);
  // every push to this block came before its last wait, and every push it made was to a block
  // still waiting for it: it may leave without a barrier
}

// ---- the streamed layout --------------------------------------------------------------------

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
  load_state(a, lane, rb, rows, rv4, x, q, st);
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


// Launches kernel on a grid of `grid` blocks in clusters of cs (cs = 1: no cluster).
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
  cfg.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The register layout's instances, tried in this order for the warps a layout names: the first
// whose strips and column slots hold a shape runs it. RW x TC stays within the registers that
// ptxas gives a thread without spilling (-Xptxas -v: 128 at 16 warps an SM, 255 at 8).
using RegShapes = ShapeList<RegShape<8, 28, 3, true>, RegShape<16, 20, 3>, RegShape<16, 28, 3>,
                            RegShape<16, 20, 4>, RegShape<16, 16, 5>, RegShape<16, 14, 6>,
                            RegShape<16, 12, 7>, RegShape<16, 10, 8>, RegShape<16, 8, 10>,
                            RegShape<8, 32, 6>>;

struct ClusterChoice {
  int cs;                                      // blocks a lane (1: no cluster)
  bool registers;                              // else streamed
  int nw;                                      // warps a block of the register layout
};

// The layouts, tried in this order: the first that holds a shape runs it.
constexpr ClusterChoice kLayouts[] = {{1, true, 8}, {2, true, 16}, {2, true, 8}, {4, true, 16},
                                      {8, true, 16}, {8, true, 8}, {8, false, 0}};

template <class S>
bool reg_holds(int n, int m, const ClusterChoice& c) {
  return S::NW == c.nw && S::ONE_SM == (c.cs == 1) && cdiv(n, 32) <= S::TC &&
         cdiv(cdiv(m, c.cs), c.nw) <= S::RW;
}

// Whether an instance of the list holds the shape in layout c; with a launch, launches the
// first that does (rc: its cudaError_t; bytes: a block's shared memory).
template <class S, class... Rest>
bool reg_instance(ShapeList<S, Rest...>, const AdmmArgs* a, int n, int m, const ClusterChoice& c,
                  size_t bytes, cudaStream_t stream, int* rc) {
  if (reg_holds<S>(n, m, c)) {
    if (a != nullptr)
      *rc = launch_grid(reg_kernel<S::NW, S::RW, S::TC, S::ONE_SM>,
                        static_cast<unsigned>(a->B) * c.cs, c.cs, 32 * S::NW, bytes, stream, *a);
    return true;
  }
  if constexpr (sizeof...(Rest) > 0)
    return reg_instance(ShapeList<Rest...>{}, a, n, m, c, bytes, stream, rc);
  else
    return false;
}

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

// Whether layout c holds the shape: the streamed layout where its block fits; the register
// layout where an instance holds the rows and the block's shared memory fits, on one SM (cs = 1)
// for as many blocks as the instance's launch bounds keep there.
bool holds(const ClusterChoice& c, int n, int m_s, int m_d) {
  if (!c.registers) return stream_warps(n, m_s, m_d, c.cs) > 0;
  const size_t bytes = RegLayout(n, m_s, m_d, c.cs, c.nw).bytes;
  const int blocks = reg_min_blocks(c.nw, c.cs == 1);
  return bytes <= kMaxSharedBytes && blocks * (bytes + 1024) <= kSharedBytesPerSM &&
         reg_instance(RegShapes{}, nullptr, n, m_s + m_d, c, 0, nullptr, nullptr);
}

// The first layout of kLayouts that holds the shape, or nullptr.
const ClusterChoice* layout_for(int n, int m_s, int m_d) {
  for (const ClusterChoice& c : kLayouts)
    if (holds(c, n, m_s, m_d)) return &c;
  return nullptr;
}

}  // namespace

bool structured_admm_cluster_has(int n, int m_s, int m_d) {
  return layout_for(n, m_s, m_d) != nullptr;
}

int structured_admm_cluster_launch(const AdmmArgs& a, cudaStream_t stream) {
  const ClusterChoice* c = layout_for(a.n, a.m_s, a.m_d);
  if (c == nullptr || a.C == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (c->registers) {
    const RegLayout L(a.n, a.m_s, a.m_d, c->cs, c->nw);
    int rc = static_cast<int>(cudaErrorInvalidValue);
    reg_instance(RegShapes{}, &a, a.n, a.m_s + a.m_d, *c, L.bytes, stream, &rc);
    return rc;
  }
  const int nw = stream_warps(a.n, a.m_s, a.m_d, c->cs);
  const StreamLayout L(a.n, a.m_s, a.m_d, c->cs, nw);
  return launch_grid(stream_kernel, static_cast<unsigned>(a.B) * c->cs, c->cs, 32 * nw, L.bytes,
                     stream, a, nw);
}

// The layout structured_admm_cluster_launch runs a shape in: 1 for the rows in registers, 0
// for the rows streamed, -1 where no layout holds it; *cs blocks a lane (1: the lane on one SM,
// no cluster), *nw warps a lane's block.
extern "C" int structured_admm_cluster_layout(int n, int m_s, int m_d, int* cs, int* nw) {
  const ClusterChoice* c = layout_for(n, m_s, m_d);
  if (c == nullptr) return -1;
  *cs = c->cs;
  *nw = c->registers ? c->nw : stream_warps(n, m_s, m_d, c->cs);
  return c->registers ? 1 : 0;
}

#ifdef ADMM_STAGE_CLOCKS
// The stage clocks into host[0 .. kStageSlots), then zeroes them
// (scripts/admm_kernel_sweep.py).
extern "C" int structured_admm_stage_clocks(unsigned long long* host) {
  return read_stage_clocks(host);
}
#endif
