// Shared declarations of the structured-ADMM kernels (structured_admm.cu:
// the entry point; structured_admm_tiled.cu: the kernel specialised per
// shape, several lanes a block, the Woodbury form; structured_admm_folded.cu:
// one lane a block, the stacked matrix in registers, the lane's float64 C;
// structured_admm_generic.cu: the C form for shapes known only at run time,
// one lane a block; structured_admm_cluster.cu: the C form for the larger
// lanes, one lane a thread-block cluster, or one lane a block with two lanes
// an SM where its rows fit).
#pragma once

#include <cuda_runtime.h>

// One rho phase for B lanes. Every array is C-contiguous and batch-first,
// float32 but for C: q, x0 [B, n]; lbs, ubs, zs0, ys0 [B, m_s]; Ad
// [B, m_d, n]; lbd, ubd, rho_d, zd0, yd0 [B, m_d]; shared Ms_inv [n, n],
// A_s [m_s, n], rho_s [m_s]; and the operand of the x-update, one of two,
// the other null: WK [B, n, m_d] (the tiled kernel's Woodbury form, with
// Ms_inv) or C [B, n, n] in float64 (the lane's (M_s + A_d' R A_d)^-1: the
// folded, generic and cluster kernels). The outputs have the shapes of x0,
// zs0, zd0, ys0, yd0.
struct AdmmArgs {
  const float *Ms_inv, *A_s, *rho_s, *q, *lbs, *ubs, *Ad, *lbd, *ubd, *rho_d, *WK;
  const double* C;
  const float *x0, *zs0, *zd0, *ys0, *yd0;
  float *x_out, *zs_out, *zd_out, *ys_out, *yd_out;
  int B, n, m_s, m_d, iters;
  float sigma, alpha;
};

// Kernel variants; structured_admm_variant() picks one from the shape alone
// (kNone: no kernel holds the shape).
enum AdmmVariant { kNone = -1, kTiled = 0, kFolded = 1, kGeneric = 2, kCluster = 3 };

// NaN-propagating clip with the semantics of torch.clamp / jnp.clip
// (max with lo first, then min with hi). fminf/fmaxf would drop a NaN and
// hide a diverging lane from the isfinite check of the caller.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Over-relaxed update of one constraint row: returns rho z - y of the new
// state. zA is the row of [A_s; A_d] x tilde.
__device__ __forceinline__ float row_update(float zA, float rho, float lo, float hi,
                                            float alpha, float beta, float& z, float& y) {
  const float zr = alpha * zA + beta * z;
  const float zn = clip(zr + y / rho, lo, hi);
  const float yn = y + rho * (zr - zn);
  z = zn;
  y = yn;
  return rho * zn - yn;
}

// Stage clocks of an iteration, for scripts/admm_kernel_sweep.py --stage-clocks only: it
// compiles a copy with ADMM_STAGE_CLOCKS defined, and the package's build leaves the markers
// empty. Each thread adds the clocks since the last marker to its count of stage s, in
// registers; after the loop thread 0 of block 0 adds its counts to its source's own
// admm_stage_clocks, which read_stage_clocks copies out (a source with markers exports it).
constexpr int kStageSlots = 10;
#ifdef ADMM_STAGE_CLOCKS
static __device__ unsigned long long admm_stage_clocks[kStageSlots];
#define STAGE_START                        \
  long long stage_sum[kStageSlots] = {};   \
  long long stage_t = clock64()
#define STAGE(s)                                  \
  {                                               \
    const long long stage_now = clock64();        \
    stage_sum[s] += stage_now - stage_t;          \
    stage_t = stage_now;                          \
  }
#define STAGE_END                                                              \
  if (blockIdx.x == 0 && threadIdx.x == 0)                                     \
    for (int s = 0; s < kStageSlots; ++s)                                      \
      admm_stage_clocks[s] += static_cast<unsigned long long>(stage_sum[s])
// The source's stage clocks into host[0 .. kStageSlots), then zeroes them.
static inline int read_stage_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, admm_stage_clocks, sizeof(admm_stage_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kStageSlots] = {};
  return static_cast<int>(cudaMemcpyToSymbol(admm_stage_clocks, zero, sizeof(zero)));
}
#else
#define STAGE_START
#define STAGE(s)
#define STAGE_END
#endif

// structured_admm_tiled.cu: whether a shape takes it (the shapes that take
// WK), and the launch of any of its instantiations (returns a cudaError_t;
// cudaErrorInvalidValue without one).
bool structured_admm_tiled_has(int n, int m_s, int m_d);
int structured_admm_tiled_launch(const AdmmArgs& a, cudaStream_t stream);
// structured_admm_folded.cu: whether a shape has an instantiation, and its
// launch.
bool structured_admm_folded_has(int n, int m_s, int m_d);
int structured_admm_folded_launch(const AdmmArgs& a, cudaStream_t stream);
// structured_admm_generic.cu: whether one of its layouts holds the shape
// (the lane's C, vectors and rows within a block's registers and shared
// memory), and its launch.
bool structured_admm_generic_has(int n, int m_s, int m_d);
int structured_admm_generic_launch(const AdmmArgs& a, cudaStream_t stream);
// structured_admm_cluster.cu: whether one of its layouts holds the shape (the
// lane's vectors and row state within the shared memory of a cluster's
// blocks: every fov and connectivity team to about 1 000 agents or robots),
// and its launch.
bool structured_admm_cluster_has(int n, int m_s, int m_d);
int structured_admm_cluster_launch(const AdmmArgs& a, cudaStream_t stream);
