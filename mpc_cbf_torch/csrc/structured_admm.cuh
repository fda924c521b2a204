// Shared declarations of the structured-ADMM kernels (structured_admm.cu:
// the entry point; structured_admm_tiled.cu: the kernel specialised per
// shape, several lanes a block; structured_admm_folded.cu: one lane a block,
// the stacked matrix in registers, the Woodbury correction folded into one
// matrix; structured_admm_generic.cu: the same folded form for shapes known
// only at run time, one lane a block; structured_admm_cluster.cu: the folded
// form with one lane a thread-block cluster, for lanes larger than an SM).
#pragma once

#include <cuda_runtime.h>

// One rho phase for B lanes. Every array is float32, C-contiguous and
// batch-first: q, x0 [B, n]; lbs, ubs, zs0, ys0 [B, m_s]; Ad [B, m_d, n];
// lbd, ubd, rho_d, zd0, yd0 [B, m_d]; WK [B, n, m_d]; shared Ms_inv [n, n],
// A_s [m_s, n], rho_s [m_s]. The outputs have the shapes of x0, zs0, zd0,
// ys0, yd0.
struct AdmmArgs {
  const float *Ms_inv, *A_s, *rho_s, *q, *lbs, *ubs, *Ad, *lbd, *ubd, *rho_d, *WK;
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

// D (8 x 8) += A (8 x 4, row-major fragments) B (4 x 8, column-major
// fragments) in float64. Thread t of the warp gives A[t / 4][t % 4] and
// B[t % 4][t / 4] and holds D[t / 4][2 (t % 4)] and D[t / 4][2 (t % 4) + 1].
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1) : "d"(a), "d"(b));
}

// The (8 mt) x (8 nt) product sum_k X[i, k] Y[k, j], k < 4 ksteps, on the
// float64 tensor cores: xf(i, k) and yf(k, j) give the operands (zero beyond
// the matrices), put(i, j, v) takes each element of the result once. A warp
// takes two 8 x 8 tiles side by side at a time.
template <class XF, class YF, class Put>
__device__ __forceinline__ void mma_product(int mt, int nt, int ksteps, int nw, XF xf, YF yf,
                                            Put put) {
  const int w = threadIdx.x / 32, t = threadIdx.x % 32, r = t / 4, kc = t % 4;
  const int pairs = (nt + 1) / 2;
  for (int u = w; u < mt * pairs; u += nw) {
    const int i0 = (u / pairs) * 8, j0 = (u % pairs) * 16;
    const bool two = j0 + 8 < 8 * nt;
    double d[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    for (int ks0 = 0; ks0 < ksteps; ks0 += 4) {
      double av[4], b0[4], b1[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {          // four k-steps' loads first: from L2 they overlap
        const int k = 4 * (ks0 + s) + kc;
        const bool in = ks0 + s < ksteps;
        av[s] = in ? xf(i0 + r, k) : 0.0;
        b0[s] = in ? yf(k, j0 + r) : 0.0;
        b1[s] = in && two ? yf(k, j0 + 8 + r) : 0.0;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (ks0 + s < ksteps) {
          mma_f64(d[0][0], d[0][1], av[s], b0[s]);
          if (two) mma_f64(d[1][0], d[1][1], av[s], b1[s]);
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j == 0 || two) put(i0 + r, j0 + 8 * j + 2 * kc + e, d[j][e]);
  }
}

// structured_admm_tiled.cu: whether a shape has an instantiation, and its
// launch (returns a cudaError_t; cudaErrorInvalidValue without one).
bool structured_admm_tiled_has(int n, int m_s, int m_d);
int structured_admm_tiled_launch(const AdmmArgs& a, cudaStream_t stream);
// structured_admm_folded.cu: the same pair for its instantiations.
bool structured_admm_folded_has(int n, int m_s, int m_d);
int structured_admm_folded_launch(const AdmmArgs& a, cudaStream_t stream);
// structured_admm_generic.cu: whether one of its layouts holds the shape
// (n <= 160 and C with the lane's vectors within a block's shared memory:
// every fov team to 84 agents, every connectivity team to 89 robots), and its
// launch.
bool structured_admm_generic_has(int n, int m_s, int m_d);
int structured_admm_generic_launch(const AdmmArgs& a, cudaStream_t stream);
// structured_admm_cluster.cu: whether one of its layouts holds the shape (the
// lane's rows of C and row state within 2, 4 or 8 blocks' shared memory: every
// fov team to 381 agents, every connectivity team to 381 robots), and its
// launch.
bool structured_admm_cluster_has(int n, int m_s, int m_d);
int structured_admm_cluster_launch(const AdmmArgs& a, cudaStream_t stream);
