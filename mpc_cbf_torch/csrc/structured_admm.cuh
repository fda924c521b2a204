// Shared declarations of the structured-ADMM kernels (structured_admm.cu:
// the entry point and the two first-version kernels, kept for comparison and
// for the shapes no other kernel holds;
// structured_admm_tiled.cu: the kernel specialised per shape, several lanes a
// block; structured_admm_folded.cu: one lane a block, the stacked matrix in
// registers, the Woodbury correction folded into one matrix;
// structured_admm_generic.cu: the same folded form for shapes known only at
// run time, the kernel of the other shapes).
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
// (kResident or kStreamed only for a shape no layout of kGeneric holds).
enum AdmmVariant { kNone = -1, kTiled = 0, kResident = 1, kStreamed = 2, kFolded = 3, kGeneric = 4 };

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
